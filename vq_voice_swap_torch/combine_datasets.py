"""Merge several LibriSpeech-like dataset directories into one directory of
symlinks with a combined index (counterpart of the JAX package's
``combine_datasets.py``); the merged directory feeds ``train_vqvae_add``.

The speaker directories of source ``i`` appear as ``<i:02>_<speaker>``, so
the label spaces of different sources never collide.

Example:
    python -m vq_voice_swap_torch.combine_datasets data/a data/b data/merged
"""

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

from .data import LibriSpeech


def merge_datasets(sources: Sequence[str], output: str) -> Dict[str, Dict[str, float]]:
    """Symlink every speaker directory of every source into ``output``;
    returns the combined duration index (speaker -> file -> seconds)."""
    combined = {}
    for ordinal, source in enumerate(sources):
        print(f"indexing dataset {source}...")
        # use_cache=False: the merge reads only the duration index, not the
        # decoded windows.
        for speaker, files in LibriSpeech(source, use_cache=False).index.items():
            alias = f"{ordinal:02}_{speaker}"
            combined[alias] = files
            os.symlink(os.path.abspath(os.path.join(source, speaker)),
                       os.path.join(output, alias))
    return combined


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("directories", type=str, nargs="+")
    parser.add_argument("output", type=str)
    args = parser.parse_args(argv)

    if os.path.exists(args.output):
        print(f"error: output directory already exists: {args.output}")
        sys.exit(1)
    os.mkdir(args.output)
    index = merge_datasets(args.directories, args.output)
    with open(os.path.join(args.output, "index.json"), "w") as f:
        json.dump(index, f)


if __name__ == "__main__":
    main()
