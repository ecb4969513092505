"""Convert a released reference PyTorch vq-voice-swap checkpoint (a
``{"kwargs", "state_dict"}`` ``.pt``) into the ``.npz`` format that this
port and the JAX package both read.

    python -m vq_voice_swap_torch.convert_checkpoint model.pt model.npz

The file is read with ``torch.load(..., weights_only=True)``. Sampling and
training CLIs also take a ``.pt`` where they take an ``.npz``.
"""

import argparse
from typing import Optional, Sequence

from .convert.torch_import import convert_torch_checkpoint


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("torch_path", type=str)
    parser.add_argument("out_path", type=str)
    args = parser.parse_args(argv)
    class_name, kwargs = convert_torch_checkpoint(args.torch_path, args.out_path)
    print(f"converted {class_name} checkpoint -> {args.out_path}")
    print(f"kwargs: {kwargs}")


if __name__ == "__main__":
    main()
