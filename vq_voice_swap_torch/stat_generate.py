"""Classifier-feature statistics and the Class score (akin to the
Inception Score) of a dataset directory or of a directory of generated
.wav samples (counterpart of the JAX package's ``stat_generate.py``).

Each 4 s segment (padded or cropped to 64000 samples) goes through the
noised-audio classifier at t = 0: the stem's features and the softmax of
the head. The features' mean and covariance, the probabilities and the
Class score, exp(mean KL(p(y|x) || p(y))), are saved to an .npz that
``stat_compare`` reads. --data-dir reads through the data loader (a
LibriSpeech-style directory, or tones/chirps); --sample-dir reads its .wav
files, a few at a time in a thread pool ahead of the device. Runs on CUDA
unless --device names another device.

Example:
    python -m vq_voice_swap_torch.stat_generate --checkpoint-path classifier.npz \\
        --data-dir /data/LibriSpeech/test-clean --num-samples 10000 --batch-size 16 \\
        stats_data.npz
"""

import argparse
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .classifier_model import ClassifierModel
from .data import ChunkReader, create_data_loader, lookup_audio_duration
from .util import resolve_device

SEGMENT = 64000
SAMPLE_RATE = 16000


def featurize(classifier: ClassifierModel, batch: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(features, probabilities) of a [N, T] batch at t = 0."""
    ts = torch.zeros((batch.shape[0],), device=batch.device)
    feats = classifier.features(batch[..., None], ts)
    return feats, torch.softmax(classifier.head_from_features(feats), dim=-1)


def class_score(probs: np.ndarray) -> float:
    """exp(mean over rows of KL(p(y|x) || p(y))), p(y) the rows' mean."""
    kl = probs * (np.log(probs + 1e-12) -
                  np.log(np.mean(probs, axis=0, keepdims=True) + 1e-12))
    return float(np.exp(np.mean(np.sum(kl, axis=1))))


@torch.inference_mode()
def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    segments = load_segments(args)
    classifier = ClassifierModel.load(args.checkpoint_path, device=device)

    features: List[np.ndarray] = []
    probs: List[np.ndarray] = []
    count = 0
    for batch in batch_segments(args.batch_size, segments):
        fv, pr = featurize(classifier, torch.from_numpy(batch).to(device))
        features.append(fv.cpu().numpy())
        probs.append(pr.cpu().numpy())
        count += len(batch)
        if count % (args.batch_size * 25) == 0:
            print(f"processed {count} segments")

    features, probs = np.concatenate(features), np.concatenate(probs)
    score = class_score(probs)
    print(f"classifier score: {score}")
    np.savez(args.output_path, mean=np.mean(features, axis=0),
             cov=np.cov(features, rowvar=False), probs=probs, class_score=score)


def batch_segments(batch_size: int, segs: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
    """[N, SEGMENT] float32 batches of the segments, each padded or cropped;
    the last batch may be short."""
    batch = []
    for seg in segs:
        seg = np.asarray(seg, dtype=np.float32).reshape(-1)
        if len(seg) < SEGMENT:
            seg = np.pad(seg, (0, SEGMENT - len(seg)))
        batch.append(seg[:SEGMENT])
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def load_segments(args) -> Iterator[np.ndarray]:
    if (args.data_dir is None) == (args.sample_dir is None):
        raise SystemExit("must specify --data-dir or --sample-dir (not both)")
    if args.data_dir is not None:
        loader, _ = create_data_loader(args.data_dir, batch_size=1, encoding=args.encoding)
        return segments_from_loader(args.num_samples, loader)
    files = sorted(
        os.path.join(args.sample_dir, x) for x in os.listdir(args.sample_dir)
        if not x.startswith(".") and x.endswith(".wav")
    )
    if args.num_samples:
        files = files[:args.num_samples]
    return segments_from_files(files, args.encoding)


def segments_from_loader(limit: Optional[int], loader) -> Iterator[np.ndarray]:
    count = 0
    for batch in loader:
        for row in batch["samples"]:
            yield row
            count += 1
            if limit and count >= limit:
                return


def segments_from_files(files: List[str], encoding: str = "linear") -> Iterator[np.ndarray]:
    """The files' audio in order, read in a pool of 4 threads with at most
    16 files in flight, so a large directory is never all in memory."""

    def read(path):
        duration = lookup_audio_duration(path)
        with ChunkReader(path, sample_rate=SAMPLE_RATE, encoding=encoding) as reader:
            return reader.read(SAMPLE_RATE * int(duration + 2))

    window = 16
    with ThreadPoolExecutor(4) as pool:
        pending = deque()
        for path in files:
            pending.append(pool.submit(read, path))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--checkpoint-path", default="model_classifier.npz", type=str)
    parser.add_argument("--batch-size", default=4, type=int)
    parser.add_argument("--encoding", default="linear", type=str,
                        help="waveform encoding the classifier was trained with (e.g. "
                             "ulaw); applies to --data-dir and --sample-dir input alike")
    parser.add_argument("--num-samples", default=None, type=int)
    parser.add_argument("--sample-dir", default=None, type=str)
    parser.add_argument("--data-dir", default=None, type=str)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on; never falls back")
    parser.add_argument("output_path", type=str)
    return parser


if __name__ == "__main__":
    main()
