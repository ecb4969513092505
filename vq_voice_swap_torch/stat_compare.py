"""The Frechet distance between two feature-statistics files of
``stat_generate`` (counterpart of the JAX package's ``stat_compare.py``):
d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with an
eps-regularised ``sqrtm`` when the product is singular and a check that the
square root is real. numpy and scipy only; no device.

Example:
    python -m vq_voice_swap_torch.stat_compare stats_data.npz stats_samples.npz
"""

import argparse
from typing import Optional, Sequence

import numpy as np
from scipy import linalg


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    if mu1.shape != mu2.shape:
        raise ValueError(f"mean vectors differ in length: {mu1.shape} vs {mu2.shape}")
    if sigma1.shape != sigma2.shape:
        raise ValueError(f"covariances differ in shape: {sigma1.shape} vs {sigma2.shape}")

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print(f"sqrtm produced a singular product; regularising with eps={eps}")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    with np.load(args.stat_1) as stat1, np.load(args.stat_2) as stat2:
        print(frechet_distance(stat1["mean"], stat1["cov"], stat2["mean"], stat2["cov"]))


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("stat_1", type=str)
    parser.add_argument("stat_2", type=str)
    return parser


if __name__ == "__main__":
    main()
