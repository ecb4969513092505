"""Render a smoothed loss curve from a training log (counterpart of the JAX
package's ``plot_log.py``): the moving average of the ``loss`` field of
the ``step N: k=v ...`` lines the train CLIs write (``observe.read_log``).

Example:
    python -m vq_voice_swap_torch.plot_log --smoothing 200 run/train_log.txt loss.png
"""

import argparse
from typing import Optional, Sequence

from .observe import moving_average, read_log


def render(log_file: str, out_file: str, smoothing: int, max_y: float) -> None:
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    steps, losses = [], []
    for step, fields in read_log(log_file):
        steps.append(step)
        losses.append(fields["loss"])
    fig, ax = plt.subplots()
    ax.plot(steps, moving_average(losses, smoothing))
    ax.set_ylim(0, max_y)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    fig.savefig(out_file)
    plt.close(fig)


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--smoothing", type=int, default=100)
    parser.add_argument("--max-y", type=float, default=1.0)
    parser.add_argument("log_file", type=str)
    parser.add_argument("out_file", type=str)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    render(args.log_file, args.out_file, args.smoothing, args.max_y)


if __name__ == "__main__":
    main()
