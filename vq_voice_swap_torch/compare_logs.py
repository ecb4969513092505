"""Plot one or more log fields (regular expressions; the fields a pattern
matches are averaged) of one or more runs on one figure (counterpart of
the JAX package's ``compare_logs.py``).

Example:
    python -m vq_voice_swap_torch.compare_logs --fields base_q0 cond_q0 -- \\
        run1/train_log.txt run2/train_log.txt out.png
"""

import argparse
import os
import re
from typing import Dict, Optional, Sequence

from .observe import moving_average, read_log


def field_value(entry: Dict[str, float], field_expr: str) -> Optional[float]:
    """The mean of the entry's fields whose names match ``field_expr``
    (from their start), or None."""
    values = [v for k, v in entry.items() if re.match(field_expr, k)]
    if not values:
        return None
    return sum(values) / len(values)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = arg_parser().parse_args(argv)
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for filename in args.log_files:
        name, _ = os.path.splitext(os.path.basename(filename))
        for field in args.fields:
            entries = [(step, field_value(kvs, field)) for step, kvs in read_log(filename)]
            entries = [(x, y) for x, y in entries if y is not None]
            if not entries:
                print(f"warning: field {field!r} matched nothing in {filename}; "
                      "skipping that series")
                continue
            xs, ys = zip(*entries)
            ax.plot(xs, moving_average(ys, args.smoothing), label=f"{name} {field}")
    ax.set_ylim(args.min_y, args.max_y)
    if args.max_x is not None:
        ax.set_xlim(0, args.max_x)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.savefig(args.out_file)
    plt.close(fig)


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--smoothing", type=int, default=1)
    parser.add_argument("--max-x", type=float, default=None)
    parser.add_argument("--min-y", type=float, default=0.0)
    parser.add_argument("--max-y", type=float, default=1.0)
    parser.add_argument("--fields", type=str, nargs="+", default=["base_q."])
    parser.add_argument("log_files", nargs="+", type=str)
    parser.add_argument("out_file", type=str)
    return parser


if __name__ == "__main__":
    main()
