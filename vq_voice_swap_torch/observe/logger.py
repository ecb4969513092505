"""Plain-text training log with save sentinels and resume truncation, and
its reader ``read_log`` (counterpart of
``vq_voice_swap_tpu/observe/logger.py``; either package's reader reads
what either writes).

Lines are ``step N: k=v k=v ...`` with five decimals; a ``# saved`` line
follows each checkpoint. On resume the log is truncated just past the
newest save record and ``start_step`` is the last step logged before it.
An asynchronous save (``--async-save``) writes ``# saving @ N`` when it
takes its snapshot of step N, and its worker thread writes the confirming
``# saved`` when the files are down, possibly after later step lines; the
resume scan pairs them as the JAX package's does. Writes hold a lock, since
the worker writes too.
"""

import os
import re
import threading
from typing import Any, Dict, Iterator, TextIO, Tuple, Union

__all__ = ["Logger", "read_log", "SAVED_MSG"]

SAVED_MSG = "# saved\n"

_STEP_LINE = re.compile(r"^step (\d+): (.*)$")


def _parse_step_line(line: str) -> Tuple[int, Dict[str, float]]:
    """``step N: k=v k=v`` as (N, {k: v}); a ValueError otherwise."""
    m = _STEP_LINE.match(line)
    if m is None:
        raise ValueError(f"not a step line: {line!r}")
    fields: Dict[str, float] = {}
    for token in m.group(2).split(" "):
        key, sep, value = token.partition("=")
        if not sep:
            raise ValueError(f"bad field {token!r}")
        fields[key] = float(value)
    return int(m.group(1)), fields


def read_log(source: Union[str, TextIO]) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """The (step, {key: float}) entries of a log file or open text stream:
    comment lines (``# ...``) are skipped, iteration stops at the first
    blank line, and a malformed line raises a ValueError naming its 1-based
    line number."""
    if isinstance(source, str):
        with open(source, "rt") as f:
            yield from read_log(f)
            return
    for line_no, raw in enumerate(source, start=1):
        stripped = raw.rstrip()
        if not stripped:
            return
        if stripped[0] == "#":
            continue
        try:
            yield _parse_step_line(stripped)
        except ValueError:
            raise ValueError(f"unexpected log format at line {line_no}") from None


def _scan_resume_point(path: str) -> Tuple[int, int, bool]:
    """One byte-exact pass over a log: (resume_step, keep_bytes,
    from_marker). A ``# saved`` line confirms the oldest unconfirmed
    ``# saving @ N`` marker if there is one (resume at N, keeping the bytes
    before the marker: ``from_marker``), else the save of the last step
    logged before it (keeping the bytes through it). Without a sentinel
    the whole file is kept and the last step wins."""
    sentinel = SAVED_MSG.encode()
    step_re = re.compile(rb"^step (\d+):")
    saving_re = re.compile(rb"^# saving @ (\d+)$")
    last_step = 0
    offset = 0
    keep = None
    pending = []
    with open(path, "rb") as f:
        for raw in f:
            start = offset
            offset += len(raw)
            if raw == sentinel:
                keep = (pending.pop(0) + (True,) if pending
                        else (last_step, offset, False))
                continue
            m = saving_re.match(raw.rstrip(b"\n"))
            if m is not None:
                pending.append((int(m.group(1)), start))
                continue
            m = step_re.match(raw)
            if m is not None:
                last_step = int(m.group(1))
    return keep if keep is not None else (last_step, offset, False)


class Logger:
    """Write metrics to a file and stdout; resumable with truncation."""

    def __init__(self, out_filename: str, resume: bool = False, write: bool = True):
        """``write=False`` (a rank other than 0 of a distributed run) reads
        the resume step if it can, prints nothing and never touches the
        file; the loop takes rank 0's ``start_step``."""
        self.start_step = 0
        self._lock = threading.Lock()
        self.out_file = None
        if not write:
            if resume and os.path.exists(out_filename):
                self.start_step = _scan_resume_point(out_filename)[0]
            return
        if not resume:
            self.out_file = open(out_filename, "w+")
            return
        try:
            step, keep_bytes, from_marker = _scan_resume_point(out_filename)
        except FileNotFoundError:
            # Without the log the step count is unknown: restarting at 0
            # would replay step 0's draws on step N's weights.
            raise RuntimeError(
                f"resuming from a checkpoint but its log is missing ({out_filename}); "
                "warm-start an external checkpoint with --pretrained-path into a "
                "fresh --output-dir instead"
            )
        self.start_step = step
        self.out_file = open(out_filename, "r+")
        self.out_file.seek(keep_bytes)
        self.out_file.truncate()
        if from_marker:
            # Re-seal the kept region, so that a second resume lands here too.
            self.out_file.write(SAVED_MSG)
            self.out_file.flush()

    def log(self, step: int, **kwargs) -> None:
        fields = " ".join(f"{k}={v:.05f}" for k, v in kwargs.items())
        line = f"step {step + self.start_step}: {fields}"
        if self.out_file is not None:
            self._write(line + "\n")
            print(line)

    def mark_saving(self, step: int) -> None:
        """The marker of an asynchronous save of the state after ``step``
        (counted as ``log`` counts); ``mark_save`` confirms it."""
        self._write(f"# saving @ {step + self.start_step}\n")

    def mark_save(self) -> None:
        self._write(SAVED_MSG)

    def _write(self, text: str) -> None:
        if self.out_file is None:
            return
        with self._lock:
            self.out_file.write(text)
            self.out_file.flush()

    def close(self) -> None:
        with self._lock:
            if self.out_file is not None:
                self.out_file.close()
