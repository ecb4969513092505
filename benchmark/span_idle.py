"""The program's spans (``vq_voice_swap_torch/observe/spans.py``) against the
device's idle time in a traced stretch (``harness.Trace``).

The spans are host events of the stretch (``Trace.host_ops``), on the
device records' clock. The device is idle over ``[0, window_s]`` less the
union of its records; a span name covers the union of its intervals. The
span readers under ``metrics/`` report the idle seconds that a span name
covers, less those of the names inside it, as a share of the stretch."""

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Interval] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def minus(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The sorted disjoint intervals ``a`` less the sorted disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def intersect_s(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Seconds in both of two sorted disjoint interval lists."""
    return length(a) - length(minus(a, b))


def idle(trace) -> List[Interval]:
    """The stretch's seconds with no device record running."""
    return minus([(0.0, trace.window_s)],
                 union(((s, s + d) for _, s, d in trace.records), 0.0, trace.window_s))


def spans(trace, name: str) -> List[Interval]:
    """The intervals of the host spans named ``name``, by start."""
    return sorted((s, s + d) for n, s, d in trace.host_ops if n == name)


def covered(trace, name: str, skip: int = 0) -> List[Interval]:
    """The union of the spans named ``name`` within the stretch, the first
    ``skip`` of them left out."""
    return union(spans(trace, name)[skip:], 0.0, trace.window_s)


def count(trace, name: str) -> int:
    return len(spans(trace, name))


def idle_pct(trace, name: str, less: Sequence[str] = (), skip: int = 0) -> float:
    """% of the stretch in which the device is idle while the host is in a
    span ``name`` (the first ``skip`` left out) and in none of the spans
    ``less``."""
    region = covered(trace, name, skip)
    for other in less:
        region = minus(region, covered(trace, other))
    return 100.0 * intersect_s(idle(trace), region) / trace.window_s
