"""Share of the traced stretch in which the device is idle while the host
fetches and logs a window's metrics (the program's ``vvs.train.flush``
span, ``TrainLoop._flush_one``), in %. The benchmark flushes every window
before the stretch, and the loop fetches a window's metrics once the next
is queued (``--pipeline-depth 1``), so the stretch flushes once a steady
window: each staged window after the first (the windows
``stage_idle_pct.train`` reads). Nothing is read otherwise, or without a
whole number of steps a staged window."""

import span_idle


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    windows = span_idle.count(tr, "vvs.train.stage")
    if windows < 2 or tr.units % windows:
        return None
    if span_idle.count(tr, "vvs.train.flush") != windows - 1:
        return None
    return span_idle.idle_pct(tr, "vvs.train.flush")
