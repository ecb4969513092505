"""Share of the traced stretch in which the device is idle while the host
stages a window's batches (the program's ``vvs.train.stage`` span: the
batches stacked, pinned and copied to the device), in %, over the steady
windows: the stretch's first stage is left out, since the driver flushes
every window and the harness synchronizes the card before the stretch, so
that stage runs on an empty card whatever the loop does. Nothing is read
unless the stretch holds one such span a window, at least two windows, a
whole number of steps each."""

import span_idle


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    windows = span_idle.count(tr, "vvs.train.stage")
    if windows < 2 or tr.units % windows:
        return None
    return span_idle.idle_pct(tr, "vvs.train.stage", skip=1)
