"""Host ms a train step of the traced stretch spent waiting on the
program's loader (the ``vvs.data.wait`` span, around the consumer's take
from the loader's queue in ``DataLoader.__iter__``). Nothing is read
unless the stretch holds one such span a step, or one more: the take that
ends an epoch (the loader's end marker) is a wait of its own, and a
stretch shorter than an epoch crosses at most one end."""

import span_idle


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    if span_idle.count(tr, "vvs.data.wait") not in (tr.units, tr.units + 1):
        return None
    return 1e3 * span_idle.length(span_idle.covered(tr, "vvs.data.wait")) / tr.units
