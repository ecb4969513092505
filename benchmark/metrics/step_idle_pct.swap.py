"""Share of the traced stretch in which the device is idle while the host
is inside a sampler step (the program's ``vvs.step`` span, one iteration
of the sampler's loop) and outside its predictor call (``vvs.predict``):
the sampler's update between calls, in %. The benchmark's recorder wraps
``predict_eps`` from outside, so its copies of the kept rows are counted
here. Nothing is read unless the stretch holds one step span and one
predictor span a predictor call."""

import span_idle


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    if any(span_idle.count(tr, n) != tr.units for n in ("vvs.step", "vvs.predict")):
        return None
    return span_idle.idle_pct(tr, "vvs.step", less=("vvs.predict",))
