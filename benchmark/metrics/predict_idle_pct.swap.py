"""Share of the traced stretch in which the device is idle while the host
is inside a predictor call (the program's ``vvs.predict`` span, around
``DiffusionModel.predict_eps``: the predictor's dispatch), in %. Nothing
is read unless the stretch holds one such span a predictor call."""

import span_idle


def read(window):
    tr = window.trace
    if tr is None or not tr.units or span_idle.count(tr, "vvs.predict") != tr.units:
        return None
    return span_idle.idle_pct(tr, "vvs.predict")
