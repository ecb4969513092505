"""Share of the traced stretch in which the device is idle while the host
is inside an encode (the program's ``vvs.encode`` span, around
``VQVAE.encode``: the encoder and the VQ assignment), in %. Nothing is
read unless the stretch holds one such span a batch (its predictor calls
over the sampler's steps)."""

import span_idle


def read(window):
    tr, steps = window.trace, window.info.get("steps")
    if tr is None or not tr.units or not steps or tr.units % steps:
        return None
    if span_idle.count(tr, "vvs.encode") != tr.units // steps:
        return None
    return span_idle.idle_pct(tr, "vvs.encode")
