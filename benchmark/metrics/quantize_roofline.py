"""Share of their bound that the quantize launches of the traced stretch
reach (the amax and codes passes, with the producer each recomputes: a
GroupNorm's apply, a residual sum, or none): each quantize's least time,
its inputs read once as they are stored and its codes and scale written
once at the card's HBM rate (``counts.py``), summed, over the two passes'
device time, in %. Nothing is read unless every predictor call made the
quantize launches that its shapes have."""


def read(window):
    tr, info = window.trace, window.info
    if tr is None or not tr.units or not info.get("quantize_launches_per_call"):
        return None
    if tr.launches_by_class().get("quantize") != info["quantize_launches_per_call"] * tr.units:
        return None
    device_s = tr.seconds_by_class()["quantize"]
    return 100.0 * info["quantize_bound_s_per_call"] * tr.units / device_s
