"""Share of their bound that the int8 GroupNorm statistics launches of the
traced stretch reach (the kernel of their own that reads int8 codes):
each launch's least time, its codes, scale and affine read once and
(mean, a, b) written once at the card's HBM rate (``counts.py``), summed,
over their device time, in %. Nothing is read unless every predictor call
made the int8 statistics launches that its shapes have."""


def read(window):
    tr, info = window.trace, window.info
    if tr is None or not tr.units or not info.get("group_norm_stats_int8_per_call"):
        return None
    want = info["group_norm_stats_int8_per_call"] * tr.units
    if tr.launches_by_class().get("group_norm_stats_int8") != want:
        return None
    device_s = tr.seconds_by_class()["group_norm_stats_int8"]
    return 100.0 * info["group_norm_stats_int8_bound_s_per_call"] * tr.units / device_s
