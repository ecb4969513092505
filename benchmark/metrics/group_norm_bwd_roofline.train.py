"""Share of their bound that the GroupNorm backward launches of the traced
stretch reach: the least time of every GroupNorm's backward bytes (x and
dy read once, dx written once, at the card's HBM rate) over the device
time of the backward kernels, whatever their route, in %. Nothing is read
unless the stretch ran a backward for every GroupNorm of its steps."""


def read(window):
    tr, info = window.trace, window.info
    if tr is None or not tr.units:
        return None
    if tr.launches_by_class().get("group_norm_bwd", 0) < info["group_norms_per_step"] * tr.units:
        return None
    device_s = tr.seconds_by_class()["group_norm_bwd"]
    return 100.0 * info["group_norm_bwd_bound_s_per_step"] * tr.units / device_s
