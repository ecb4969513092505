"""Share of their bound that the GroupNorm statistics and apply launches
of the traced stretch reach: the least time of their bytes (each input
read once as it is stored, float or int8 codes, each output written once,
at the card's HBM rate; ``counts.py``) over their device time, in %. An
apply that a quantize recomputes has no launch and no bytes here (the
quantize's roofline counts it). Nothing is read unless every predictor
call of the stretch made the statistics (float and int8) and apply
launches that its shapes have."""


def read(window):
    tr, info = window.trace, window.info
    if tr is None or not tr.units or "group_norm_bound_s_per_call" not in info:
        return None
    launches, units = tr.launches_by_class(), tr.units
    for kind, per_call in (("group_norm_stats", "group_norm_stats_per_call"),
                           ("group_norm_stats_int8", "group_norm_stats_int8_per_call"),
                           ("group_norm_apply", "group_norm_applies_per_call")):
        if launches.get(kind, 0) != info[per_call] * units:
            return None
    by = tr.seconds_by_class()
    device_s = sum(by.get(k, 0.0) for k in ("group_norm_stats", "group_norm_stats_int8",
                                            "group_norm_apply"))
    return 100.0 * info["group_norm_bound_s_per_call"] * units / device_s
