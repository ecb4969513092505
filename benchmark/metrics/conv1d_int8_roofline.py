"""Share of their bound that the int8 convolution launches of the traced
stretch reach: each launch's least time, the larger of its operations at
the int8 peak and its bytes at the HBM rate (``counts.py``), summed, over
their device time, in %. Nothing is read unless every predictor call made
the int8 convolutions that its shapes have."""


def read(window):
    tr, info = window.trace, window.info
    if tr is None or not tr.units or not info.get("int8_convs_per_call"):
        return None
    if tr.launches_by_class().get("conv1d_int8") != info["int8_convs_per_call"] * tr.units:
        return None
    device_s = tr.seconds_by_class()["conv1d_int8"]
    return 100.0 * info["int8_conv_bound_s_per_call"] * tr.units / device_s
