"""Device ms of the convolution and matmul kernels (cuDNN, cuBLAS; forward
and backward) of the traced stretch, per train step."""


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    ms = 1e3 * tr.seconds_by_class().get("conv_matmul", 0.0)
    return ms / tr.units if ms else None
