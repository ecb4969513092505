"""Device ms of the port's hand-written bf16 convolution (the launches
whose kernel name contains ``conv1d_bf16_kernel``, ``csrc/conv1d_bf16.cu``)
of the traced stretch, per predictor call (the encode's counted with
them). Nothing where the kernel never launched: a program without it, or
a cell whose convolutions it does not take."""

KERNEL = "conv1d_bf16_kernel"


def read(window):
    tr = window.trace
    if tr is None or not tr.units:
        return None
    times = [d for name, _, d in tr.records if KERNEL in name]
    return 1e3 * sum(times) / tr.units if times else None
