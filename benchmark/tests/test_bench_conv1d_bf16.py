"""``metrics/conv1d_bf16_ms.swap.py`` on synthetic traces: the device ms of
the hand-written bf16 convolution's records per predictor call, and
nothing where it never launched."""

import os

import pytest

from conftest import BENCH

import harness

KERNEL = "void (anonymous namespace)::conv1d_bf16_kernel((anonymous namespace)::Args)"


def read(window):
    path = os.path.join(BENCH, "metrics", "conv1d_bf16_ms.swap.py")
    return harness.load_module(path, "bench_metric_conv1d_bf16_ms_swap").read(window)


def window(records, units):
    return harness.Window({"steps": 10}, harness.Trace(records, [], 2.0, units))


def test_device_ms_per_call():
    records = [(KERNEL, 0.0, 0.004), ("sm90_xmma_fprop_implicit_gemm", 0.004, 0.002),
               (KERNEL, 0.006, 0.006), ("elementwise_kernel<128, 4>", 0.012, 0.001),
               (KERNEL, 0.02, 0.010)]
    assert read(window(records, 4)) == pytest.approx(1e3 * 0.020 / 4)
    assert harness.kernel_class(KERNEL) == "conv_matmul"


@pytest.mark.parametrize("win", [
    window([("sm90_xmma_fprop_implicit_gemm", 0.0, 0.002)], 3),   # cuDNN alone
    window([], 3),
    window([(KERNEL, 0.0, 0.004)], 0),                             # no predictor call
    harness.Window({"steps": 10}),                                 # untraced
])
def test_nothing_without_a_launch(win):
    assert read(win) is None
