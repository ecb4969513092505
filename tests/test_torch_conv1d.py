"""The serving forward's bf16 convolution route (vq_voice_swap_torch/ops/conv1d.py)
on the CPU: the routing rule as a pure function of what a call observes,
the wrapper's CPU route against ``F.conv1d``, the kernel's weight layout
and its cache on the module, the window bound the rule is built on,
and the funnel ``models/layers.py``'s ``conv1d`` taking the route
where the rule says so. The kernel itself is tested on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from vq_voice_swap_torch.models import layers
from vq_voice_swap_torch.models.layers import Conv1d
from vq_voice_swap_torch.ops import conv1d as c1

BF16 = torch.bfloat16


def conv(cin, cout, k=3, dilation=1, bias=True):
    m = torch.nn.Conv1d(cin, cout, k, dilation=dilation, padding=(k - 1) * dilation // 2,
                        bias=bias)
    with torch.no_grad():
        m.weight.normal_()
        if bias:
            m.bias.normal_()
    return m


def route(m, shape, device="cuda", dtype=BF16, recording=False, dense=True):
    return c1.routes(device, dtype, recording, shape, dense, m)


@pytest.mark.parametrize("device,dtype,recording,dense,want", [
    ("cuda", BF16, False, True, True),
    ("cpu", BF16, False, True, False),
    ("cuda", torch.float32, False, True, False),
    ("cuda", torch.float16, False, True, False),
    ("cuda", BF16, True, True, False),
    ("cuda", BF16, False, False, False),
])
def test_route_by_device_dtype_grad_mesh_layout(device, dtype, recording, dense, want):
    """The rule by what the call observes; a sequence-parallel mesh is
    settled before it is asked (``test_the_funnel_leaves_a_mesh_to_the_
    sharded_route``)."""
    m = conv(64, 64, 3, 2)
    assert route(m, (4, 64, 64000), device, dtype, recording, dense) is want


def test_the_funnel_leaves_a_mesh_to_the_sharded_route(monkeypatch):
    """Under an active sequence-parallel mesh ``layers.conv1d`` runs the
    sharded convolution and never asks the rule."""
    asked, sharded = [], []
    monkeypatch.setattr(layers, "active_mesh", lambda: "mesh")
    monkeypatch.setattr(layers, "routes", lambda *args: asked.append(args) or True)
    monkeypatch.setattr(layers, "seq_sharded_conv1d",
                        lambda mesh, x, w, b, **kw: sharded.append((mesh, kw)) or x)
    m = Conv1d(64, 64, 3, dilation=2)
    x = torch.randn(2, 64, 48).to(BF16)
    with torch.no_grad():
        assert m(x) is x
    assert asked == [] and sharded == [("mesh", {"stride": 1, "dilation": 2})]


@pytest.mark.parametrize("cin,cout,k,dilation,t,want", [
    (64, 64, 3, 2, 64000, True),
    (1, 64, 3, 1, 64000, True),            # in_conv
    (64, 1, 3, 1, 64000, True),            # out_conv
    (c1.MAX_CIN, 128, 1, 1, 8000, True),   # the widest input of every kind
    (c1.MAX_CIN + 16, 128, 1, 1, 8000, False),
    (256, 128, 3, 1, 8000, True),          # wider: 3 taps to at most 128
    (256, 129, 3, 1, 8000, False),
    (256, 256, 3, 2, 2000, False),
    (272, 128, 3, 1, 8000, False),
    (2 * c1.MAX_CIN, 256, 1, 1, 2000, False),
    (128, 64, 1, 1, 64000, True),          # a skip projection
    (64, 64, 3, 2, 64004, False),          # T not a multiple of 8
    (64, 64, 3, 2, 8, True),
    (512, 512, 3, 32, 250, False),         # the deepest level
    (64, 64, 2, 1, 64000, False),          # even taps
    (64, 64, 5, 1, 64000, False),
])
def test_route_by_shape(cin, cout, k, dilation, t, want):
    assert route(conv(cin, cout, k, dilation), (2, cin, t)) is want


def test_route_refuses_stride_groups_padding_and_a_channel_mismatch():
    assert not route(torch.nn.Conv1d(64, 64, 3, stride=2, padding=1), (2, 64, 64000))
    assert not route(torch.nn.Conv1d(64, 64, 3, groups=2, padding=1), (2, 64, 64000))
    assert not route(torch.nn.Conv1d(64, 64, 3, padding=0), (2, 64, 64000))
    assert not route(torch.nn.Conv1d(64, 64, 3, padding=1, padding_mode="reflect"),
                     (2, 64, 64000))
    assert not route(conv(64, 64), (2, 32, 64000))
    assert route(conv(64, 64), (2, 64, 64000))


def test_shared_memory_bounds_the_shapes():
    # The kernel's smallest layout at 3 taps: two stages, each a raw window
    # of 64 channels x (rc + 1) 16-byte chunks and a weight slice of
    # 3 x 64 x 64 bf16, beside rc x 8 transposed rows of 144 bytes. The
    # window spans 128 + MAX_REACH positions from an 8-aligned start (the
    # padding rounded up to 8, at most MAX_REACH / 2, on the left): rc = 56
    # chunks fit a block's 232448 bytes, 58 do not.
    def layout(rc):
        return 2 * (64 * (rc + 1) * 16 + 3 * 64 * 64 * 2) + rc * 8 * 144

    rc = 2 * -(-(128 + c1.MAX_REACH) // 16)
    assert layout(rc) <= 232448 < layout(rc + 2)
    assert c1.fits(64, 64, 3, 1, 160, 160, 1, 64000)
    assert not c1.fits(64, 64, 3, 1, 161, 161, 1, 64000)
    # A halo wider than a tile (dilation 100: 200 positions) fits; one tap
    # has none.
    assert c1.fits(64, 64, 3, 1, 100, 100, 1, 64000)
    assert c1.fits(64, 64, 1, 1, 0, 1000, 1, 64000)
    assert not c1.fits(64, 64, 3, 1, 1000, 1000, 1, 64000)


@pytest.mark.parametrize("cin,cout,k,dilation,bias", [(64, 64, 3, 2, True), (1, 64, 3, 1, True),
                                                      (128, 64, 1, 1, True), (64, 1, 3, 1, False)])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_cpu_route_is_f_conv1d_plus_the_bias(cin, cout, k, dilation, bias, dtype):
    m = conv(cin, cout, k, dilation, bias)
    x = torch.randn(2, cin, 40).to(dtype)
    got = c1.conv1d_bf16(x, m.weight, m.bias, dilation, m)
    want = F.conv1d(x, m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype),
                    padding=(k - 1) * dilation // 2, dilation=dilation)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(c1.conv1d_bf16_plain(x, m.weight, m.bias, dilation), want)


def test_kernel_layout_pads_and_rounds():
    m = conv(20, 70, 3)
    layout, b32 = c1.kernel_weight(m, m.weight, m.bias)
    assert layout.shape == (3, 128, 32) and layout.dtype == BF16
    assert torch.equal(layout[:, :70, :20], m.weight.to(BF16).permute(2, 0, 1))
    assert not layout[:, 70:].any() and not layout[:, :, 20:].any()
    assert b32.dtype == torch.float32 and torch.equal(b32, m.bias.to(BF16).float())
    m = conv(20, 70, 3, bias=False)
    assert c1.kernel_weight(m, m.weight, m.bias)[1] is None


def test_kernel_weight_is_kept_until_the_parameters_change():
    m = conv(64, 64)
    first = c1.kernel_weight(m, m.weight, m.bias)
    assert c1.kernel_weight(m, m.weight, m.bias) is first
    new = {k: torch.randn_like(v) for k, v in m.state_dict().items()}
    m.load_state_dict(new)
    after_load = c1.kernel_weight(m, m.weight, m.bias)
    assert after_load is not first
    assert torch.equal(after_load[0][:, :, :64], new["weight"].to(BF16).permute(2, 0, 1))
    assert c1.kernel_weight(m, m.weight, m.bias) is after_load
    with torch.no_grad():  # an optimizer step writes in place
        m.weight.add_(1.0)
    stepped = c1.kernel_weight(m, m.weight, m.bias)
    assert stepped is not after_load
    assert torch.equal(stepped[0][:, :, :64], m.weight.to(BF16).permute(2, 0, 1))
    with torch.no_grad():
        m.bias.mul_(2.0)
    biased = c1.kernel_weight(m, m.weight, m.bias)
    assert biased is not stepped and torch.equal(biased[1], m.bias.to(BF16).float())
    swapped = torch.nn.Parameter(torch.randn_like(m.weight))  # an EMA swap
    m.weight = swapped
    assert c1.kernel_weight(m, m.weight, m.bias) is not biased


def test_kernel_weight_of_inference_tensors_is_made_every_call():
    """Parameters loaded under ``torch.inference_mode`` (the eval CLIs) have
    no version counter: their layout is made anew, never kept."""
    with torch.inference_mode():
        m = conv(64, 64)
        first = c1.kernel_weight(m, m.weight, m.bias)
        m.weight.add_(1.0)
        second = c1.kernel_weight(m, m.weight, m.bias)
    assert "_bf16_weight" not in m.__dict__
    assert torch.equal(second[0][:, :, :64], m.weight.to(BF16).permute(2, 0, 1))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("grad,requires,want", [(False, False, 1), (False, True, 1),
                                                (True, False, 1), (True, True, 0)])
def test_the_funnel_takes_the_route_the_rule_gives(monkeypatch, grad, requires, want):
    """``layers.conv1d`` asks ``routes`` with what the call observes and
    runs the wrapper where it says yes (stood in here for the CPU by a rule
    that ignores the device)."""
    asked, calls = [], []
    real_routes, real_wrapper = c1.routes, c1.conv1d_bf16

    def cpu_routes(device, dtype, recording, shape, dense, m):
        asked.append((device, dtype, recording, tuple(shape), dense))
        return real_routes("cuda", dtype, recording, shape, dense, m)

    def wrapper(*args):
        calls.append(args)
        return real_wrapper(*args)

    monkeypatch.setattr(layers, "routes", cpu_routes)
    monkeypatch.setattr(layers, "conv1d_bf16", wrapper)
    m = Conv1d(64, 64, 3, dilation=2).requires_grad_(requires)
    x = torch.randn(2, 64, 48).to(BF16)
    with torch.set_grad_enabled(grad):
        y = m(x)
    assert asked == [("cpu", BF16, grad and requires, (2, 64, 48), True)]
    assert len(calls) == want
    if want:
        assert calls[0][3] == 2 and calls[0][4] is m.conv
    want_y = F.conv1d(x, m.conv.weight.to(BF16), m.conv.bias.to(BF16), padding=2, dilation=2)
    assert torch.equal(y, want_y)
