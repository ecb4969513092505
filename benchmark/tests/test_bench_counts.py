"""``counts.py`` against torch's own count and the port's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import counts
from reference.model import VQVAE

SWAP = dict(pred_name="unet", base_channels=64, enc_name="conv-mfcc-ulaw", dictionary_size=512,
            num_labels=251)


@pytest.mark.parametrize("enc,t", [("conv-mfcc-ulaw", 6400), ("unet128", 16384)])
def test_flops_equal_the_flop_counter(enc, t):
    model = dict(SWAP, base_channels=4, enc_name=enc, dictionary_size=16, num_labels=5)
    ref = VQVAE(**model)
    x = torch.randn(2, t, 1) * 0.3
    cond_t = t // ref.encoder.downsample_rate
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.encoder(x)
    assert fc.get_total_flops() == 2 * sum(x["flops"] for x in counts.encoder_layers(model, t))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.predictor(x, torch.rand(2), torch.randn(2, cond_t, 64), torch.tensor([1, 2]))
    want = counts.unet_predictor_layers(4, t, 64, cond_t)
    assert fc.get_total_flops() == 2 * sum(x["flops"] for x in want)


def test_group_norm_counts():
    layers = counts.predictor_layers(SWAP, 64000)
    assert sum(x["op"] == "group_norm" for x in layers) == 131
    enc = counts.unet_encoder_layers(64, 64000, 1024)
    assert sum(x["op"] == "group_norm" for x in enc) == 47
    assert sum(x.get("int8", False) for x in counts.predictor_layers(SWAP, 64000, 16000)) == 50


def test_bytes_reproduce_the_kernel_table():
    """The bounds of the port's kernel table: row 2 (statistics) 0.0783 ms
    and row 3 (apply) 0.1565 ms at [16, 64, 64000] f32, row 6 (backward)
    0.1174 ms at [16, 32, 64000] f32."""
    gn = counts.group_norm_bytes(16, 64, 64000, "float32", False)
    assert round(gn["stats"] / counts.HBM_BYTES_PER_S * 1e3, 4) == 0.0783
    assert round(gn["apply"] / counts.HBM_BYTES_PER_S * 1e3, 4) == 0.1565
    bwd = counts.group_norm_bwd_bytes(16, 32, 64000, "float32", False)
    assert round(bwd / counts.HBM_BYTES_PER_S * 1e3, 4) == 0.1174


def test_int8_sites_follow_the_port():
    """The int8 unet64 call at --act-int8 16000, as the port's kernel table
    and launch counters have it: 21 int8 statistics (one scale or one a
    channel), 4 int8 applies, 89 float applies, 38 applies recomputed by
    a quantize; 61 quantizes (38 GroupNorm, 20 residual, 3 without a
    prologue), so 122 quantize launches; 50 int8 convolutions."""
    layers = counts.predictor_layers(SWAP, 64000, 16000)
    gn = [x for x in layers if x["op"] == "group_norm"]
    q = [x for x in layers if x["op"] == "quantize"]
    assert sum(x["x"] != "float" for x in gn) == 21
    assert [sum(x["apply"] == a for x in gn) for a in ("int8", "float", "fused")] == [4, 89, 38]
    assert [sum(x["pro"] == p for x in q) for p in ("norm", "residual", "none")] == [38, 20, 3]
    assert sum(x["int8"] for x in layers if x["op"] == "conv") == 50
    plain = counts.predictor_layers(SWAP, 64000)
    assert not any(x["op"] == "quantize" for x in plain)
    assert all(x["x"] == x["apply"] == "float" for x in plain if x["op"] == "group_norm")


# (site, shape, dtype, bound ms): the kernel table's rows 2i, 3i and 8.
INT8_ROWS = [
    ("stats int8", (16, 64, 64000), "float32", 0.0196),
    ("stats int8c", (16, 128, 64000), "float32", 0.0391),
    ("apply int8", (16, 64, 64000), "float32", 0.0978),
    ("norm int8", (16, 64, 64000), "float32", 0.0391),
    ("norm float", (16, 64, 64000), "float32", 0.0978),
    ("norm float", (16, 64, 64000), "bfloat16", 0.0587),
    ("residual int8", (16, 64, 64000), "float32", 0.1174),
    ("residual int8", (16, 64, 64000), "bfloat16", 0.0783),
    ("residual float", (16, 64, 64000), "float32", 0.1761),
    ("residual float", (16, 64, 64000), "bfloat16", 0.0978),
    ("none float", (16, 64, 64000), "float32", 0.0978),
    ("none float", (16, 64, 64000), "bfloat16", 0.0587),
]


@pytest.mark.parametrize("site,shape,dtype,ms", INT8_ROWS)
def test_int8_bytes_reproduce_the_kernel_table(site, shape, dtype, ms):
    kind, x = site.split()
    n, c, t = shape
    if kind in ("stats", "apply"):
        nbytes = counts.group_norm_bytes(n, c, t, dtype, False, x, "int8")[kind]
    else:
        args = dict(x=x, skip="") if kind != "residual" else dict(x="float", skip=x)
        nbytes = counts.quantize_bytes(n, dict(c=c, t=t, pro=kind, **args), dtype)
    assert round(nbytes / counts.HBM_BYTES_PER_S * 1e3, 4) == ms


def test_batch_flops():
    """93.1 TFLOP a swap batch of 64 x 4 s at 10 steps; 8.7 TFLOP a train
    step at 16."""
    assert round(counts.swap_batch_flops(SWAP, 64, 64000, 10) / 1e12, 1) == 93.1
    train = dict(SWAP, enc_name="unet128")
    assert round(counts.train_step_flops(train, 16, 64000) / 1e12, 1) == 8.7
