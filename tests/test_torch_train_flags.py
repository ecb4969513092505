"""The single-device train flags of the PyTorch port on the CPU:
``--steps-per-dispatch`` (K steps a window through the loop's drawer: the
K=1 run's bits, saves where the JAX loop saves them), ``--async-save``
(a save inside a window marked at the window's end, and a resume from the
marker), ``--grad-checkpoint full|convs`` (the un-checkpointed gradients
with dropout active; ``convs`` recomputes no convolution and matches the
JAX package's ``remat="convs"``), ``--profile-dir`` and the flags' syntax.

Runs are the full topology at base 2 on ``tones`` (a few seconds a step on
one thread); the JAX comparison uses a shallow UNet (two levels of one
block), as tests/test_torch_train.py does. Tolerances: bits where the
same arithmetic runs (K windows, ``full`` remat); ``convs`` within 1e-6 of
each gradient leaf's largest entry; against JAX within 2e-4 of it plus
1e-6 of the largest gradient (a conv bias feeding a GroupNorm of one
channel a group has a true gradient of 0).
"""

import copy
import glob
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch.utils._python_dispatch import TorchDispatchMode

from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxUNetPredictor
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_torch import (train_classifier, train_diffusion, train_enc_pred,
                                 train_vqvae, train_vqvae_add, train_vqvae_uncond)
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.models.layers import remat_policy
from vq_voice_swap_torch.models.unet import UNetPredictor
from vq_voice_swap_torch.observe.logger import _scan_resume_point
from vq_voice_swap_torch.train import ClassifierTrainLoop, VQVAETrainLoop
from vq_voice_swap_torch.vq_vae import VQVAE

CLIS = (train_vqvae, train_diffusion, train_vqvae_add, train_vqvae_uncond,
        train_classifier, train_enc_pred)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """CPU training at base 2 is thousands of tiny ops a step: one
    intra-op thread runs it about as fast as eight alone, and does not
    spin against the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# Dropout, jitter, two microbatch forwards a step and the revival of dead
# codes: every draw the drawer has to reproduce.
VQVAE_ARGS = ["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
              "--microbatch", "1", "--class-cond", "--ema-rate", "0.99", "--dropout", "0.1",
              "--jitter", "0.1", "--dead-rate", "2", "--lr", "1e-3", "tones"]
# The curriculum changes ts_power every step: prepare_batch must see each
# step's own total_steps inside a window.
CLASSIFIER_ARGS = ["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
                   "--curriculum-steps", "4", "--ema-rate", "0.99", "--lr", "1e-3", "tones"]


def _run(loop_cls, args, out, *extra):
    loop = loop_cls(loop_cls.arg_parser().parse_args(args + ["--output-dir", str(out),
                                                             *extra]))
    loop.loop()
    return loop


def _log(out):
    with open(os.path.join(out, "train_log.txt")) as f:
        return f.read().splitlines()


def _fields(line):
    """A step line's fields but samples/s (a wall-clock rate)."""
    return [f for f in line.split() if not f.startswith("samples_per_sec=")]


def _saved_after(lines):
    """The step logged last before each '# saved' line."""
    last, out = 0, []
    for ln in lines:
        if ln.startswith("step "):
            last = int(ln.split(":")[0][5:])
        elif ln == "# saved":
            out.append(last)
    return out


def _state(loop):
    """Every tensor of a loop's training state, by name."""
    out = {f"model.{k}": v.clone() for k, v in loop.model.state_dict().items()}
    for ema in loop.emas:
        out.update((f"ema{ema.rate}.{k}", v.clone())
                   for k, v in ema.model.state_dict().items())
    for i, st in loop.optimizer.adamw.state_dict()["state"].items():
        out.update((f"adamw.{i}.{k}", v.clone()) for k, v in st.items())
    return out


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("which", ["vqvae", "classifier"])
def test_steps_per_dispatch_2_is_the_one_step_run_bit_for_bit(tmp_path, which):
    """Five steps at K=2 (two windows and a one-step tail) against K=1: the
    same losses and metrics, model, EMA and AdamW state, bit for bit."""
    loop_cls, args = {"vqvae": (VQVAETrainLoop, VQVAE_ARGS),
                      "classifier": (ClassifierTrainLoop, CLASSIFIER_ARGS)}[which]
    args = args + ["--max-steps", "5", "--save-interval", "5"]
    one = _run(loop_cls, args, tmp_path / "k1")
    two = _run(loop_cls, args, tmp_path / "k2", "--steps-per-dispatch", "2")
    assert two.graphed_step is None  # the CPU runs the window eagerly
    log1, log2 = _log(tmp_path / "k1"), _log(tmp_path / "k2")
    assert [_fields(x) for x in log1] == [_fields(x) for x in log2]
    assert _saved_after(log2) == [5]
    _assert_same_bits(_state(one), _state(two))
    assert one.optimizer.count == two.optimizer.count == 5
    if which == "vqvae":
        used = [float(x.split("codebook_used=")[1].split()[0]) for x in log1 if "step" in x]
        assert min(used) < 512  # codes died and the revival drew its picks


def _jax_saved_after(max_steps: int, interval: int, k: int):
    """Where the JAX loop saves with --steps-per-dispatch: its
    _loop_multi and step, with the dispatches stubbed to count steps."""
    loop = object.__new__(jax_loops.VQVAETrainLoop)
    loop.args = types.SimpleNamespace(save_interval=interval, pipeline_depth=1, seed=0)
    loop.rng_seed = 0
    loop.logger = types.SimpleNamespace(start_step=0)
    loop.data_loader = [{"x": np.zeros(1)}]
    loop.mesh = None
    loop.frozen_ctx = None
    loop.state = None
    done, saves = [0], []

    def multi_step(state, batches, rngs, ctx):
        done[0] += len(rngs)
        return state, None

    def train_step(state, batch, rng, ctx):
        done[0] += 1
        return state, None

    loop.multi_step, loop.train_step = multi_step, train_step
    loop._flush_one = lambda: loop._pending.pop(0)
    loop.save = lambda: saves.append(done[0])
    loop._pending = []
    staged, single = jax_loops.staged_global_batch_from_local, jax_loops.global_batch_from_local
    try:
        jax_loops.staged_global_batch_from_local = lambda mesh, batches: batches
        jax_loops.global_batch_from_local = lambda mesh, batch: batch
        loop._loop_multi(max_steps, k)
    finally:
        jax_loops.staged_global_batch_from_local = staged
        jax_loops.global_batch_from_local = single
    return saves


@pytest.mark.parametrize("snapshot", ["host", "device"])
def test_async_save_in_a_window_marks_its_end_and_resumes(tmp_path, snapshot):
    """K=2, a save interval of 3 and 5 steps: the save lands at the window
    boundary after step 4, where the JAX loop saves, marked '# saving @ 4'
    (the JAX loop marks the window's base); its files are the K=1 run's
    state after step 4, and a resume from the marker runs step 5 as the
    K=1 run does."""
    args = VQVAE_ARGS + ["--max-steps", "5"]
    _run(VQVAETrainLoop, args, tmp_path / "k1", "--save-interval", "4")
    out = tmp_path / "k2"
    _run(VQVAETrainLoop, args, out, "--save-interval", "3", "--steps-per-dispatch", "2",
         "--async-save", "--async-snapshot", snapshot)
    lines = _log(out)
    # The marker follows step 4's line; the worker's '# saved' comes later.
    assert lines[4] == "# saving @ 4" and lines.count("# saved") == 1
    assert lines.index("# saved") > 4 and len(lines) == 7
    assert _jax_saved_after(5, 3, 2) == [4]
    for name in ("model.npz", "model_ema_0.99.npz"):
        with np.load(tmp_path / "k1" / name) as want, np.load(out / name) as got:
            assert want.files == got.files
            for k in want.files:
                assert np.array_equal(want[k], got[k]), (name, k)
    want = torch.load(tmp_path / "k1" / "opt.pt", weights_only=True)
    got = torch.load(out / "opt.pt", weights_only=True)
    assert want["count"] == got["count"] == 4
    for i, st in want["adamw"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got["adamw"]["state"][i][k]), (i, k)

    # Both runs resume at step 4 (the K=1 run from its own save there) and
    # take step 5 from the same state: the same bits.
    resumed = []
    for run in (out, tmp_path / "k1"):
        assert _scan_resume_point(str(run / "train_log.txt"))[0] == 4
        resumed.append(_run(VQVAETrainLoop, VQVAE_ARGS + ["--max-steps", "1"], run))
        assert resumed[-1].logger.start_step == 4
    step5 = [[x for x in _log(run) if x.startswith("step 5:")] for run in (out, tmp_path / "k1")]
    assert len(step5[0]) == len(step5[1]) == 1
    assert _fields(step5[0][0]) == _fields(step5[1][0])
    _assert_same_bits(_state(resumed[0]), _state(resumed[1]))


@pytest.mark.parametrize("max_steps,interval,k", [(5, 3, 2), (12, 5, 4), (7, 7, 3), (9, 2, 2)])
def test_window_saves_land_where_the_jax_loop_saves(tmp_path, monkeypatch, max_steps,
                                                     interval, k):
    """The '# saved' positions of a K-window run equal the JAX loop's at the
    same --max-steps and --save-interval (the step itself stubbed: the
    positions come from the loop alone)."""
    loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(
        VQVAE_ARGS + ["--output-dir", str(tmp_path), "--save-interval", str(interval),
                      "--steps-per-dispatch", str(k)]))
    metrics = {"loss": torch.tensor(1.0), "ts": torch.zeros(2), "mses": torch.zeros(2),
               "extra": {}}

    class Step:
        def __call__(self, batch, generator, draws=None):
            return metrics

        def draw(self, batch, generator):
            return []

    loop.train_step = Step()
    monkeypatch.setattr(loop, "save", lambda steps_done: loop.logger.mark_save())
    loop.loop(max_steps)
    assert _saved_after(_log(tmp_path)) == _jax_saved_after(max_steps, interval, k)


def _remat_grads(policy, dropout: float = 0.1):
    """A VQ-VAE training forward and backward at base 2 (dropout active):
    the loss, every parameter's gradient and the aten ops the backward
    dispatched."""
    torch.manual_seed(0)
    model = VQVAE(pred_name="unet", base_channels=2, enc_name="unet", num_labels=3,
                  dropout=dropout, remat=policy)
    init_like_flax(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(0.5 * np.tanh(np.random.RandomState(3).randn(2, 1024, 1))).float()
    out = model.losses(x, labels=torch.tensor([0, 2]), train=True, jitter=0.1,
                       generator=torch.Generator().manual_seed(5))
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    with Record():
        (out["mse"] + out["vq_loss"]).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (out["mse"] + out["vq_loss"]).detach(), grads, ops


@pytest.mark.parametrize("policy,tol", [("full", 0.0), ("convs", 1e-6)])
def test_grad_checkpoint_gives_the_gradients_with_dropout(policy, tol):
    loss, grads, _ = _remat_grads(policy)
    want_loss, want, _ = _remat_grads(None)
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys() and all(g is not None for g in want.values())
    for n, g in want.items():
        err = (grads[n] - g).abs().max().item()
        if tol == 0.0:
            assert torch.equal(grads[n], g), n
        else:
            assert err <= tol * g.abs().max().item(), (n, err)


def test_convs_recomputes_no_convolution_and_full_recomputes_them():
    forward_conv = torch.ops.aten.convolution.default
    counts = {p: sum(op is forward_conv for op in _remat_grads(p)[2])
              for p in (None, "convs", "full")}
    assert counts[None] == 0 and counts["convs"] == 0
    # "full" reruns each ResBlock's conv_in, and its conv_out where a skip
    # projection follows it; the recompute stops at the last convolution's
    # input, before that convolution runs.
    blocks = [m for m in VQVAE(pred_name="unet", base_channels=2, enc_name="unet",
                               num_labels=3).modules() if type(m).__name__ == "ResBlock"]
    assert counts["full"] == sum(1 + (b.skip_proj is not None) for b in blocks)


def test_convs_gradients_match_jax_remat_convs():
    """A shallow class-conditional UNetPredictor with remat="convs" in both
    packages (JAX: ``save_only_these_names("rb_conv_in")``): the gradient of
    a weighted sum of its output."""
    kw = dict(base_channels=4, channel_mult=(1, 2), depth_mult=1, middle_dilations=(4,),
              num_labels=3)
    model = UNetPredictor(remat="convs", **kw)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.copy_(noise / np.sqrt(p[0].numel()) if p.ndim >= 2 else 1.0 + 0.1 * noise
                    if name.endswith("norm.weight") else 0.1 * noise)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 256, 1).astype(np.float32)
    ts = np.array([0.3, 0.8], np.float32)
    labels = np.array([0, 2], np.int32)
    w = rng.randn(2, 256, 1).astype(np.float32)

    out = model(torch.from_numpy(x), torch.from_numpy(ts), labels=torch.from_numpy(labels).long())
    (out * torch.from_numpy(w)).sum().backward()

    jax_model = JaxUNetPredictor(remat="convs", **kw)
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in params_to_jax(model).items()})

    def loss(p):
        y = jax_model.apply({"params": p}, jnp.asarray(x), jnp.asarray(ts),
                            labels=jnp.asarray(labels), train=True)
        return jnp.sum(y * w)

    jax_grads = jax.jit(jax.grad(loss))(params)
    flat = traverse_util.flatten_dict(jax_grads, sep="/")
    want = params_from_jax({f"params/{k}": np.asarray(v) for k, v in flat.items()})
    assert sorted(want) == sorted(n for n, _ in model.named_parameters())
    # A conv bias that feeds a GroupNorm of one channel a group has a true
    # gradient of 0 and gets rounding noise: the floor is 1e-6 of the
    # largest gradient.
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    for name, p in model.named_parameters():
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 2e-4 * want[name].abs().max().item() + floor, (name, err)


def test_profile_dir_writes_a_trace(tmp_path):
    out, trace = tmp_path / "run", tmp_path / "trace"
    train_vqvae.main(VQVAE_ARGS + ["--max-steps", "1", "--output-dir", str(out),
                                   "--profile-dir", str(trace)])
    files = glob.glob(str(trace / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def test_bare_grad_checkpoint_parses_as_full_and_unknown_policies_raise(capsys):
    parser = VQVAETrainLoop.arg_parser()
    assert parser.parse_args(["tones", "--grad-checkpoint"]).grad_checkpoint == "full"
    assert parser.parse_args(["--grad-checkpoint=convs", "tones"]).grad_checkpoint == "convs"
    assert parser.parse_args(["tones"]).grad_checkpoint is False
    with pytest.raises(SystemExit):
        parser.parse_args(["--grad-checkpoint=conv", "tones"])
    assert "invalid choice" in capsys.readouterr().err
    assert remat_policy(True) == "full" and remat_policy(False) is None
    for bad in ("conv", "dots"):
        with pytest.raises(ValueError, match="unknown remat policy"):
            remat_policy(bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            DiffusionModel(pred_name="unet", base_channels=2, remat=bad)


@pytest.mark.parametrize("flag,key,value", [
    (["--steps-per-dispatch", "4"], "steps_per_dispatch", 4),
    (["--grad-checkpoint=convs"], "grad_checkpoint", "convs"),
    (["--async-save"], "async_save", True),
    (["--async-snapshot", "device"], "async_snapshot", "device"),
    (["--profile-dir", "trace"], "profile_dir", "trace"),
])
def test_train_clis_take_the_single_device_flags(flag, key, value):
    """All six train CLIs parse the flags with the JAX package's syntax."""
    for cli in CLIS:
        parser = [v for k, v in vars(cli).items() if k.endswith("TrainLoop")][0].arg_parser()
        args = parser.parse_args([*flag, "tones"] + (
            ["--vq-vae-path", "x"] if cli is train_enc_pred else []))
        assert getattr(args, key) == value, cli.__name__
    with pytest.raises(SystemExit):
        VQVAETrainLoop.arg_parser().parse_args(["--async-snapshot", "disk", "tones"])


def test_a_failed_async_save_raises_at_the_next_join(tmp_path, monkeypatch):
    loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(
        VQVAE_ARGS + ["--output-dir", str(tmp_path), "--async-save", "--max-steps", "2",
                      "--save-interval", "1"]))

    def fail(state):
        raise OSError("disk full")

    monkeypatch.setattr(loop, "_write_checkpoints", fail)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint save failed"):
        loop.loop()
    assert "# saving @ 1" in _log(tmp_path)
