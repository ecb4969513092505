"""Data-parallel and FSDP training in the PyTorch port (``parallel/``) on
the CPU, with real gloo ranks spawned from the test (2 and 4;
``tests/torch_parallel_worker.py``).

- The sharding rule: ``fsdp_placements`` against the JAX package's
  ``fsdp_shardings``, leaf by leaf, at data sizes 2 and 4.
- DP and FSDP parity: three steps of the shallow VQ-VAE of
  ``tests/test_torch_train.py`` (revival, a microbatch remainder, the clip,
  an EMA) on N ranks against the one-process step on the global batch:
  losses within 1e-5 relative, the first step's gradients after the
  reduce within 2e-4 of each leaf's largest entry (plus 1e-7, for the
  conv biases whose true gradient is 0), usage counts and codebook equal,
  the parameters the same bits on every rank.
- One FSDP step on two ranks against the JAX package's ``make_train_step``
  on a 2-device mesh with ``shard_state_fsdp``, the same weights and
  draws: the loss within 1e-5 relative.
- The loops: npz and dcp saves resume across DP and FSDP; FSDP's npz is
  the DP run's; ``--steps-per-dispatch 2`` is the K=1 run; a launched run
  at world size 1 is the plain run's bits; the six train CLIs run one
  step with --fsdp and --checkpoint-format dcp; torchrun launches one;
  a launch environment that cannot start raises.

After whole steps, DP against FSDP (gradients summed in another order):
every parameter within twice the steps' learning rates of the other run's,
and 99% of each leaf within 1% of the learning rate (the first AdamW
updates are about lr * sign(g), so a gradient of rounding noise may move
either way; tests/test_torch_train.py).
"""

import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _audio, _loop_stub, _vqvae, _vqvae_draws
from torch_parallel_worker import OPT, T, record_steps, run_group, tiny_vqvae, vq_train_step
from vq_voice_swap_tpu.parallel import create_mesh, fsdp_shardings, shard_batch, shard_state_fsdp
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_tpu.train import steps as jax_steps
from vq_voice_swap_tpu.train.state import TrainState
from vq_voice_swap_tpu.train.state import build_optimizer as jax_build_optimizer
from vq_voice_swap_torch import train_vqvae
from vq_voice_swap_torch.convert import params_to_jax
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.parallel import fsdp_placements, init_distributed, rank_device
from vq_voice_swap_torch.parallel.fsdp import _jax_axes
from vq_voice_swap_torch.train import EMA, build_optimizer

GRAD_TOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _start(world: int):
    """(state, batch): the seeded shallow VQ-VAE (usage counts that run out
    in the first step) and a global batch of 3 rows a rank."""
    audio = _audio(3 * world, seed=12)
    model, _, _ = _vqvae(3, 0.0, audio)
    model.vq.usage_count.copy_(torch.from_numpy(np.array([1, 2] * 8, np.int32)))
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    labels = np.arange(3 * world, dtype=np.int32) % 3
    return state, {"samples": audio[..., 0], "label": labels}


def _one_process(state, batch, steps: int, world: int):
    """The one-process steps on the global batch, chunked as the ranks'
    chunks are (2 rows a rank, then 1)."""
    model = tiny_vqvae()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = build_optimizer(model, **OPT)
    ema = EMA(model, 0.9)
    step = vq_train_step(model, opt, [ema], micro_remainder=world)
    return record_steps(step, ema, batch, steps)


def _close_after_steps(got, want, start, steps: int, moved: float, still=None,
                       lr: float = OPT["lr"]):
    """Whole-step parameters held as the module docstring says. Every
    element is within the bound; a leaf that ``want`` moved from ``start``
    by at least ``moved`` has 99% of its elements within 1% of ``lr``, but
    a conv bias (most feed a GroupNorm: a true gradient of 0, rounding
    noise that Adam moves by its sign); a leaf that did not move passes
    ``still`` (without it, half the other leaves or more are held)."""
    held = others = 0
    for n, w in want.items():
        diff = np.abs(got[n] - w)
        assert diff.max() <= 2 * steps * lr, (n, diff.max())
        if n.replace("/", ".").endswith("conv.bias"):
            continue
        others += 1
        if np.abs(w - start[n]).max() >= moved:
            assert (diff <= 0.01 * lr).mean() >= 0.99, n
            held += 1
        else:
            assert still is not None and still(n), n
    assert still is not None or held >= others // 2, (held, others)


# ------------------------------------------------------- the sharding rule


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_placements_match_jax_shardings(world):
    model = tiny_vqvae()
    placements = fsdp_placements(model, world)
    flat = params_to_jax(model)
    tree = {}
    for key, arr in flat.items():
        if key.startswith("params/"):
            node = tree
            *parents, leaf = key.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.zeros(arr.shape)
    shardings = fsdp_shardings(create_mesh(num_devices=world), tree)
    specs = {"/".join(getattr(k, "key", str(k)) for k in path): s.spec
             for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    modules = dict(model.named_modules())
    by_jax = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        axis = placements[name]
        jax_order = _jax_axes(modules[mod_name], leaf, p.ndim)
        by_jax[name] = None if axis is None else jax_order.index(axis)
    assert len(specs) == len(by_jax)
    from vq_voice_swap_torch.convert import torch_key

    for path, spec in specs.items():
        name = torch_key("params/" + path)
        want = next((i for i, d in enumerate(spec) if d == "data"), None)
        assert by_jax[name] == want, (name, spec)
    assert placements["vq.dictionary"] is None
    assert sum(a is not None for a in placements.values()) > len(placements) // 2


# --------------------------------------------------------- step parity


@pytest.mark.parametrize("world", [2, 4])
def test_steps_on_ranks_match_one_process_at_the_global_batch(world):
    """DP, then FSDP, on the same ranks."""
    steps = 3
    state, batch = _start(world)
    by_rank = run_group(world, "step_parity", state, batch, steps)
    want = _one_process(state, batch, steps, world)
    # Codes died in the first step and were revived.
    assert want["metrics"][0]["codebook_used"] < len(want["usage"])
    total = sum(v.size for v in want["params"].values())
    for fsdp, ranks in zip((False, True), zip(*by_rank)):
        for got in ranks:
            for g, w in zip(got["metrics"], want["metrics"]):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
                np.testing.assert_allclose(g["vq_loss"], w["vq_loss"], rtol=1e-5)
                np.testing.assert_allclose(g["mses"], w["mses"], rtol=1e-5)
                np.testing.assert_array_equal(g["ts"], w["ts"])
                assert g["codebook_used"] == w["codebook_used"]
            assert set(got["grads"]) == set(want["grads"])
            for n, w in want["grads"].items():
                err = np.abs(got["grads"][n] - w).max()
                assert err <= GRAD_TOL * np.abs(w).max() + 1e-7, (fsdp, n, err)
            np.testing.assert_array_equal(got["usage"], want["usage"])
            np.testing.assert_allclose(got["params"]["vq.dictionary"],
                                       want["params"]["vq.dictionary"], rtol=1e-5, atol=1e-6)
            _close_after_steps(got["params"], want["params"], state, steps, 0.5 * OPT["lr"])
            _close_after_steps(got["ema"], want["ema"], state, steps,
                               0.5 * (1 - 0.9 ** steps) * OPT["lr"])
        for got in ranks[1:]:
            for k in ("params", "ema"):
                for n, v in got[k].items():
                    np.testing.assert_array_equal(v, ranks[0][k][n], err_msg=f"{k} {n}")
        if fsdp:
            assert "vq.dictionary" not in ranks[0]["sharded"] and ranks[0]["sharded"]
            whole = sum(want["params"][n].size for n in want["params"]
                        if n not in ranks[0]["sharded"])
            assert ranks[0]["local_numel"] == (total - whole) // world + whole
        else:
            assert not ranks[0]["sharded"] and ranks[0]["local_numel"] == total


def test_fsdp_with_grad_checkpoint_matches_without():
    """--grad-checkpoint under FSDP (the recompute all-gathers again
    through FSDP2's hooks): one step's loss and gradients, full and convs,
    against the step without remat."""
    state, batch = _start(2)
    by_rank = run_group(2, "fsdp_remat", state, batch)
    for none, full, convs in by_rank:
        for got in (full, convs):
            assert got["metrics"][0]["loss"] == pytest.approx(none["metrics"][0]["loss"],
                                                              rel=1e-6)
            for n, w in none["grads"].items():
                err = np.abs(got["grads"][n] - w).max()
                assert err <= GRAD_TOL * np.abs(w).max() + 1e-7, (n, err)


# --------------------------------------------------------- against JAX


def test_fsdp_step_matches_jax_fsdp_train_step():
    """The port's 2-rank FSDP step against make_train_step with
    shard_state_fsdp on a 2-device mesh, the same weights and draws."""
    world, n = 2, 4
    audio = _audio(n, seed=13)
    model, jax_model, variables = _vqvae(5, 0.0, audio)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    labels = np.array([0, 1, 2, 0], np.int32)
    batch = {"samples": audio[..., 0], "label": labels}
    key = jax.random.key(31)
    draws = {k: v.numpy() for k, v in _vqvae_draws(key, n, T // model.encoder.downsample_rate)
             .items() if k in ("ts", "epsilon", "jitter_nums")}

    mesh = create_mesh(num_devices=world)
    params = variables["params"]
    tx = jax_build_optimizer(params, lr=1e-3)
    jstate = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        buffers={"vq": {"usage_count": jnp.asarray(state["vq.usage_count"])}},
                        opt_state=tx.init(params), emas={})
    jstate = shard_state_fsdp(mesh, jstate, tx)
    jax_step = jax.jit(jax_steps.make_train_step(
        jax_loops.VQVAETrainLoop.build_loss_fn(_loop_stub(jax_model)), tx, {},
        vq_rule=jax_steps.VQUpdateRule(dead_rate=4, revive=False), jit=False))
    _, want = jax_step(jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}),
                       key)
    losses = run_group(world, "jax_fsdp_step", state, batch, draws)
    for loss in losses:
        np.testing.assert_allclose(loss, float(want["loss"]), rtol=1e-5)


# ------------------------------------------------------------ the loops


def _log(out):
    with open(os.path.join(out, "train_log.txt")) as f:
        return [line for line in f.read().splitlines()]


def _unrated(lines):
    """Log lines without samples/s (a wall-clock rate)."""
    return [re.sub(r" samples_per_sec=\S+", "", line) for line in lines]


def _losses(out):
    return {int(line.split(":")[0][5:]): float(line.split("loss=")[1].split()[0])
            for line in _log(out) if line.startswith("step ")}


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k.startswith(("params/", "buffers/"))}


@pytest.mark.parametrize("fmt", ["npz", "dcp"])
def test_saves_resume_across_dp_and_fsdp(fmt, tmp_path):
    """2 ranks: a DP run and an FSDP run of 2 steps; the DP run's directory
    resumed under FSDP and the FSDP run's under DP, one more step each; an
    uninterrupted 3-step DP run. Both resumed runs continue the log at
    step 3, with the same loss."""
    common = ["--batch-size", "2", "--checkpoint-format", fmt, "--save-interval", "2"]
    runs = [["dp", *common, "--max-steps", "2"],
            ["fsdp", *common, "--max-steps", "2", "--fsdp"],
            ["dp_then_fsdp", *common, "--max-steps", "1", "--fsdp", "--save-interval", "1"],
            ["fsdp_then_dp", *common, "--max-steps", "1", "--save-interval", "1"],
            ["straight", *common, "--max-steps", "3", "--save-interval", "3"]]
    run_group(2, "loop_runs", str(tmp_path), runs, {"dp_then_fsdp": "dp",
                                                    "fsdp_then_dp": "fsdp"})
    straight = _losses(tmp_path / "straight")
    for name in ("dp", "fsdp"):
        np.testing.assert_allclose([_losses(tmp_path / name)[s] for s in (1, 2)],
                                   [straight[s] for s in (1, 2)], rtol=1e-5)
    resumed = [_losses(tmp_path / name) for name in ("dp_then_fsdp", "fsdp_then_dp")]
    for name, got in zip(("dp_then_fsdp", "fsdp_then_dp"), resumed):
        assert sorted(got) == [1, 2, 3] and _log(tmp_path / name).count("# saved") == 2
    # Step 3 draws as the third step does; its batch is the first again (a
    # resumed loader starts a new epoch, as the JAX package's does).
    np.testing.assert_allclose(resumed[0][3], resumed[1][3], rtol=1e-5)
    if fmt == "npz":
        # The FSDP run's gathered npz against the DP run's.
        init = tiny_vqvae()
        init_like_flax(init, torch.Generator().manual_seed(0))  # the loops' seeded init
        start = params_to_jax(init)
        lr = 1e-4  # the CLIs' default
        for f, moved in (("model.npz", 0.5 * lr), ("model_ema_0.9.npz", 0.5 * 0.19 * lr)):
            got, want = _npz(tmp_path / "fsdp" / f), _npz(tmp_path / "dp" / f)
            assert got.keys() == want.keys()
            params = [k for k in want if k.startswith("params/")]
            # Zero-initialised output convs leave most leaves still at first.
            _close_after_steps({k: got[k] for k in params}, {k: want[k] for k in params},
                               start, 2, moved, still=lambda name: True, lr=lr)
            for k in want.keys() - set(params):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        opt = torch.load(tmp_path / "fsdp" / "opt.pt", weights_only=True)
        assert opt["count"] == 2 and len(opt["adamw"]["param_groups"]) == 1
    else:
        for name in ("dp", "fsdp", "straight"):
            assert sorted(os.listdir(tmp_path / name / "model.dcp"))[-1] == "model.json"
            assert not glob.glob(str(tmp_path / name / "*.npz"))
    for name in ("dp", "fsdp", "straight"):
        infos = glob.glob(str(tmp_path / name / "run_info_*.json"))
        assert len(infos) == 1
        with open(infos[0]) as f:
            assert json.load(f)["num_devices"] == 2


def _write_jax_opt_npz(run, **opt_kwargs):
    """Replace ``run``'s opt.pt (a run of the shallow VQ-VAE, no frozen
    leaves) with the opt.npz that the JAX package's npz loop writes for
    the same state: the optax state of its ``build_optimizer`` with
    ``opt_kwargs``, holding opt.pt's moments and count, through
    ``to_state_dict`` and ``msgpack_serialize`` as its ``save_opt_state``
    writes it."""
    from flax import serialization, traverse_util

    saved = torch.load(run / "opt.pt", weights_only=True)
    model = tiny_vqvae()
    trees = {}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.copy_(saved["adamw"]["state"][i][torch_key])
        trees[key] = traverse_util.unflatten_dict(
            {k[len("params/"):]: v for k, v in params_to_jax(model).items()
             if k.startswith("params/")}, sep="/")
    tx = jax_build_optimizer(trees["mu"], **opt_kwargs)
    state = serialization.to_state_dict(jax.tree.map(np.asarray, tx.init(trees["mu"])))
    found = []

    def fill(node):
        if isinstance(node, dict):
            if {"count", "mu", "nu"} <= node.keys():
                node.update(count=np.asarray(saved["count"], node["count"].dtype), **trees)
                found.append(node)
            for v in node.values():
                fill(v)

    fill(state)
    assert len(found) == 1
    with open(run / "opt.npz", "wb") as f:
        f.write(serialization.msgpack_serialize(state))
    os.remove(run / "opt.pt")


def test_a_jax_npz_run_directory_resumes_on_ranks(tmp_path, monkeypatch):
    """An npz run directory whose optimizer state is the JAX package's
    opt.npz (two steps, the clip and weight decay), resumed one step in
    this process at batch 4 and on 2 gloo ranks at batch 2, under DP and
    under FSDP: the ranks' step as the one-process step (which
    tests/test_torch_checkpoint_extras.py holds to the JAX package's
    resume), held as the module docstring says."""
    import torch_parallel_worker as worker

    monkeypatch.setattr(worker.loops, "create_data_loader", worker._short_data)
    monkeypatch.setattr(worker.loops.VQVAETrainLoop, "create_new_model",
                        lambda self: tiny_vqvae())
    monkeypatch.setattr(worker.ModelBase, "from_manifest",
                        classmethod(lambda cls, name, kwargs: tiny_vqvae()))
    opt = ["--grad-clip", "0.5", "--weight-decay", "0.01"]
    common = ["--device", "cpu", "--class-cond", "--ema-rate", "0.9", *opt]
    jax_run = tmp_path / "jax"
    train_vqvae.main(common + ["--output-dir", str(jax_run), "--batch-size", "4",
                               "--max-steps", "2", "--save-interval", "2", "tones"])
    _write_jax_opt_npz(jax_run, lr=1e-4, weight_decay=0.01, grad_clip=0.5)
    one = tmp_path / "one"
    shutil.copytree(jax_run, one)
    train_vqvae.main(common + ["--output-dir", str(one), "--batch-size", "4", "--max-steps",
                               "1", "--save-interval", "1", "tones"])
    resumed = ["--batch-size", "2", "--max-steps", "1", "--save-interval", "1", *opt]
    run_group(2, "loop_runs", str(tmp_path), [["jax_then_dp", *resumed],
                                              ["jax_then_fsdp", *resumed, "--fsdp"]],
              {"jax_then_dp": "jax", "jax_then_fsdp": "jax"})
    want = _losses(one)
    assert sorted(want) == [1, 2, 3]
    start = _npz(jax_run / "model.npz")
    for name in ("jax_then_dp", "jax_then_fsdp"):
        got = _losses(tmp_path / name)
        assert sorted(got) == [1, 2, 3], name
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5, err_msg=name)
        for f, moved in (("model.npz", 0.5 * 1e-4), ("model_ema_0.9.npz", 0.5 * 0.1 * 1e-4)):
            g, w = _npz(tmp_path / name / f), _npz(one / f)
            params = [k for k in w if k.startswith("params/")]
            _close_after_steps({k: g[k] for k in params}, {k: w[k] for k in params}, start, 1,
                               moved, still=lambda leaf: True, lr=1e-4)
            for k in w.keys() - set(params):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name} {k}")
        saved = torch.load(tmp_path / name / "opt.pt", weights_only=True)
        assert saved["count"] == 3


def test_steps_per_dispatch_under_dp_is_the_k1_run(tmp_path):
    runs = [["k1", "--batch-size", "2", "--max-steps", "4", "--save-interval", "4"],
            ["k2", "--batch-size", "2", "--max-steps", "4", "--save-interval", "4",
             "--steps-per-dispatch", "2"]]
    run_group(2, "loop_runs", str(tmp_path), runs, {})
    assert _unrated(_log(tmp_path / "k2")) == _unrated(_log(tmp_path / "k1"))
    for f in ("model.npz", "model_ema_0.9.npz"):
        got, want = _npz(tmp_path / "k2" / f), _npz(tmp_path / "k1" / f)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_launched_world_size_one_is_the_plain_run(tmp_path, monkeypatch):
    """The same run without the launcher's environment (this process) and
    as a world of one gloo rank: the same log and the same bits."""
    import torch_parallel_worker as worker

    argv = ["--batch-size", "2", "--max-steps", "2", "--save-interval", "2"]
    run_group(1, "loop_runs", str(tmp_path), [["launched", *argv]], {})
    monkeypatch.setattr(worker.loops, "create_data_loader", worker._short_data)
    monkeypatch.setattr(worker.loops.VQVAETrainLoop, "create_new_model",
                        lambda self: tiny_vqvae())
    out = str(tmp_path / "plain")
    train_vqvae.main(["--device", "cpu", "--output-dir", out, "--class-cond", "--ema-rate",
                      "0.9", *argv, "tones"])
    assert _unrated(_log(out)) == _unrated(_log(tmp_path / "launched"))
    for f in ("model.npz", "model_ema_0.9.npz"):
        got, want = _npz(tmp_path / "launched" / f), _npz(os.path.join(out, f))
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with open(glob.glob(os.path.join(out, "run_info_*.json"))[0]) as f:
        assert json.load(f)["num_devices"] == 1


def test_six_train_clis_run_with_fsdp_and_dcp(tmp_path):
    run_group(2, "six_loops", str(tmp_path))
    for name in ("wavegrad", "diffusion", "classifier", "enc_pred", "add", "uncond"):
        out = tmp_path / name
        assert os.path.isdir(out / "model.dcp") and os.path.isdir(out / "opt.dcp"), name
        assert [line for line in _log(out) if line.startswith("step ")][0].startswith(
            "step 1: loss="), name
        assert _log(out)[-1] == "# saved", name


def test_torchrun_launches_two_ranks(tmp_path):
    """python -m torch.distributed.run --nproc-per-node 2 -m ...train_vqvae:
    one log, one run_info (num_devices 2), one set of checkpoints."""
    out = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(port),
         "-m", "vq_voice_swap_torch.train_vqvae", "tones", "--device", "cpu",
         "--base-channels", "2", "--batch-size", "1", "--max-steps", "1",
         "--save-interval", "1", "--dictionary-size", "8", "--output-dir", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(f for f in os.listdir(out) if not f.startswith("run_info")) == [
        "model.npz", "model_ema_0.9999.npz", "opt.pt", "train_log.txt"]
    infos = glob.glob(str(out / "run_info_*.json"))
    assert len(infos) == 1
    with open(infos[0]) as f:
        assert json.load(f)["num_devices"] == 2
    steps = [line for line in _log(out) if line.startswith("step ")]
    assert len(steps) == 1 and proc.stdout.count("step 1: loss=") == 1


def test_launch_environment_that_cannot_start_raises(monkeypatch, tmp_path):
    """The launcher's variables set, the rendezvous port taken: the port
    raises and does not train alone."""
    with socket.socket() as taken:
        taken.bind(("localhost", 0))
        taken.listen()
        port = taken.getsockname()[1]
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(port))
        with pytest.raises(RuntimeError, match="refusing to fall back"):
            init_distributed("cpu", timeout_s=5)
        with pytest.raises(RuntimeError, match="refusing to fall back"):
            train_vqvae.main(["--device", "cpu", "--output-dir", str(tmp_path / "run"),
                              "tones"])
    assert not os.path.exists(tmp_path / "run")


def test_a_rank_whose_device_is_missing_raises(monkeypatch):
    """Rank 1 of a launched run takes cuda:1: without CUDA, or on a host
    with one card, it raises rather than train elsewhere."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="rank 1 runs on cuda:1, but this host has 1"):
        rank_device("cuda")
    assert rank_device("cpu") == torch.device("cpu")
