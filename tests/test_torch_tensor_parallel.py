"""Tensor parallelism in the PyTorch port (``parallel/tensor.py``) on the
CPU, with real gloo ranks spawned from the test
(``tests/torch_parallel_worker.py``): one world of 4 ranks and one of 2,
each shared by several checks (module fixtures), so the spawns stay few.

- The placement rule: ``tp_placements`` at T = 2 and 4 against the JAX
  package's ``tp_shardings(create_mesh_2d(T))``, leaf by leaf, for a UNet
  VQ-VAE (UNet encoder, labels), a WaveGrad diffusion model, the
  classifier and the encoder-predictor; the composed FSDP placements at
  D = 2, T = 2 against ``fsdp_shardings`` on a 2 x 2 mesh.
- Forwards of the UNet and WaveGrad predictors (labels and cond) on model
  groups of 2 and 4 ranks against one process: within 1e-5.
- A VQ-VAE train step on a 2 x 2 grid, without and with FSDP, with a
  microbatch remainder, against the one-process step at the global batch:
  losses within 1e-5 relative, every leaf's gradient within 2e-4 of its
  largest entry (plus 1e-7), usage counts equal, parameters as
  tests/test_torch_parallel.py holds them after whole steps, and the same
  on every rank.
- The leaves that model groups hold whole stay bitwise equal on every
  rank after a step whose ranks' gradients differ (each adds its own
  noise, as atomic sums round differently on the card), with and without
  FSDP.
- One step on a 2 x 2 grid against the JAX package's ``make_train_step``
  under ``shard_state_tp`` on a 2 x 2 mesh, the same weights and draws:
  the loss within 1e-5 relative, every leaf's gradient (read from AdamW's
  first moment) within 2e-4 of its largest entry, and the parameters
  after the step as the one-process check holds them.
- The loops: npz and dcp saves under TP resume at T = 1 and at T = 2; the
  npz leaves are the one-process run's; ``--steps-per-dispatch 2`` is the
  K = 1 run, ``--grad-checkpoint convs`` the run without it; the six
  train CLIs take one step at T = 2.
- The sampling CLIs on two ranks at T = 2, and ``sample_diffusion`` at
  D = 2 x T = 2 (its batch rows split over the data rows, a complete batch
  skipped), write the world-1 run's files, their float samples within
  1e-5 of the larger of 1 and the file's largest magnitude (the seeded
  diffusion model's samples reach hundreds, and its first DDPM step
  amplifies a convolution's rounding).
- The refusals, a ValueError as in the JAX package: --tensor-parallel 2
  without the launcher (all nine CLIs), and a T that does not divide the
  world.
"""

import glob
import json
import os
import shutil
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from test_torch_parallel import GRAD_TOL, _close_after_steps, _log, _losses, _npz, _one_process
from test_torch_parallel import _start, _unrated
from test_torch_train import _audio, _loop_stub, _torch_grads, _vqvae, _vqvae_draws
from torch_parallel_worker import OPT, T, run_group, tiny_vqvae
from vq_voice_swap_tpu.parallel import (MODEL_AXIS, create_mesh_2d, fsdp_shardings, shard_batch,
                                        shard_state_tp, tp_shardings)
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_tpu.train import steps as jax_steps
from vq_voice_swap_tpu.train.state import TrainState
from vq_voice_swap_tpu.train.state import build_optimizer as jax_build_optimizer
from vq_voice_swap_torch import (sample_diffusion, sample_vqvae, sample_vqvae_uncond,
                                 train_classifier, train_diffusion, train_enc_pred, train_vqvae,
                                 train_vqvae_add, train_vqvae_uncond)
from vq_voice_swap_torch.classifier_model import ClassifierModel, EncoderPredictorModel
from vq_voice_swap_torch.convert import params_to_jax, torch_key
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.parallel import fsdp_placements, tp_placements
from vq_voice_swap_torch.parallel.tensor import _jax_axes
from vq_voice_swap_torch.vq_vae import VQVAE

TOL = dict(rtol=1e-5, atol=1e-5)
CLIP = 2048  # samples of the conversion CLIs' input clip


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ------------------------------------------------------- the placement rule


def _models():
    """The models whose placements are held to the JAX rule."""
    return {
        "vqvae": VQVAE(pred_name="unet", base_channels=6, enc_name="unet", cond_mult=4,
                       dictionary_size=8, num_labels=3),
        "wavegrad": DiffusionModel(pred_name="wavegrad", base_channels=4, num_labels=6),
        "classifier": ClassifierModel(num_labels=6, base_channels=6),
        "enc_pred": EncoderPredictorModel(base_channels=6, downsample_rate=256, num_latents=8),
    }


def _jax_specs(model, shardings_of):
    """{port parameter name: its PartitionSpec} from the JAX rule on a tree
    of the model's parameters in the JAX layout."""
    tree = {}
    for key, arr in params_to_jax(model).items():
        if key.startswith("params/"):
            node = tree
            *parents, leaf = key.split("/")[1:]
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.zeros(arr.shape)
    flat = jax.tree_util.tree_flatten_with_path(shardings_of(tree))[0]
    return {torch_key("params/" + "/".join(getattr(k, "key", str(k)) for k in path)): s.spec
            for path, s in flat}


def _port_axis(model, name: str, spec, mesh_axis: str):
    """The port axis of the JAX axis that ``spec`` shards over ``mesh_axis``."""
    jax_axis = next((i for i, d in enumerate(spec) if d == mesh_axis), None)
    if jax_axis is None:
        return None
    mod_name, _, leaf = name.rpartition(".")
    module = model.get_submodule(mod_name)
    return _jax_axes(module, leaf, model.get_parameter(name).ndim)[jax_axis]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", ["vqvae", "wavegrad", "classifier", "enc_pred"])
def test_tp_placements_match_jax_tp_shardings(kind, size):
    model = _models()[kind]
    placements = tp_placements(model, size)
    specs = _jax_specs(model, lambda tree: tp_shardings(create_mesh_2d(size), tree))
    assert sorted(specs) == sorted(placements)
    for name, spec in specs.items():
        assert placements[name] == _port_axis(model, name, spec, MODEL_AXIS), (name, spec)
    cut = [n for n, a in placements.items() if a is not None]
    assert len(cut) > len(placements) // 2
    # An embedding table is cut along its features, the port's axis 1.
    tables = [n for n in placements if n.endswith(("class_embed.weight", "label_emb.weight"))]
    assert all(placements[n] == 1 for n in tables) and (tables or kind in ("classifier",
                                                                           "enc_pred"))
    assert placements.get("vq.dictionary", "none") in (None, "none")


@pytest.mark.parametrize("kind", ["vqvae", "wavegrad", "classifier", "enc_pred"])
def test_composed_fsdp_placements_match_jax(kind):
    """D = 2, T = 2: the model axis takes the output features, FSDP the
    largest other axis that 2 divides."""
    model = _models()[kind]
    data, cut = fsdp_placements(model, 2, 2), tp_placements(model, 2)
    specs = _jax_specs(model, lambda tree: fsdp_shardings(create_mesh_2d(2, num_devices=4), tree))
    assert sorted(specs) == sorted(data)
    both = 0
    for name, spec in specs.items():
        assert cut[name] == _port_axis(model, name, spec, MODEL_AXIS), (name, spec)
        assert data[name] == _port_axis(model, name, spec, "data"), (name, spec)
        both += cut[name] is not None and data[name] is not None
    assert both > 0
    assert fsdp_placements(model, 2) == fsdp_placements(model, 2, 1)


# ------------------------------------------------- the world of four ranks


def _seeded(model, seed: int):
    """The loops' seeded init plus noise on every leaf (no zero branch)."""
    init_like_flax(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _forward_case(kind: str):
    model = _seeded(worker.tp_predictor(kind), 7)
    rng = np.random.RandomState(3)
    n, t = 2, 256
    cond_len, cond_ch = (t // 2, 8) if kind == "unet" else (t // 64, 8)
    inputs = dict(x=rng.randn(n, t, 1).astype(np.float32),
                  ts=rng.rand(n).astype(np.float32),
                  cond=rng.randn(n, cond_len, cond_ch).astype(np.float32),
                  labels=np.array([0, 2]))
    with torch.no_grad():
        want = model(**{k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}, inputs, want


def _write_wav(path: str, n: int = CLIP) -> None:
    rng = np.random.RandomState(4)
    samples = 0.3 * np.sin(np.arange(n) * 0.05) + 0.01 * rng.randn(n)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((samples * (2**15 - 1)).astype("<i2").tobytes())


def _checkpoints(root) -> dict:
    """Seeded shallow VQ-VAE and unconditional diffusion checkpoints, and
    the conversion CLIs' input clip."""
    paths = {"vqvae": str(root / "vqvae.npz"), "diffusion": str(root / "diffusion.npz"),
             "clip": str(root / "in.wav")}
    _seeded(tiny_vqvae(), 21).save(paths["vqvae"])
    _seeded(worker.tiny_diffusion(), 22).save(paths["diffusion"])
    _write_wav(paths["clip"])
    return paths


def _vqvae_argv(paths, out: str, extra=()):
    return ["--label", "1", "--input-file", paths["clip"], "--seconds", "1", "--sample-steps",
            "2", *extra, paths["vqvae"], out]


def _sampling(paths, out: str, argv=()):
    """The three sampling CLIs' runs into ``out`` (argv beside each)."""
    os.makedirs(out, exist_ok=True)
    diffusion = ["--checkpoint-path", paths["diffusion"], "--sample-steps", "2",
                 "--fuse-levels", "2", "--num-samples", "3", "--batch-size", "2",
                 "--sample-path", os.path.join(out, "diffusion")]
    return [["sample_vqvae", _vqvae_argv(paths, os.path.join(out, "swap.wav"), argv)],
            ["sample_vqvae_uncond", _vqvae_argv(paths, os.path.join(out, "uncond.wav"),
                                                ["--guide-label-scale", "1", *argv])],
            ["sample_diffusion", diffusion + list(argv)]]


# Train-loop runs on the 2 x 2 grid (run directory first; loop_runs adds
# the tiny VQ-VAE, --class-cond and one EMA of rate 0.9).
TP2 = ["--tensor-parallel", "2", "--batch-size", "2"]
DCP = ["--checkpoint-format", "dcp"]
LOOP_RUNS = [
    ["tp", *TP2, "--max-steps", "2", "--save-interval", "2"],
    ["tp_dcp", *TP2, *DCP, "--max-steps", "2", "--save-interval", "2"],
    ["tp_fsdp_dcp", *TP2, *DCP, "--fsdp", "--max-steps", "2", "--save-interval", "2"],
    ["k2", *TP2, "--max-steps", "2", "--save-interval", "2", "--steps-per-dispatch", "2"],
    ["tp_remat", *TP2, "--max-steps", "2", "--save-interval", "2", "--grad-checkpoint=convs"],
    # Resumed one step: at T = 1 the four ranks are four data rows of batch 1.
    ["tp_then_1", "--batch-size", "1", "--max-steps", "1", "--save-interval", "1"],
    ["tp_then_2", *TP2, "--max-steps", "1", "--save-interval", "1"],
    ["dcp_then_1", "--batch-size", "1", *DCP, "--max-steps", "1", "--save-interval", "1"],
    ["dcp_then_2", *TP2, *DCP, "--fsdp", "--max-steps", "1", "--save-interval", "1"],
]
LOOP_COPIES = {"tp_then_1": "tp", "tp_then_2": "tp", "dcp_then_1": "tp_dcp",
               "dcp_then_2": "tp_fsdp_dcp"}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One spawned world of 4 gloo ranks running every 4-rank check:
    (inputs, each rank's results by check, the loops' root, checkpoints)."""
    root = tmp_path_factory.mktemp("tp4")
    forwards = {kind: _forward_case(kind) for kind in ("unet", "wavegrad")}
    state, batch = _start(2)  # 3 rows a data row, 2 data rows
    jax_case = _jax_case()
    paths = _checkpoints(root)
    parts = [
        ["tp_forwards", [2, 4], {k: v[0] for k, v in forwards.items()},
         {k: v[1] for k, v in forwards.items()}],
        ["tp_steps", 2, state, batch, 1],
        ["tp_jax_step", 2, *jax_case["args"]],
        ["tp_whole_agree", 2, state, batch],
        ["tp_refusal", 3],
        ["loop_runs", str(root / "loops"), LOOP_RUNS, LOOP_COPIES],
        ["sampling_runs", [_sampling(paths, str(root / "d2"), ["--tensor-parallel", "2"])[2],
                           ["sample_diffusion", ["--checkpoint-path", paths["diffusion"],
                                                 "--sample-steps", "2", "--fuse-levels", "2",
                                                 "--num-samples", "3", "--batch-size", "2",
                                                 "--tensor-parallel", "2", "--sample-path",
                                                 str(root / "d2_rerun")]],
                           ["sample_diffusion", _int8_argv(paths, str(root / "d2_int8"))
                            + ["--tensor-parallel", "2"]]]],
    ]
    os.makedirs(root / "d2_rerun")
    # A complete first batch (its file a marker) for the rerun to skip.
    for i in (0, 1):
        shutil.copy(paths["clip"], root / "d2_rerun" / f"sample_{i:06}.wav")
    by_rank = run_group(4, "tp_suite", parts, timeout=400)
    results = {name: [r[i] for r in by_rank] for i, (name, *_) in enumerate(parts)}
    return dict(results=results, forwards=forwards, state=state, batch=batch, jax=jax_case,
                root=root, paths=paths)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", ["unet", "wavegrad"])
def test_predictor_forwards_on_model_groups_match_one_process(world4, kind, size):
    want = world4["forwards"][kind][2]
    for got in world4["results"]["tp_forwards"]:
        np.testing.assert_allclose(got[size][kind], want, **TOL)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_step_on_a_2x2_grid_matches_one_process_at_the_global_batch(world4, fsdp):
    state, batch = world4["state"], world4["batch"]
    want = _one_process(state, batch, 1, 2)
    # Codes died in the step and were revived.
    assert want["metrics"][0]["codebook_used"] < len(want["usage"])
    ranks = [r[int(fsdp)] for r in world4["results"]["tp_steps"]]
    for got in ranks:
        g, w = got["metrics"][0], want["metrics"][0]
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
        _close_after_steps(got["params"], want["params"], state, 1, 0.5 * OPT["lr"])
        _close_after_steps(got["ema"], want["ema"], state, 1, 0.5 * 0.1 * OPT["lr"])
    for got in ranks[1:]:
        for k in ("params", "ema"):
            for n, v in got[k].items():
                np.testing.assert_array_equal(v, ranks[0][k][n], err_msg=f"{k} {n}")
    # Stored cut: each rank holds half of every cut leaf (a quarter under
    # FSDP where it also shards over the data rows).
    cut = set(ranks[0]["cut"])
    assert "vq.dictionary" not in cut and len(cut) > len(want["params"]) // 2
    total = sum(v.size for v in want["params"].values())
    whole = sum(v.size for n, v in want["params"].items() if n not in cut)
    if not fsdp:
        assert ranks[0]["local_numel"] == (total - whole) // 2 + whole
    else:
        assert ranks[0]["local_numel"] < (total - whole) // 2 + whole


def _jax_case():
    """A 4-row batch, the shallow VQ-VAE's weights and JAX draws; the JAX
    step's loss, parameters and AdamW first moments under shard_state_tp on
    a 2 x 2 mesh, the trees in the port's layout."""
    n = 4
    audio = _audio(n, seed=14)
    model, jax_model, variables = _vqvae(6, 0.0, audio)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    batch = {"samples": audio[..., 0], "label": np.array([0, 1, 2, 0], np.int32)}
    key = jax.random.key(37)
    draws = {k: v.numpy() for k, v in _vqvae_draws(key, n, T // model.encoder.downsample_rate)
             .items() if k in ("ts", "epsilon", "jitter_nums")}
    mesh = create_mesh_2d(2, num_devices=4)
    params = variables["params"]
    tx = jax_build_optimizer(params, lr=1e-3)
    jstate = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                        buffers={"vq": {"usage_count": jnp.asarray(state["vq.usage_count"])}},
                        opt_state=tx.init(params), emas={})
    jstate = shard_state_tp(mesh, jstate, tx)
    jax_step = jax.jit(jax_steps.make_train_step(
        jax_loops.VQVAETrainLoop.build_loss_fn(_loop_stub(jax_model)), tx, {},
        vq_rule=jax_steps.VQUpdateRule(dead_rate=4, revive=False), jit=False))
    new, want = jax_step(jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in
                                                    batch.items()}), key)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    port = lambda tree: {k: v.numpy() for k, v in _torch_grads(jax.device_get(tree)).items()}
    return dict(args=[state, batch, draws], loss=float(want["loss"]),
                params=port(new.params), mu=port(adam.mu))


def test_step_on_a_2x2_grid_matches_jax_tp_train_step(world4):
    """The loss, every leaf's gradient (AdamW's first moment after one
    step is 0.1 of it in both) within GRAD_TOL of its largest entry, and
    the parameters after the step, held as the one-process check holds
    them."""
    want = world4["jax"]
    start = world4["jax"]["args"][0]
    for got in world4["results"]["tp_jax_step"]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["exp_avg"]) == set(want["mu"])
        for n, w in want["mu"].items():
            err = np.abs(got["exp_avg"][n] - w).max() / 0.1
            assert err <= GRAD_TOL * np.abs(w / 0.1).max() + 1e-7, (n, err)
        np.testing.assert_allclose(got["params"]["vq.dictionary"],
                                   want["params"]["vq.dictionary"], rtol=1e-5, atol=1e-6)
        _close_after_steps(got["params"], want["params"], start, 1, 0.5 * 1e-3, lr=1e-3)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_whole_leaves_agree_over_model_groups_whose_gradients_differ(world4, fsdp):
    """Each rank's own noise on its gradients before the reduction: the
    leaves that model groups hold whole (the dictionary, the 1-channel
    output convs) and their EMA copies are still bitwise equal on every
    rank after the step."""
    ranks = [r[int(fsdp)] for r in world4["results"]["tp_whole_agree"]]
    assert "vq.dictionary" in ranks[0]["params"]
    for got in ranks[1:]:
        for k in ("params", "ema"):
            assert set(got[k]) == set(ranks[0][k])
            for n, v in got[k].items():
                np.testing.assert_array_equal(v, ranks[0][k][n], err_msg=f"{k} {n}")


def test_a_model_size_that_does_not_divide_the_world_is_refused(world4):
    for message in world4["results"]["tp_refusal"]:
        assert message.startswith("--tensor-parallel 3 needs a launched world that 3 divides")
        assert message.endswith("got a world of 4")


def test_saves_under_tp_resume_at_t1_and_t2(world4):
    """npz and dcp (dcp also under --fsdp) saves of 2 steps on the 2 x 2
    grid, resumed one step at T = 1 (four data rows of batch 1) and at
    T = 2: the dcp runs' losses are the npz run's, and the four resumed
    third steps log the same loss."""
    root = world4["root"] / "loops"
    for name in ("tp_dcp", "tp_fsdp_dcp"):
        np.testing.assert_allclose([_losses(root / name)[s] for s in (1, 2)],
                                   [_losses(root / "tp")[s] for s in (1, 2)], rtol=1e-5,
                                   err_msg=name)
    resumed = {name: _losses(root / name) for name in LOOP_COPIES}
    for name, got in resumed.items():
        assert sorted(got) == [1, 2, 3] and _log(root / name).count("# saved") == 2, name
    third = [got[3] for got in resumed.values()]
    np.testing.assert_allclose(third, [third[0]] * len(third), rtol=1e-5)
    for name in ("tp_dcp", "tp_fsdp_dcp", "dcp_then_1", "dcp_then_2"):
        assert sorted(os.listdir(root / name / "model.dcp"))[-1] == "model.json", name
        assert not glob.glob(str(root / name / "*.npz")), name
    for name, size in (("tp", 2), ("tp_then_1", 1)):
        # tp_then_1 also holds the run_info of the run it resumes.
        with open(sorted(glob.glob(str(root / name / "run_info_*.json")))[-1]) as f:
            info = json.load(f)
        assert (info["num_devices"], info["tensor_parallel"]) == (4, size), name
        assert info["steps_per_dispatch_route"] == "eager"


def test_tp_npz_is_the_one_process_run(world4, tmp_path, monkeypatch):
    """The 2 x 2 grid's gathered npz against the one-process run at the
    global batch (4), held as tests/test_torch_parallel.py holds FSDP's."""
    monkeypatch.setattr(worker.loops, "create_data_loader", worker._short_data)
    monkeypatch.setattr(worker.loops.VQVAETrainLoop, "create_new_model",
                        lambda self: tiny_vqvae())
    out = str(tmp_path / "one")
    train_vqvae.main(["--device", "cpu", "--output-dir", out, "--class-cond", "--ema-rate",
                      "0.9", "--batch-size", "4", "--max-steps", "2", "--save-interval", "2",
                      "tones"])
    tp = world4["root"] / "loops" / "tp"
    np.testing.assert_allclose(list(_losses(tp).values()), list(_losses(out).values()),
                               rtol=1e-5)
    init = tiny_vqvae()
    init_like_flax(init, torch.Generator().manual_seed(0))  # the loops' seeded init
    start = params_to_jax(init)
    lr = 1e-4
    for f, moved in (("model.npz", 0.5 * lr), ("model_ema_0.9.npz", 0.5 * 0.19 * lr)):
        got, want = _npz(tp / f), _npz(os.path.join(out, f))
        assert got.keys() == want.keys()
        params = [k for k in want if k.startswith("params/")]
        _close_after_steps({k: got[k] for k in params}, {k: want[k] for k in params},
                           start, 2, moved, still=lambda name: True, lr=lr)
        for k in want.keys() - set(params):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    opt = torch.load(tp / "opt.pt", weights_only=True)
    want_opt = torch.load(os.path.join(out, "opt.pt"), weights_only=True)
    assert opt["count"] == 2
    for i, st in want_opt["adamw"]["state"].items():
        assert opt["adamw"]["state"][i]["exp_avg"].shape == st["exp_avg"].shape


def test_steps_per_dispatch_under_tp_is_the_k1_run(world4):
    root = world4["root"] / "loops"
    assert _unrated(_log(root / "k2")) == _unrated(_log(root / "tp"))
    for f in ("model.npz", "model_ema_0.9.npz"):
        got, want = _npz(root / "k2" / f), _npz(root / "tp" / f)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_grad_checkpoint_under_tp_is_the_plain_run(world4):
    """--grad-checkpoint convs on the 2 x 2 grid (the recompute gathers
    again): the run without it, losses within 1e-6 and the same leaves."""
    root = world4["root"] / "loops"
    got, want = _losses(root / "tp_remat"), _losses(root / "tp")
    assert sorted(got) == [1, 2]
    np.testing.assert_allclose([got[s] for s in (1, 2)], [want[s] for s in (1, 2)], rtol=1e-6)
    got = _npz(root / "tp_remat" / "model.npz")
    for k, v in _npz(root / "tp" / "model.npz").items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)


def _main_process_sampling(monkeypatch, runs):
    """The world-1 runs of ``runs`` in this process."""
    monkeypatch.setattr(ModelBase, "from_manifest", classmethod(worker.tiny_from_manifest))
    for name, argv in runs:
        module = __import__(f"vq_voice_swap_torch.{name}", fromlist=["main"])
        monkeypatch.setattr(module, "ChunkWriter", worker.RecordingWriter)
        module.main(["--device", "cpu", *argv])


def _wavs(directory) -> dict:
    return {os.path.basename(p): p for p in glob.glob(os.path.join(directory, "*.wav"))}


def _same_samples(got_path: str, want_path: str) -> None:
    """A file's float samples (``.npy``) within 1e-5 of the larger of 1
    and the largest magnitude of the world-1 run's."""
    got, want = np.load(got_path + ".npy"), np.load(want_path + ".npy")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=want_path)


def _same_files(got_dir, want_dir) -> None:
    """The same .wav names, each one's float samples as ``_same_samples``."""
    got, want = _wavs(got_dir), _wavs(want_dir)
    assert sorted(got) == sorted(want)
    for name, path in want.items():
        _same_samples(got[name], path)


def test_sample_diffusion_at_d2_t2_writes_the_world1_files(world4, tmp_path, monkeypatch):
    """Batch rows split over the two data rows; the rerun skips its
    complete first batch (agreed by every rank) and writes the second."""
    root = world4["root"]
    want = tmp_path / "want"
    _main_process_sampling(monkeypatch, [_sampling(world4["paths"], str(want))[2]])
    _same_files(root / "d2" / "diffusion", want / "diffusion")
    rerun = _wavs(root / "d2_rerun")
    assert sorted(rerun) == [f"sample_{i:06}.wav" for i in range(3)]
    for i in (0, 1):  # the markers, untouched
        with open(rerun[f"sample_{i:06}.wav"], "rb") as f, open(world4["paths"]["clip"],
                                                                "rb") as g:
            assert f.read() == g.read()
    _same_samples(rerun["sample_000002.wav"], str(want / "diffusion" / "sample_000002.wav"))


def _int8_argv(paths, out: str):
    """int8 activations at both levels of the shallow UNet (64000 and 32000
    samples), a batch of 2 that the two data rows would divide."""
    return ["--checkpoint-path", paths["diffusion"], "--sample-steps", "2", "--num-samples",
            "2", "--batch-size", "2", "--act-int8", "32000", "--sample-path", out]


def test_sample_diffusion_act_int8_at_d2_t2_writes_the_world1_files(world4, tmp_path,
                                                                     monkeypatch):
    """With --act-int8 every data row runs the whole batch (the amax spans
    it), so the files are the one-process run's."""
    want = tmp_path / "want"
    _main_process_sampling(monkeypatch, [["sample_diffusion", _int8_argv(world4["paths"],
                                                                         str(want))]])
    _same_files(world4["root"] / "d2_int8", want)


# ---------------------------------------------------- the world of two ranks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawned world of 2 gloo ranks: the sampling CLIs at T = 2, the
    six train CLIs one step at T = 2, and T = 4 refused."""
    root = tmp_path_factory.mktemp("tp2")
    paths = _checkpoints(root)
    parts = [["sampling_runs", _sampling(paths, str(root / "t2"), ["--tensor-parallel", "2"])],
             ["six_loops", str(root / "six"), ("--tensor-parallel", "2")],
             ["tp_refusal", 4]]
    by_rank = run_group(2, "tp_suite", parts, timeout=400)
    return dict(results={name: [r[i] for r in by_rank] for i, (name, *_) in enumerate(parts)},
                root=root, paths=paths)


@pytest.mark.parametrize("cli", ["sample_vqvae", "sample_vqvae_uncond", "sample_diffusion"])
def test_sampling_clis_on_two_ranks_write_the_world1_outputs(world2, cli, tmp_path, monkeypatch):
    want = tmp_path / "want"
    runs = {name: argv for name, argv in _sampling(world2["paths"], str(want))}
    _main_process_sampling(monkeypatch, [[cli, runs[cli]]])
    got = world2["root"] / "t2"
    if cli == "sample_diffusion":
        _same_files(got / "diffusion", want / "diffusion")
    else:
        name = "swap.wav" if cli == "sample_vqvae" else "uncond.wav"
        _same_samples(str(got / name), str(want / name))
        assert np.load(str(got / name) + ".npy").shape == (CLIP,)


def test_six_train_clis_take_a_step_at_t2(world2):
    root = world2["root"] / "six"
    for name in ("wavegrad", "diffusion", "classifier", "enc_pred", "add", "uncond"):
        assert os.path.isdir(root / name / "model.dcp"), name
        steps = [line for line in _log(root / name) if line.startswith("step ")]
        assert len(steps) == 1 and steps[0].startswith("step 1: loss="), name
        assert np.isfinite(float(steps[0].split("loss=")[1].split()[0])), name
        with open(glob.glob(str(root / name / "run_info_*.json"))[0]) as f:
            assert json.load(f)["tensor_parallel"] == 2, name
    assert os.path.exists(root / "vqvae" / "model.npz")


def test_a_model_size_above_the_world_is_refused(world2):
    for message in world2["results"]["tp_refusal"]:
        assert "--tensor-parallel 4 needs a launched world that 4 divides" in message


# ----------------------------------------------------------- without launch


@pytest.mark.parametrize("cli", [train_vqvae, train_diffusion, train_classifier, train_enc_pred,
                                 train_vqvae_add, train_vqvae_uncond, sample_vqvae,
                                 sample_vqvae_uncond, sample_diffusion],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tensor_parallel_without_the_launcher_is_refused(cli, tmp_path):
    out = tmp_path / "out"
    if cli.__name__.rsplit(".", 1)[-1].startswith("train"):
        argv = ["--output-dir", str(out), "--vq-vae-path", "x.npz", "tones"] if (
            cli is train_enc_pred) else ["--output-dir", str(out), "tones"]
    elif cli is sample_diffusion:
        argv = ["--sample-path", str(out)]
    else:
        argv = ["--label", "0", "--input-file", "in.wav", "model.npz", str(out)]
    with pytest.raises(ValueError, match="--tensor-parallel 2 needs a launched world that 2 "
                                         "divides .* got a world of 1"):
        cli.main(["--device", "cpu", "--tensor-parallel", "2", *argv])
    assert not os.path.exists(out)
