"""The port's checkpoint extras on the CPU against the JAX package: its own
flax-msgpack reader against ``flax.serialization.msgpack_restore``; a JAX
npz run directory (``opt.npz``) trained two steps by the JAX loop and
resumed one step in each package (a VQ-VAE with the LR anneal, the clip
and weight decay; the add-classes run, whose frozen leaves have no
moments); and a released-reference ``.pt`` built here, loaded by the port
(``ModelBase.load``, ``convert_checkpoint``) and by the JAX package
(``load_torch_checkpoint``).

The reference key layout is read off the JAX package's mapper: it is run
on a state_dict that answers every lookup with a marker array, and each
flax path it writes is traced back to the torch key whose marker it holds.

The models keep their classes and kwargs with a shallow UNet (two levels
of one block) built by both packages' factories, so the JAX compiles stay
small. Tolerances: forwards within 1e-5 of the output's scale; a resumed
step as tests/test_torch_train.py holds whole steps (the loss within 1e-5
relative of the JAX log's five decimals, every parameter within twice the
step's learning rate of the JAX one and 99% of each leaf whose gradient
is resolved, at least 1e-4 of the largest, within 1% of the learning
rate), the step's gradient (read off JAX's moments) within 2e-4 of each
leaf's largest entry plus 1e-6 of the largest gradient, and Adam's moments
within 1e-3 of each leaf's largest entry plus 1e-6 of the largest.
"""

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

import vq_voice_swap_tpu.convert.torch_import as jax_torch_import
import vq_voice_swap_tpu.diffusion_model as jax_diffusion_model
import vq_voice_swap_tpu.vq_vae as jax_vq_vae
from vq_voice_swap_tpu.model_base import ModelBase as JaxModelBase
from vq_voice_swap_tpu.models.unet import UNetEncoder as JaxUNetEncoder
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxUNetPredictor
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_torch import convert_checkpoint
from vq_voice_swap_torch import diffusion_model as port_diffusion_model
from vq_voice_swap_torch import vq_vae as port_vq_vae
from vq_voice_swap_torch.classifier_model import ClassifierModel
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.convert.flax_msgpack import msgpack_restore
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor
from vq_voice_swap_torch.train import VQVAEAddClassesTrainLoop, VQVAETrainLoop
from vq_voice_swap_torch.vq_vae import VQVAE

SHALLOW = dict(channel_mult=(1, 2), depth_mult=1)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def shallow_unets(monkeypatch):
    """Both packages' model factories build a shallow UNet predictor and
    UNet encoder with the kwargs they are given."""
    jax_pred, jax_enc = jax_diffusion_model.make_predictor, jax_vq_vae.make_encoder
    port_pred, port_enc = port_diffusion_model.make_predictor, port_vq_vae.make_encoder

    def jax_predictor(*args, **kwargs):
        m = jax_pred(*args, **kwargs)
        return (m.clone(middle_dilations=(4,), **SHALLOW)
                if isinstance(m, JaxUNetPredictor) else m)

    def jax_encoder(*args, **kwargs):
        m = jax_enc(*args, **kwargs)
        return m.clone(**SHALLOW) if isinstance(m, JaxUNetEncoder) else m

    def port_predictor(pred_name, **kw):
        if pred_name != "unet":
            return port_pred(pred_name, **kw)
        return UNetPredictor(base_channels=kw["base_channels"],
                             cond_channels=kw.get("cond_channels"),
                             num_labels=kw.get("num_labels"), dtype=kw.get("dtype"),
                             remat=kw.get("remat"), middle_dilations=(4,), **SHALLOW)

    def port_encoder(enc_name, **kw):
        if enc_name != "unet":
            return port_enc(enc_name, **kw)
        return UNetEncoder(base_channels=kw["base_channels"],
                           out_channels=kw["base_channels"] * kw["cond_mult"],
                           dtype=kw.get("dtype"), remat=kw.get("remat"), **SHALLOW)

    monkeypatch.setattr(jax_diffusion_model, "make_predictor", jax_predictor)
    monkeypatch.setattr(jax_vq_vae, "make_encoder", jax_encoder)
    monkeypatch.setattr(port_diffusion_model, "make_predictor", port_predictor)
    monkeypatch.setattr(port_vq_vae, "make_encoder", port_encoder)


# ------------------------------------------------------------ msgpack


def _assert_same_tree(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "dtype"):
        want = np.asarray(want)
        got = np.asarray(got)
        if want.dtype == jnp.bfloat16:  # numpy has no bfloat16: read as float32
            assert got.dtype == np.float32, path
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_msgpack_reader_matches_flax(monkeypatch):
    """Every type flax writes: maps and arrays of every size class,
    strings, binaries, integers of every width, floats, booleans, nil,
    ndarrays of several dtypes (bfloat16 too), numpy scalars, a complex,
    and an array above the chunk size (shrunk here) in flax's chunked
    form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40, -1, -32, -33, -128,
                 -129, -40000, -2**40],
        "floats": [0.5, -1e-30, 3.25e300],
        "strings": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ünïcode"],
        "bytes": [b"", b"x" * 300, b"y" * 70000],
        "flags": [True, False, None],
        "complex": complex(1.5, -2.0),
        "scalars": {"f": np.float32(3.5), "i": np.int64(-7)},
        "wide": {f"k{i}": i for i in range(40)},
        "long": list(range(20)),
        "arrays": {
            "f32": rng.randn(3, 4).astype(np.float32),
            "i32": rng.randint(-9, 9, (5,)).astype(np.int32),
            "bool": rng.rand(2, 3) > 0.5,
            "f16": rng.randn(4).astype(np.float16),
            "u8": np.arange(7, dtype=np.uint8),
            "i64": np.array([2**40, -3], np.int64),
            "scalar": np.array(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "bf16": jnp.asarray(rng.randn(6), jnp.bfloat16),
            "chunked": rng.randn(200).astype(np.float32),
        },
        "nested": {"a": {"b": {"c": np.ones((2, 2), np.float32)}}, "empty": {}},
    }
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    want = serialization.msgpack_restore(data)
    _assert_same_tree(msgpack_restore(data), want)
    with pytest.raises(ValueError):
        msgpack_restore(data[:-1])


# ------------------------------------------------- a JAX run directory

JAX_RUN = ["--base-channels", "2", "--batch-size", "8", "--class-cond", "--ema-rate", "0.99",
           "--lr", "1e-3", "--revival-coeff", "0.1", "tones"]
VQVAE_FLAGS = ["--lr-final", "2e-4", "--lr-anneal-steps", "4", "--grad-clip", "0.5",
               "--weight-decay", "0.01"]


def _jax_train(loop_cls, argv):
    loop_cls(loop_cls.arg_parser().parse_args(argv)).loop()


def _jax_params(path):
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files if k.startswith("params/")})


def _jax_moments(path):
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    out = {}

    def find(t):
        if isinstance(t, dict):
            if {"count", "mu", "nu"} <= t.keys():
                out["count"] = int(t["count"])
                for key in ("mu", "nu"):
                    flat = traverse_util.flatten_dict(t[key], sep="/")
                    out[key] = params_from_jax({f"params/{k}": np.asarray(v)
                                                for k, v in flat.items() if np.size(v)})
            for v in t.values():
                find(v)

    find(tree)
    return out


def _step_draws(seed: int, step: int, n: int, t: int):
    """JAX VQVAE.losses's ts and epsilon for the loop's step rng."""
    rng = jax.random.fold_in(jax.random.key(seed), step)
    t_rng, n_rng, _, _, _ = jax.random.split(rng, 5)
    return dict(ts=torch.from_numpy(np.array(jax.random.uniform(t_rng, (n,)))),
                epsilon=torch.from_numpy(np.array(jax.random.normal(n_rng, (n, t, 1)))))


def _resume_both(tmp_path, jax_cls, port_cls, run, argv):
    """Resume the JAX run directory ``run`` one step in each package;
    returns (the port's loop after its step, its metrics, the JAX
    directory after its step, the port's moments before the step)."""
    jax_dir, port_dir = tmp_path / "jax_resumed", tmp_path / "port_resumed"
    shutil.copytree(run, jax_dir)
    shutil.copytree(run, port_dir)
    _jax_train(jax_cls, argv + ["--output-dir", str(jax_dir), "--max-steps", "1",
                                "--save-interval", "1"])
    loop = port_cls(port_cls.arg_parser().parse_args(
        argv + ["--device", "cpu", "--output-dir", str(port_dir)]))
    assert loop.resume and loop.total_steps == 2 and loop.optimizer.count == 2
    before = {n: {k: v.clone() for k, v in loop.optimizer.adamw.state[p].items()}
              for n, p in loop.model.named_parameters() if p in loop.optimizer.adamw.state}
    batch = loop.to_device(loop.prepare_batch(next(iter(loop.data_loader))))
    n, t = batch["samples"].shape
    metrics = loop.train_step(batch, None, draws=[_step_draws(0, 2, n, t)])
    return loop, metrics, jax_dir, before


def _assert_resumed_step(tmp_path, loop, metrics, jax_dir, before, run, frozen):
    # The moments the port read are opt.npz's, bit for bit.
    start_moments = _jax_moments(os.path.join(run, "opt.npz"))
    assert start_moments["count"] == 2
    trainable = {n for n, p in loop.model.named_parameters() if p.requires_grad}
    assert sorted(before) == sorted(trainable) == sorted(start_moments["mu"])
    for n, st in before.items():
        assert torch.equal(st["exp_avg"], start_moments["mu"][n]), n
        assert torch.equal(st["exp_avg_sq"], start_moments["nu"][n]), n
        assert st["step"].item() == 2.0

    with open(jax_dir / "train_log.txt") as f:
        logged = [ln for ln in f if ln.startswith("step 3:")]
    want_loss = float(re.search(r"loss=([-0-9.]+)", logged[0]).group(1))
    assert abs(metrics["loss"].item() - want_loss) <= 1e-5 * abs(want_loss) + 5e-6

    # JAX's gradient of the step, from its moments: mu3 = 0.9 mu2 + 0.1 g.
    after = _jax_moments(jax_dir / "opt.npz")
    want_grads = {n: (after["mu"][n] - 0.9 * start_moments["mu"][n]) / 0.1
                  for n in start_moments["mu"]}
    top = max(g.abs().max().item() for g in want_grads.values())
    for n, w in want_grads.items():
        err = (loop.model.get_parameter(n).grad - w).abs().max().item()
        assert err <= 2e-4 * w.abs().max().item() + 1e-6 * top, (n, err)

    start = _jax_params(os.path.join(run, "model.npz"))
    opt = loop.optimizer
    lr = opt.lr_at(2)
    # Adam turns a gradient at rounding-noise level (a conv bias feeding a
    # GroupNorm of one channel a group: a true gradient of 0) into steps of
    # about lr either way: such leaves are held to the first bound alone.
    resolved = {n for n, g in want_grads.items() if g.abs().max().item() >= 1e-4 * top}
    for got_module, want in ((loop.model, _jax_params(jax_dir / "model.npz")),
                             (loop.emas[0].model,
                              _jax_params(jax_dir / "model_ema_0.99.npz"))):
        held = 0
        for n, p in got_module.named_parameters():
            update, want_update = p.detach() - start[n], want[n] - start[n]
            diff = (update - want_update).abs()
            assert diff.max().item() <= 2 * lr, (n, diff.max().item())
            if frozen(n):
                assert not update.any() and not want_update.any(), n
            elif n in resolved:
                assert (diff <= 0.01 * lr).double().mean().item() >= 0.99, n
                held += 1
        assert held >= len(resolved) >= 1

    assert after["count"] == opt.count == 3
    tops = {k: max(v.abs().max().item() for v in after[k].values()) for k in ("mu", "nu")}
    for n, p in loop.model.named_parameters():
        if n not in trainable:
            assert p not in opt.adamw.state, n
            continue
        st = opt.adamw.state[p]
        for key, mine in (("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"])):
            w = after[key][n]
            err = (mine - w).abs().max().item()
            assert err <= 1e-3 * w.abs().max().item() + 1e-6 * tops[key], (n, key, err)


def test_a_jax_npz_run_directory_resumes_in_the_port(tmp_path, shallow_unets):
    """A VQ-VAE run of the JAX loop (LR anneal, clip, weight decay), two
    steps, then one resumed step in each package; then an add-classes run
    from its model (every leaf but the label table frozen: no moments)."""
    run = tmp_path / "jax_vqvae"
    argv = JAX_RUN + VQVAE_FLAGS
    _jax_train(jax_loops.VQVAETrainLoop, argv + ["--output-dir", str(run), "--max-steps", "2",
                                                 "--save-interval", "2"])
    assert os.path.exists(run / "opt.npz")
    loop, metrics, jax_dir, before = _resume_both(
        tmp_path / "vqvae", jax_loops.VQVAETrainLoop, VQVAETrainLoop, run, argv)
    _assert_resumed_step(tmp_path, loop, metrics, jax_dir, before, run, lambda n: False)

    added = tmp_path / "jax_added"
    add_argv = JAX_RUN + ["--pretrained-path", str(run / "model.npz")]
    _jax_train(jax_loops.VQVAEAddClassesTrainLoop,
               add_argv + ["--output-dir", str(added), "--max-steps", "2",
                           "--save-interval", "2"])
    loop, metrics, jax_dir, before = _resume_both(
        tmp_path / "added", jax_loops.VQVAEAddClassesTrainLoop, VQVAEAddClassesTrainLoop,
        added, add_argv)
    assert list(before) == ["predictor.class_embed.weight"]
    _assert_resumed_step(tmp_path, loop, metrics, jax_dir, before, added,
                         lambda n: n != "predictor.class_embed.weight")


# ------------------------------------------------ a reference .pt


class _Oracle:
    """A state_dict that has every key the JAX mapper asks for (the loop
    probes up to a bound; no reference dropout) and answers each read with
    a marker array of its own."""

    def __init__(self):
        self.read = {}

    def __contains__(self, key):
        if key.endswith(".post_cond.2.weight"):
            return False
        probe = re.search(r"\.(\d+)\.(pre_cond\.2|0\.ln)\.weight$", key)
        return probe is None or int(probe.group(1)) < 64

    def __getitem__(self, key):
        return self.read.setdefault(key, np.zeros((1, 1, 1), np.float32))

    def __iter__(self):
        return iter(self.read)


def _reference_layout(class_name, kwargs):
    """{torch key: flax path} as the JAX mapper reads a reference
    state_dict of this class."""
    mappers = []
    mapper = jax_torch_import._Mapper

    class Recording(mapper):
        def __init__(self, state_dict):
            super().__init__(state_dict)
            mappers.append(self)

    oracle = _Oracle()
    jax_torch_import._Mapper = Recording
    try:
        jax_torch_import.convert_state_dict(class_name, kwargs, oracle)
    finally:
        jax_torch_import._Mapper = mapper
    by_id = {id(v): k for k, v in oracle.read.items()}
    layout = {}
    for path, v in mappers[0].out.items():
        base = v if v.base is None else v.base
        layout[by_id[id(base)]] = path
    if "vq.usage_count" in oracle.read:
        layout["vq.usage_count"] = "vq/usage_count"
    return layout


def _reference_pt(model, class_name, kwargs, path):
    """Write ``model``'s weights as a reference checkpoint."""
    flat = params_to_jax(model)
    layout = _reference_layout(class_name, kwargs)
    sd = {}
    for tkey, fpath in layout.items():
        key = ("buffers/" if fpath == "vq/usage_count" else "params/") + fpath
        if key not in flat:
            continue  # a module this model does not have
        arr = flat[key]
        if fpath.endswith("kernel"):
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        sd[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
    covered = {("buffers/" if p == "vq/usage_count" else "params/") + p
               for k, p in layout.items() if k in sd}
    assert covered == set(flat), sorted(set(flat) - covered)[:5]
    torch.save({"kwargs": kwargs, "state_dict": sd}, path)
    return sd


def _seeded(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.copy_(noise / np.sqrt(p[0].numel()) if p.ndim >= 2 else 0.1 * noise)
    return model


@pytest.mark.parametrize("which", ["vqvae", "diffusion", "classifier"])
def test_a_reference_pt_loads_as_the_jax_package_loads_it(tmp_path, shallow_unets, which):
    """The port's ModelBase.load of a reference .pt: the forward of the JAX
    package's load_torch_checkpoint within 1e-5, and the weights of the npz
    that JAX's converter and the port's CLI write, bit for bit."""
    x = np.random.RandomState(1).randn(2, 256, 1).astype(np.float32)
    ts = np.array([0.2, 0.7], np.float32)
    labels = np.array([1, 0], np.int32)
    if which == "vqvae":
        ref_kwargs = dict(pred_name="unet", base_channels=2, enc_name="unet", cond_mult=4,
                          dictionary_size=8, num_labels=3, schedule_name="exp",
                          dropout=(0.1,), cond_channels=8)
        model = _seeded(VQVAE(**{k: v for k, v in ref_kwargs.items() if k != "cond_channels"}
                              | {"dropout": 0.1}), 3)
        model.vq.usage_count.copy_(torch.arange(8, dtype=torch.int32))
        cls = "VQVAE"
    elif which == "diffusion":
        ref_kwargs = dict(pred_name="unet", base_channels=2, num_labels=3, schedule_name="exp")
        model, cls = _seeded(DiffusionModel(**ref_kwargs), 4), "DiffusionModel"
    else:
        ref_kwargs = dict(num_labels=5, base_channels=2, channel_mult=(1, 2), depth_mult=1)
        model, cls = _seeded(ClassifierModel(**ref_kwargs), 5), "Classifier"
    pt = str(tmp_path / "ref.pt")
    _reference_pt(model, cls, ref_kwargs, pt)

    mine = ModelBase.load(pt, device="cpu")
    assert type(mine) is type(model)
    for k, v in model.state_dict().items():
        assert torch.equal(mine.state_dict()[k], v), k
    jax_model, jax_vars = JaxModelBase.load(pt)

    xt, tt, lt = torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(labels).long()
    with torch.no_grad():
        if which == "vqvae":
            enc = mine.encode_raw(xt)
            got = [enc, mine.predict_eps(xt, tt, cond=enc, labels=lt)]
            jenc = jax.jit(jax_model.encode_raw)(jax_vars, jnp.asarray(x))
            want = [jenc, jax.jit(lambda v: jax_model.predict_eps(
                v, jnp.asarray(x), jnp.asarray(ts), cond=jenc,
                labels=jnp.asarray(labels)))(jax_vars)]
            assert np.array_equal(mine.vq.usage_count.numpy(), np.arange(8))
        elif which == "diffusion":
            got = [mine.predict_eps(xt, tt, labels=lt)]
            want = [jax.jit(lambda v: jax_model.predict_eps(
                v, jnp.asarray(x), jnp.asarray(ts), labels=jnp.asarray(labels)))(jax_vars)]
        else:
            got = [mine(xt, tt)]
            want = [jax.jit(jax_model.logits)(jax_vars, jnp.asarray(x), jnp.asarray(ts))]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))

    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_torch_import.convert_torch_checkpoint(pt, jax_npz)
    convert_checkpoint.main([pt, port_npz])
    with np.load(jax_npz) as a, np.load(port_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_a_torch_file_that_fails_to_convert_shows_the_conversion_error(tmp_path):
    bad = tmp_path / "bad.pt"
    torch.save({"kwargs": {"pred_name": "unet", "base_channels": 2},
                "state_dict": {"predictor.nonsense.weight": torch.zeros(2)}}, bad)
    with pytest.raises(ValueError, match="unconverted torch parameters"):
        ModelBase.load(str(bad), device="cpu")
    not_a_checkpoint = tmp_path / "junk.npz"
    not_a_checkpoint.write_bytes(b"neither")
    with pytest.raises(Exception) as err:
        ModelBase.load(str(not_a_checkpoint), device="cpu")
    assert "unconverted" not in str(err.value)


class Payload:
    """An object a weights-only load does not build."""


def test_a_pickled_object_in_a_pt_is_refused(tmp_path):
    """The reference reader loads with weights_only=True: a file that needs
    arbitrary unpickling does not load."""
    path = tmp_path / "evil.pt"
    torch.save({"kwargs": {"pred_name": "unet", "base_channels": 2, "x": Payload()},
                "state_dict": {}}, path)
    with pytest.raises(Exception, match="[Ww]eights only|weights_only"):
        ModelBase.load(str(path), device="cpu")
