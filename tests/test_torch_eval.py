"""The port's eval pipeline against the JAX package's, on the CPU:
``stat_compare`` on the committed swap-quality statistics, ``stat_generate``
(the JAX CLI's ``main`` and the port's on the same WAV directory and sample
directory), the per-batch functions of ``eval_diffusion``, ``eval_vqvae``,
``voice_search_vqvae`` and ``swap_eval`` fed the JAX draws, and each CLI
end to end with ``--device cpu``.

Models are tiny (base 4, a three-level classifier stem, a 16-code VQ-VAE
with 3 labels). The port builds them with seeded numpy weights and saves
them; the JAX package loads the same ``.npz``, so no JAX init runs. The
per-batch parity runs at 2560 samples; the CLIs read 4 s windows.
Tolerances: 1e-6 relative for the committed Frechet number (another scipy
build), 1e-12 against the JAX ``frechet_distance`` on the same arrays,
1e-5 relative to the largest entry for the classifier statistics and the
eval losses (one f32 forward, sums in another order), 1e-3 for a 3-step
decode (the swap slice's decode rule). The covariance is held within 1e-5
of the features' largest second moment: np.cov subtracts the mean's
square from it, and the seeded classifier's features spread across clips
by only ~2-5% of their size, so its entries are ~1e3 times smaller than
the terms whose f32 rounding they carry.
"""

import glob
import importlib
import json
import os
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_util import randomize_params

from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.vq import vq_forward as jax_vq_forward
from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_torch import (
    eval_diffusion,
    eval_vqvae,
    stat_compare,
    stat_generate,
    swap_eval,
    voice_search_vqvae,
)
from vq_voice_swap_torch.classifier_model import ClassifierModel
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.vq_vae import VQVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QSWAP = os.path.join(REPO, "runs", "qswap")
CLASSIFIER = dict(num_labels=3, base_channels=4, channel_mult=(1, 2, 16), depth_mult=1)
DIFFUSION = dict(pred_name="unet", base_channels=4, num_labels=3)
VQVAE_KWARGS = dict(pred_name="unet", base_channels=4, enc_name="conv-mfcc-ulaw",
                    dictionary_size=16, num_labels=3)
SAMPLES = 2560  # a multiple of the VQ-VAE's rate (lcm of 256 and 320)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Forwards at base 4 are thousands of small ops: one intra-op thread
    runs them about as fast and leaves the cores to the other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seed_params(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded numpy weights for every parameter (buffers keep their values)."""
    flat = params_to_jax(module)
    tree = traverse_util.unflatten_dict(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}, sep="/")
    tree = traverse_util.flatten_dict(randomize_params(tree, seed), sep="/")
    module.load_state_dict(params_from_jax({f"params/{k}": v for k, v in tree.items()}),
                           strict=False)
    return module.eval()


def _write_wav(path, samples, rate=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * (2**15 - 1)).astype("<i2").tobytes())


def _clip(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    return 0.3 * np.sin(2 * np.pi * (200 + 100 * seed) * t) + 0.05 * rng.randn(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded checkpoints saved by the port, a 3-speaker WAV directory (one
    4.5 s file each: 9 windows), a directory of 8 generated-sample WAVs of
    3-5 s, and a 4 s input clip."""
    root = tmp_path_factory.mktemp("eval")
    paths = {}
    for name, model, seed in (("classifier", ClassifierModel(**CLASSIFIER), 1),
                              ("diffusion", DiffusionModel(**DIFFUSION), 2),
                              ("vqvae", VQVAE(**VQVAE_KWARGS), 3)):
        paths[name] = str(root / f"{name}.npz")
        _seed_params(model, seed).save(paths[name])
    paths["data"] = str(root / "ds")
    for i, spk in enumerate(("a", "b", "c")):
        _write_wav(os.path.join(paths["data"], spk, "1", "u.wav"), _clip(i, 72000))
    paths["samples"] = str(root / "samples")
    for i in range(8):
        _write_wav(os.path.join(paths["samples"], f"sample_{i:06}.wav"),
                   _clip(10 + i, 48000 + 4000 * i))
    paths["clip"] = str(root / "clip.wav")
    _write_wav(paths["clip"], _clip(20, 64000))
    return paths


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# ------------------------------------------------------------ stat_compare


def test_frechet_distance_reproduces_the_committed_swap_report():
    import stat_compare as jax_stat_compare

    with np.load(os.path.join(QSWAP, "stats_data10k.npz")) as a, \
            np.load(os.path.join(QSWAP, "stats_ddpm50_10k.npz")) as b:
        args = (a["mean"], a["cov"], b["mean"], b["cov"])
        got = stat_compare.frechet_distance(*args)
        want = jax_stat_compare.frechet_distance(*args)
    assert abs(got - 4494.857158667301) <= 1e-6 * 4494.857158667301  # report_swap10k.txt
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("name", ["data10k", "ddpm50_10k", "ddim10_10k", "dpmpp10_10k",
                                  "dpmpp5_10k"])
def test_class_score_from_the_committed_probs(name):
    with np.load(os.path.join(QSWAP, f"stats_{name}.npz")) as stats:
        got = stat_generate.class_score(stats["probs"])
        assert abs(got - float(stats["class_score"])) <= 1e-6 * float(stats["class_score"])


def test_stat_compare_cli(tmp_path, capsys):
    rng = np.random.RandomState(0)
    feats = [rng.randn(50, 6), rng.randn(40, 6) + 0.5]
    paths = []
    for i, f in enumerate(feats):
        paths.append(str(tmp_path / f"s{i}.npz"))
        np.savez(paths[-1], mean=f.mean(0), cov=np.cov(f, rowvar=False))
    stat_compare.main(paths)
    stat_compare.main([paths[0], paths[0]])
    lines = capsys.readouterr().out.split()
    want = stat_compare.frechet_distance(feats[0].mean(0), np.cov(feats[0], rowvar=False),
                                         feats[1].mean(0), np.cov(feats[1], rowvar=False))
    assert float(lines[0]) == pytest.approx(want, rel=1e-12) and want > 0.5
    assert abs(float(lines[1])) < 1e-6


# ----------------------------------------------------------- stat_generate


@pytest.mark.parametrize("source", ["--data-dir", "--sample-dir"])
def test_stat_generate_matches_the_jax_cli(ckpts, tmp_path, source, monkeypatch):
    src = ckpts["data"] if source == "--data-dir" else ckpts["samples"]
    argv = ["--checkpoint-path", ckpts["classifier"], source, src, "--num-samples", "8",
            "--batch-size", "4"]
    jax_out, port_out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_stat_generate = importlib.import_module("stat_generate")
    monkeypatch.setattr(sys, "argv", ["stat_generate.py", *argv, jax_out])
    jax_stat_generate.main()
    stat_generate.main([*argv, "--device", "cpu", port_out])
    with np.load(port_out) as got, np.load(jax_out) as want:
        assert set(got.files) == set(want.files) == {"mean", "cov", "probs", "class_score"}
        assert got["probs"].shape == (8, 3) and got["cov"].shape == (64, 64)
        for k in ("mean", "probs"):
            _close(got[k], want[k])
        second_moment = want["cov"] + np.outer(want["mean"], want["mean"])
        assert np.abs(got["cov"] - want["cov"]).max() <= 1e-5 * np.abs(second_moment).max()
        _close(got["class_score"], want["class_score"])


def test_classifier_features_and_head_make_the_logits(ckpts):
    model = ClassifierModel.load(ckpts["classifier"], device="cpu")
    x = torch.from_numpy(_clip(3, SAMPLES).astype(np.float32))[None, :, None]
    ts = torch.tensor([0.4])
    with torch.no_grad():
        feats = model.features(x, ts)
        assert feats.shape == (1, 64)
        torch.testing.assert_close(model.head_from_features(feats), model(x, ts),
                                   rtol=0, atol=0)


# ------------------------------------------------------------ the eval losses


def _batch(seed, n=2):
    x = (0.5 * np.tanh(np.random.RandomState(seed).randn(n, SAMPLES))).astype(np.float32)
    return x, np.asarray([2, 0][:n], np.int32)


def test_eval_diffusion_batch_matches_jax(ckpts):
    """The JAX CLI's eval_batch (``DiffusionModel.losses`` with the true
    labels); its t and noise, split from the same key, go to the port."""
    jmodel, jvars = JaxDiffusionModel.load(ckpts["diffusion"])
    x, labels = _batch(4)
    rng = jax.random.key(5)
    want_losses, want_ts = jax.jit(lambda v, r, s, lab: jmodel.losses(
        v, r, s[..., None], labels=lab))(jvars, rng, jnp.asarray(x), jnp.asarray(labels))
    loss_rng, _ = jax.random.split(rng)
    t_key, loss_rng = jax.random.split(loss_rng)
    ts = jax.random.uniform(t_key, (2,))
    _, n_key = jax.random.split(loss_rng)
    noise = jax.random.normal(n_key, (2, SAMPLES, 1))
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(want_ts))

    model = DiffusionModel.load(ckpts["diffusion"], device="cpu")
    with torch.no_grad():
        got_ts, got = eval_diffusion.eval_batch(
            model, torch.from_numpy(x), torch.from_numpy(labels).long(),
            ts=torch.from_numpy(np.array(ts)), noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(ts))
    _close(got.numpy(), want_losses)


def test_eval_vqvae_batch_matches_jax(ckpts):
    """The JAX CLI's eval_batch, composed as it composes it: encode_raw,
    vq_forward's passthrough, the eps-MSE with the true and with random
    labels, the conditioning's std."""
    jmodel, jvars = JaxVQVAE.load(ckpts["vqvae"])
    x, labels = _batch(6)
    t_rng, n_rng, l_rng = jax.random.split(jax.random.key(7), 3)
    ts = jax.random.uniform(t_rng, (2,))
    noise = jax.random.normal(n_rng, (2, SAMPLES, 1))
    rand_labels = jax.random.randint(l_rng, (2,), 0, 3)

    @jax.jit
    def jax_eval(v, samples, lab):
        s = samples[..., None]
        noised = jmodel.diffusion.sample_q(s, ts, epsilon=noise)
        cond = jax_vq_forward(v["params"]["vq"]["dictionary"],
                              jmodel.encode_raw(v, s))["passthrough"]

        def mses_for(lb):
            pred = jmodel.predict_eps(v, noised, ts, cond=cond, labels=lb)
            return jnp.mean(jnp.reshape(jnp.square(noise - pred), (2, -1)), axis=1)

        return mses_for(lab), mses_for(rand_labels), jnp.std(jnp.reshape(cond, (2, -1)), 1)

    want = jax_eval(jvars, jnp.asarray(x), jnp.asarray(labels))
    model = VQVAE.load(ckpts["vqvae"], device="cpu")
    with torch.no_grad():
        got = eval_vqvae.eval_batch(
            model, torch.from_numpy(x), torch.from_numpy(labels).long(),
            ts=torch.from_numpy(np.array(ts)), noise=torch.from_numpy(np.array(noise)),
            rand_labels=torch.from_numpy(np.array(rand_labels)).long())
    assert not np.array_equal(np.asarray(rand_labels), labels)
    for name, w in zip(("cond", "rand", "cond_std"), want):
        _close(got[name].numpy(), w)


def test_voice_search_losses_match_jax(ckpts):
    """The JAX CLI's per-label losses (every (label, t) pair, 2 seeds,
    batches of 4 with the tail padded) for the same noises."""
    jmodel, jvars = JaxVQVAE.load(ckpts["vqvae"])
    target = _batch(8, 1)[0][:, :, None]
    num_t, batch = 3, 4
    encoded = jmodel.embed_codes(jvars, jmodel.encode(jvars, jnp.asarray(target)))
    labels = jnp.asarray([i for i in range(3) for _ in range(num_t)], jnp.int32)
    ts = jnp.tile(jnp.linspace(0.0, 1.0, num_t), 3)
    epsilons = jax.random.normal(jax.random.key(9), (2,) + target.shape)

    @jax.jit
    def eval_mb(lab, t):
        n = lab.shape[0]

        def per_seed(eps):
            eps_mb = jnp.tile(eps, (n, 1, 1))
            noised = jmodel.diffusion.sample_q(jnp.tile(target, (n, 1, 1)), t, epsilon=eps_mb)
            pred = jmodel.predict_eps(jvars, noised, t, cond=jnp.tile(encoded, (n, 1, 1)),
                                      labels=lab)
            return jnp.mean(jnp.reshape(jnp.square(pred - eps_mb), (n, -1)), axis=1)

        return jnp.mean(jax.vmap(per_seed)(epsilons), axis=0)

    results = []
    for i in range(0, len(labels), batch):
        lab, t = labels[i:i + batch], ts[i:i + batch]
        pad = batch - len(lab)
        mses = np.asarray(eval_mb(jnp.pad(lab, (0, pad)), jnp.pad(t, (0, pad))))
        results.append(mses[:batch - pad])
    want = np.concatenate(results).reshape(-1, num_t).mean(-1)

    model = VQVAE.load(ckpts["vqvae"], device="cpu")
    with torch.no_grad():
        got = voice_search_vqvae.label_losses(
            model, torch.from_numpy(target), torch.from_numpy(np.array(epsilons)), num_t, batch)
    _close(got, want)
    assert np.argsort(got).tolist() == np.argsort(want).tolist()


def _jax_swap_eval():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module("swap_eval")
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


def test_swap_batch_matches_jax(ckpts):
    """One batch of the JAX script's swap (encode, 3-step DPM++ decode with
    the x0 constraint as the next speaker, re-encode), decoded by the port
    from the same x_T."""
    jmodel, jvars = JaxVQVAE.load(ckpts["vqvae"])
    audio = np.stack([_clip(i, SAMPLES) for i in range(2)]).astype(np.float32)[..., None]
    tgt = np.asarray([1, 2], np.int32)
    key = jax.random.fold_in(jax.random.key(7), 0)

    @jax.jit
    def swap(a, lab, r):
        codes = jmodel.encode(jvars, a)
        out = jmodel.decode(jvars, codes, r, labels=lab, steps=3, sampler="dpmpp",
                            eta=0.0, constrain=True)
        agreement = jnp.mean((jmodel.encode(jvars, out) == codes).astype(jnp.float32), -1)
        return out, agreement, codes

    want, want_agree, want_codes = swap(jnp.asarray(audio), jnp.asarray(tgt), key)
    _, noise_key = jax.random.split(key)  # decode's own x_T draw
    x_T = jax.random.normal(noise_key, audio.shape, jnp.float32)

    model = VQVAE.load(ckpts["vqvae"], device="cpu")
    args = swap_eval.arg_parser().parse_args(["--sample-steps", "3", "--sampler", "dpmpp",
                                              "m.npz", "out"])
    with torch.no_grad():
        np.testing.assert_array_equal(model.encode(torch.from_numpy(audio)).numpy(),
                                      np.asarray(want_codes))
        got, agree = swap_eval.swap(model, torch.from_numpy(audio),
                                    torch.from_numpy(tgt).long(), args,
                                    x_T=torch.from_numpy(np.array(x_T)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(agree.numpy(), np.asarray(want_agree))


def test_swap_aggregate_reads_the_jax_metrics(tmp_path):
    jax_swap_eval = _jax_swap_eval()
    rng = np.random.RandomState(1)
    for b, n in enumerate((4, 4, 3)):
        jax_swap_eval.write_json(str(tmp_path / f"metrics_{b:05}.json"), {
            "agreement": rng.rand(n).tolist(),
            "target_hit": (rng.rand(n) > 0.5).tolist(),
            "source_leak": (rng.rand(n) > 0.7).tolist(),
            "peak_hz": (300 * rng.rand(n)).tolist()})
    got = swap_eval.aggregate(str(tmp_path), 3)
    assert got == jax_swap_eval.aggregate(str(tmp_path), 3) and got["n"] == 11


def test_tone_metrics_pick_the_nearest_tone():
    t = np.arange(swap_eval.CLIP_LEN) / swap_eval.SAMPLE_RATE
    out = np.stack([np.sin(2 * np.pi * f * t) for f in (500.0, 310.0, 990.0)])
    m = swap_eval.tone_metrics(out, np.asarray([0, 1, 2]), np.asarray([1, 2, 0]),
                               np.asarray([300.0, 500.0, 1000.0]))
    assert m["target_hit"] == [True, False, False]
    assert m["source_leak"] == [False, False, True]
    assert m["peak_hz"] == [500.0, 310.0, 990.0]


# ------------------------------------------------------- the CLIs end to end


def test_eval_diffusion_cli(ckpts, capsys):
    eval_diffusion.main(["--device", "cpu", "--batch-size", "4", ckpts["diffusion"],
                         ckpts["data"]])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " samples: " in ln]
    assert [ln.split()[0] for ln in lines] == ["4", "8"]  # 9 windows, drop-last
    fields = dict(tok.split("=") for tok in lines[-1].split(": ")[1].split())
    assert fields and all(np.isfinite(float(v)) for v in fields.values())


def test_eval_vqvae_cli(ckpts, capsys):
    eval_vqvae.main(["--device", "cpu", "--batch-size", "4", "--seed", "3", ckpts["vqvae"],
                     ckpts["data"]])
    last = [ln for ln in capsys.readouterr().out.splitlines() if " samples: " in ln][-1]
    fields = dict(tok.split("=") for tok in last.split(": ")[1].split())
    assert {k[:4] for k in fields} == {"cond", "rand"} and any(k.startswith("cond_std_q")
                                                               for k in fields)
    assert all(np.isfinite(float(v)) for v in fields.values())


def test_eval_vqvae_cli_refuses_other_labels(ckpts, tmp_path):
    ds = str(tmp_path / "ds2")
    for spk in ("a", "b"):
        _write_wav(os.path.join(ds, spk, "u.wav"), _clip(1, 72000))
    with pytest.raises(SystemExit, match="model has 3 labels, dataset has 2"):
        eval_vqvae.main(["--device", "cpu", ckpts["vqvae"], ds])


def test_voice_search_cli(ckpts, capsys):
    voice_search_vqvae.main(["--device", "cpu", "--num-timesteps", "2", "--batch-size", "4",
                             "--top-k", "2", "--input-file", ckpts["clip"], ckpts["vqvae"]])
    out = capsys.readouterr().out
    assert "top 2 sorted losses" in out and "6/6" in out
    ranked = out.split("-------\n")[1].split()
    assert len(ranked) == 4 and {int(ranked[0]), int(ranked[2])} <= {0, 1, 2}
    assert float(ranked[1]) <= float(ranked[3])


def test_swap_eval_cli_writes_and_resumes_exactly(ckpts, tmp_path, capsys):
    out = str(tmp_path / "swap")
    argv = ["--device", "cpu", "--num-samples", "3", "--batch-size", "2", "--sample-steps",
            "2", "--sampler", "dpmpp", ckpts["vqvae"], out]
    swap_eval.main(argv)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["n"] == 3 and 0 <= report["check_vq_agreement"] <= 1
    with open(os.path.join(out, "report.json")) as f:
        assert json.load(f) == report
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(out, "*"))) == [
        "metrics_00000.json", "metrics_00001.json", "report.json", "sample_000000.wav",
        "sample_000001.wav", "sample_000002.wav"]
    with open(os.path.join(out, "sample_000001.wav"), "rb") as f:
        first = f.read()
    os.remove(os.path.join(out, "sample_000001.wav"))  # batch 0 runs again, batch 1 not
    os.remove(os.path.join(out, "sample_000002.wav"))
    open(os.path.join(out, "sample_000002.wav"), "w").close()
    swap_eval.main(argv)
    assert "converted 2/3" in capsys.readouterr().out
    with open(os.path.join(out, "sample_000001.wav"), "rb") as f:
        assert f.read() == first
    assert os.path.getsize(os.path.join(out, "sample_000002.wav")) == 0


@pytest.mark.parametrize("cli", ["stat_generate", "eval_diffusion", "eval_vqvae",
                                 "voice_search_vqvae", "swap_eval"])
def test_eval_clis_default_to_cuda(ckpts, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    argv = {
        "stat_generate": ["--checkpoint-path", ckpts["classifier"], "--sample-dir",
                          ckpts["samples"], str(tmp_path / "s.npz")],
        "eval_diffusion": [ckpts["diffusion"], ckpts["data"]],
        "eval_vqvae": [ckpts["vqvae"], ckpts["data"]],
        "voice_search_vqvae": ["--input-file", ckpts["clip"], ckpts["vqvae"]],
        "swap_eval": [ckpts["vqvae"], str(tmp_path / "swap")],
    }[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(f"vq_voice_swap_torch.{cli}").main(argv)
