"""The voice-swap slice of the PyTorch port end to end against the JAX
package: a JAX-saved ``.npz`` checkpoint loads into the port, encode gives
the same codes, decode gives the same waveform from the same x_T, and the
port's CLI runs. Also: the port and chip_smoke.py import no JAX.

Small flagship topology: unet predictor + conv-mfcc-ulaw encoder at
base_channels 4, a 16-code dictionary, 3 labels, 2560-sample clips.
"""

import ast
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_port_util import randomize_params

from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_torch import sample_vqvae
from vq_voice_swap_torch.convert import params_from_jax
from vq_voice_swap_torch.vq_vae import VQVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KWARGS = dict(pred_name="unet", base_channels=4, enc_name="conv-mfcc-ulaw",
              dictionary_size=16, num_labels=3)
SAMPLES = 2560


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """(JAX model, randomized variables, path of the JAX-saved .npz)."""
    model = JaxVQVAE(**KWARGS)
    variables = model.init_variables(jax.random.key(0), seq_len=SAMPLES)
    params = randomize_params(variables["params"], 7)
    # Codes spread over the dictionary only where it lies where the
    # encoder's outputs do: around their mean, at their frame-to-frame spread.
    enc = np.asarray(model.encode_raw({"params": params}, jnp.asarray(_audio())))
    params["vq"]["dictionary"] = (
        enc.mean(axis=(0, 1)) + params["vq"]["dictionary"] * enc.std(axis=1).mean()
    ).astype(np.float32)
    variables = dict(variables, params=params)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    model.save(path, variables)
    return model, variables, path


@pytest.fixture(scope="module")
def port_model(jax_model):
    return VQVAE.load(jax_model[2], device="cpu")


def _audio():
    rng = np.random.RandomState(11)
    return (0.5 * np.tanh(rng.randn(2, SAMPLES, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    return _audio()


def test_checkpoint_loads_through_params_from_jax(jax_model, port_model):
    _, variables, _ = jax_model
    flat = traverse_util.flatten_dict(variables, sep="/")
    want = params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    got = port_model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert port_model.save_kwargs() == jax_model[0].save_kwargs()
    assert not any(p.is_cuda for p in port_model.parameters())


def test_port_checkpoint_loads_in_jax(jax_model, port_model, tmp_path):
    path = str(tmp_path / "port.npz")
    port_model.save(path)
    _, variables = JaxVQVAE.load(path)
    want = traverse_util.flatten_dict(jax_model[1], sep="/")
    got = traverse_util.flatten_dict(variables, sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _assert_codes_match(dictionary, enc, got, want):
    """Codes equal, or where they differ a true tie: the float64 distances
    of both picks within 1e-6 relative."""
    d64 = np.asarray(dictionary, np.float64)
    e64 = np.asarray(enc, np.float64).reshape(-1, d64.shape[1])
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    for i in np.nonzero(got != want)[0]:
        a = np.sum((e64[i] - d64[got[i]]) ** 2)
        b = np.sum((e64[i] - d64[want[i]]) ** 2)
        assert abs(a - b) <= 1e-6 * max(a, b), (i, a, b)


def test_encode_matches(jax_model, port_model, audio):
    model, variables, _ = jax_model
    enc = np.asarray(model.encode_raw(variables, jnp.asarray(audio)))
    want = np.asarray(model.encode(variables, jnp.asarray(audio)))
    with torch.no_grad():
        got_enc = port_model.encode_raw(torch.from_numpy(audio)).numpy()
        got = port_model.encode(torch.from_numpy(audio)).numpy()
    np.testing.assert_allclose(got_enc, enc, atol=2e-4, rtol=2e-4)
    assert got.shape == want.shape == (2, SAMPLES // 320)
    assert len(np.unique(want)) > 1  # randomized weights: not one code
    _assert_codes_match(variables["params"]["vq"]["dictionary"], enc, got, want)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_decode_matches_given_the_jax_x_T(jax_model, port_model, audio, sampler):
    model, variables, _ = jax_model
    codes = model.encode(variables, jnp.asarray(audio))
    labels = jnp.asarray([0, 2], jnp.int32)
    key = jax.random.key(3)
    want = jax.jit(
        lambda v, c, lab, r: model.decode(
            v, c, r, labels=lab, steps=3, sampler=sampler, constrain=True
        )
    )(variables, codes, labels, key)
    _, noise_key = jax.random.split(key)  # decode's own x_T draw
    x_T = jax.random.normal(noise_key, (2, SAMPLES, 1), jnp.float32)
    with torch.no_grad():
        got = port_model.decode(
            torch.from_numpy(np.array(codes)).long(),
            labels=torch.tensor([0, 2]),
            steps=3,
            constrain=True,
            sampler=sampler,
            x_T=torch.from_numpy(np.array(x_T)),
        )
    assert got.shape == (2, SAMPLES, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def _write_wav(path, samples, rate=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * (2**15 - 1)).astype("<i2").tobytes())


@pytest.mark.parametrize("flags", [
    ["--sampler", "ddpm", "--check-vq"],
    ["--sampler", "ddim", "--eta", "0.5", "--no-vq", "--encoding", "ulaw"],
])
def test_cli_runs_on_cpu(jax_model, tmp_path, capsys, flags):
    src = str(tmp_path / "in.wav")
    out = str(tmp_path / "out.wav")
    rng = np.random.RandomState(2)
    _write_wav(src, 0.3 * np.sin(np.arange(32000) * 0.05) + 0.01 * rng.randn(32000))
    sample_vqvae.main([
        "--label", "1", "--input-file", src, "--seconds", "2",
        "--sample-steps", "2", *flags, "--device", "cpu", jax_model[2], out,
    ])
    with wave.open(out, "rb") as w:
        assert w.getnframes() == 32000 and w.getframerate() == 16000
    printed = capsys.readouterr().out
    assert ("fraction of consistent VQ codes" in printed) == ("--check-vq" in flags)


def test_entry_points_never_fall_back_to_cpu(jax_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQVAE.load(jax_model[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_vqvae.main(["--label", "0", "--input-file", "x.wav",
                           jax_model[2], str(tmp_path / "o.wav")])


def _port_files():
    pkg = os.path.join(REPO, "vq_voice_swap_torch")
    for root, _, files in os.walk(pkg):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = {"jax", "flax", "vq_voice_swap_tpu"}
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
