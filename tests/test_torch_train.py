"""Training in the PyTorch port against the JAX package on the CPU: the VQ
codebook maintenance (usage counts, k-means++ revival, the VQ loss), the
temporal jitter, the flax-mirroring initialisation, ``DiffusionModel.losses``
and ``VQVAE.losses`` with their gradients, the optimizer, the EMA and whole
train steps against ``make_train_step``.

The models keep the flagship's classes and losses with a shallow UNet
swapped in on both sides (two levels, one block each: a full-depth UNet
costs a JAX grad compile of about a minute). The port builds them with
seeded weights; the JAX side takes the same arrays through
``params_to_jax``, so no JAX init runs outside the init test. The two
packages draw different random numbers, so the port is given the JAX
draws: timesteps, noise, jitter and no-VQ uniforms rebuilt from the keys
as the JAX losses split them, the dropout masks read off flax's
``nn.Dropout`` calls, and the revival picks read off the JAX step.

Tolerances: losses within 1e-5 relative; each gradient leaf within 2e-4 of
its largest entry plus 1e-7 (float32 convolution sums in another order;
the bias of a conv that feeds a GroupNorm of one channel a group has a
true gradient of 0 and gets rounding noise); the
optimizer on the same gradients within 3e-5 of the learning rate (optax's
float32 bias correction); EMAs
within float32 rounding. The first AdamW updates are about lr * sign(g),
so a parameter whose gradient is rounding noise may move the other way:
after whole steps every parameter is within the sum of the steps' learning
rates, times two, of the JAX one, and 99% of them within 1% of it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from vq_voice_swap_tpu import vq as jvq
from vq_voice_swap_tpu.models.unet import UNetEncoder as JaxUNetEncoder
from vq_voice_swap_tpu.models.unet import UNetPredictor as JaxUNetPredictor
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_tpu.train import steps as jax_steps
from vq_voice_swap_tpu.train.ema import build_rate_tree, ema_update
from vq_voice_swap_tpu.train.state import TrainState
from vq_voice_swap_tpu.train.state import build_optimizer as jax_build_optimizer
from vq_voice_swap_tpu.train.state import prefix_predicate as jax_prefix_predicate
from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_tpu.vq_vae import jitter_seq as jax_jitter_seq
from vq_voice_swap_torch import vq
from vq_voice_swap_torch.convert import params_from_jax, params_to_jax
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor
from vq_voice_swap_torch.train import (EMA, TrainStep, VQUpdateRule, VQVAETrainLoop,
                                       build_optimizer, prefix_predicate)
from vq_voice_swap_torch.vq_vae import VQVAE, jitter_seq

BASE, COND_MULT, CODES, LABELS, DROPOUT = 4, 4, 16, 3, 0.1
SHALLOW = dict(channel_mult=(1, 2), depth_mult=1)
T = 256
GRAD_TOL = 2e-4


def _seed_weights(model: torch.nn.Module, seed: int) -> None:
    """Every layer live: weights ~ N(0, 1/fan_in) (the ResBlock output
    convs at 0.3 of that), norms near 1, small biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if name.endswith("dictionary"):
                p.copy_(noise)
            elif p.ndim >= 2:
                scale = 0.3 if ".conv_out." in name else 1.0
                p.copy_(noise * scale / np.sqrt(p[0].numel()))
            elif name.endswith("norm.weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _shallow(model, jax_model, cond_channels=None, num_labels=None, dropout=0.0):
    """Swap the shallow UNet into a port model and its JAX twin."""
    pred = dict(base_channels=BASE, middle_dilations=(4,), cond_channels=cond_channels,
                num_labels=num_labels, **SHALLOW)
    model.predictor = UNetPredictor(**pred)
    jax_model.predictor = JaxUNetPredictor(dropout=dropout, **pred)
    if cond_channels is not None:
        enc = dict(base_channels=BASE, out_channels=cond_channels, **SHALLOW)
        model.encoder = UNetEncoder(**enc)
        jax_model.encoder = JaxUNetEncoder(**enc)


def _jax_variables(model: torch.nn.Module):
    """The port's weights (and buffers) as a JAX variables tree."""
    flat = params_to_jax(model)
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _vqvae(seed: int, dropout: float, audio: np.ndarray):
    """(port VQVAE, JAX VQVAE, JAX variables): shallow, class-conditional,
    the codebook centred on the encoder's outputs at their spread."""
    kwargs = dict(pred_name="unet", base_channels=BASE, enc_name="unet", cond_mult=COND_MULT,
                  dictionary_size=CODES, num_labels=LABELS, dropout=dropout, dead_rate=4)
    model, jax_model = VQVAE(**kwargs), JaxVQVAE(**kwargs)
    _shallow(model, jax_model, BASE * COND_MULT, LABELS, dropout)
    _seed_weights(model, seed)
    with torch.no_grad():
        enc = model.encode_raw(torch.from_numpy(audio))
        model.vq.dictionary.copy_(enc.mean(dim=(0, 1)) + model.vq.dictionary * enc.std())
    return model, jax_model, _jax_variables(model)


def _audio(n: int, seed: int = 11) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (0.5 * np.tanh(rng.randn(n, T, 1))).astype(np.float32)


def _torch_grads(tree) -> dict:
    flat = traverse_util.flatten_dict(tree, sep="/")
    return params_from_jax({f"params/{k}": np.asarray(v) for k, v in flat.items()})


def _assert_grads_close(model: torch.nn.Module, jax_grads) -> None:
    want = _torch_grads(jax_grads)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        w = want[name]
        err = (p.grad - w).abs().max().item()
        assert err <= GRAD_TOL * w.abs().max().item() + 1e-7, (name, err)


def _capture_dropout(fn):
    """Run fn with every flax Dropout call's keep-mask recorded, in call
    order; returns (fn's result, masks)."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            masks.append(out != 0)
        return out

    with fnn.intercept_methods(interceptor):
        res = fn()
    return res, masks


def _ncts(masks):
    """JAX [N, T, C] masks -> the port's [N, C, T]."""
    return [torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(m), (0, 2, 1))))
            for m in masks]


def _vqvae_draws(key, n: int, t1: int):
    """The draws of JAX VQVAE.losses for a key, as the port's keywords."""
    t_rng, n_rng, j_rng, m_rng, _ = jax.random.split(key, 5)
    return dict(
        ts=torch.from_numpy(np.array(jax.random.uniform(t_rng, (n,)))),
        epsilon=torch.from_numpy(np.array(jax.random.normal(n_rng, (n, T, 1)))),
        jitter_nums=torch.from_numpy(np.array(jax.random.uniform(j_rng, (n, t1, 1)))),
        no_vq_nums=torch.from_numpy(np.array(jax.random.uniform(m_rng, (n, 1, 1)))),
    )


# ---------------------------------------------------------------- VQ pieces


@pytest.mark.parametrize("with_used", [False, True])
def test_update_usage_matches_jax(with_used):
    rng = np.random.RandomState(0)
    usage = rng.randint(0, 6, size=32).astype(np.int32)
    idxs = rng.randint(0, 32, size=(3, 7))
    used = None
    if with_used:
        used = np.zeros(32, bool)
        used[idxs.reshape(-1)] = True
    want = jvq.update_usage(jnp.asarray(usage), jnp.asarray(idxs), 5, decay=3,
                            used=None if used is None else jnp.asarray(used))
    got = vq.update_usage(torch.from_numpy(usage), torch.from_numpy(idxs), 5, decay=3,
                          used=None if used is None else torch.from_numpy(used))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_revive_dead_codes_matches_jax_for_the_same_picks():
    """The k-means++ probabilities against the JAX formula, and the revived
    codebook for the picks JAX's own categorical draw makes."""
    rng = np.random.RandomState(1)
    d = rng.randn(16, 8).astype(np.float32)
    x = rng.randn(40, 8).astype(np.float32)
    usage = np.array([0, 3] * 8, np.int32)
    key = jax.random.key(5)
    want_d, want_u = jvq.revive_dead_codes(key, jnp.asarray(d), jnp.asarray(usage),
                                           jnp.asarray(x), 7)
    min_dists = jnp.min(jvq.embedding_distances(jnp.asarray(d), jnp.asarray(x)), axis=-1)
    want_probs = np.asarray(jnp.clip(min_dists, 0.0, None))
    picks = jax.random.categorical(key, jnp.log(want_probs)[None, :], shape=(16,))
    probs = vq.revival_probs(torch.from_numpy(d), torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=1e-5, atol=1e-5)
    got_d, got_u = vq.revive_dead_codes(torch.from_numpy(d), torch.from_numpy(usage),
                                        torch.from_numpy(x), 7,
                                        picks=torch.from_numpy(np.array(picks)))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


def test_revive_dead_codes_draw_frequencies():
    """Seeded: 4096 dead codes each draw a row with probability proportional
    to its squared distance to the nearest live code (one row sits on a code:
    never drawn); every frequency within 5 standard errors."""
    d = torch.zeros(4096, 2)
    d[0] = torch.tensor([10.0, 10.0])
    x = torch.tensor([[1.0, 0.0], [2.0, 0.0], [0.0, 3.0], [10.0, 10.0]])
    usage = torch.zeros(4096, dtype=torch.int32)
    usage[0] = 5
    gen = torch.Generator().manual_seed(0)
    new_d, new_u = vq.revive_dead_codes(d, usage, x, 9, generator=gen)
    assert torch.equal(new_d[0], d[0]) and new_u[0] == 5 and (new_u[1:] == 9).all()
    rows = (new_d[1:, None, :] == x[None]).all(-1).float().argmax(-1)
    freq = torch.bincount(rows, minlength=4).double() / rows.numel()
    p = torch.tensor([1.0, 4.0, 9.0, 0.0], dtype=torch.float64) / 14.0
    se = (p * (1 - p) / rows.numel()).sqrt()
    assert freq[3] == 0
    assert ((freq - p).abs() <= 5 * se + 1e-12).all(), (freq, p)


@pytest.mark.parametrize("revival", [0.0, 0.3])
def test_vq_loss_fn_matches_jax(revival):
    rng = np.random.RandomState(2)
    inputs = rng.randn(2, 5, 8).astype(np.float32)
    d = rng.randn(16, 8).astype(np.float32)
    jcfg = jvq.VQLossConfig(commitment=0.4, revival=revival)

    def jloss(inp, dd):
        out = jvq.vq_forward(dd, inp)
        return jvq.vq_loss_fn(jcfg, inp, out["embedded"], dd)

    want, (want_gi, want_gd) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(inputs), jnp.asarray(d))
    ti = torch.from_numpy(inputs).requires_grad_()
    td = torch.from_numpy(d).requires_grad_()
    out = vq.vq_forward(td, ti)
    got = vq.vq_loss_fn(vq.VQLossConfig(commitment=0.4, revival=revival), ti,
                        out["embedded"], td)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want_gi), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(want_gd), rtol=1e-5, atol=1e-6)


def test_jitter_seq_matches_jax():
    seq = np.random.RandomState(3).randn(2, 9, 4).astype(np.float32)
    key = jax.random.key(4)
    want = jax_jitter_seq(key, jnp.asarray(seq), 0.5)
    nums = torch.from_numpy(np.array(jax.random.uniform(key, (2, 9, 1))))
    got = jitter_seq(torch.from_numpy(seq), 0.5, nums)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), seq)


# ------------------------------------------------------------------ init


def test_init_mirrors_flax():
    """A fresh model against flax's init of the same structure (a shallow
    unet predictor at base 32, the conv-MFCC encoder): the same leaves,
    zero exactly where flax's are zero (conv_out, the MFCC out_conv, the
    biases), and each leaf of 1000 or more entries with a standard
    deviation within 10% of flax's."""
    kwargs = dict(pred_name="unet", base_channels=32, enc_name="conv-mfcc-ulaw",
                  cond_mult=4, dictionary_size=64, num_labels=LABELS)
    model, jax_model = VQVAE(**kwargs), JaxVQVAE(**kwargs)
    pred = dict(base_channels=32, middle_dilations=(4,), cond_channels=128,
                num_labels=LABELS, **SHALLOW)
    model.predictor = UNetPredictor(**pred)
    jax_model.predictor = JaxUNetPredictor(**pred)
    init_like_flax(model, torch.Generator().manual_seed(0))
    variables = jax_model.init_variables(jax.random.key(0))
    want = {k: v for k, v in params_from_jax(
        {"/".join(k): np.asarray(v)
         for k, v in traverse_util.flatten_dict(variables).items()}).items()}
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert torch.equal(got["vq.usage_count"], want["vq.usage_count"])
    checked = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if not w.is_floating_point():
            continue
        if not w.any():
            assert not g.any(), name
            continue
        if w.numel() >= 1000:
            ratio = g.std().item() / w.std().item()
            assert abs(ratio - 1.0) < 0.1, (name, ratio)
            assert abs(g.mean().item()) < 0.1 * w.std().item() + abs(w.mean().item()), name
            checked += 1
    assert checked >= 10
    assert not model.encoder.out_conv.conv.weight.any()
    for block in model.predictor.down_blocks:
        assert not block.conv_out.conv.weight.any()


# --------------------------------------------------------------- losses


def test_diffusion_losses_match_jax():
    """Class-conditional DiffusionModel.losses in a training forward with
    dropout: per-element losses and every parameter's gradient."""
    kwargs = dict(pred_name="unet", base_channels=BASE, num_labels=LABELS, dropout=DROPOUT)
    model, jax_model = DiffusionModel(**kwargs), JaxDiffusionModel(**kwargs)
    _shallow(model, jax_model, num_labels=LABELS, dropout=DROPOUT)
    _seed_weights(model, 0)
    params = _jax_variables(model)["params"]
    x = _audio(3)
    labels = np.array([0, 2, 1], np.int32)
    key = jax.random.key(7)

    def loss(p):
        (losses, ts), masks = _capture_dropout(lambda: jax_model.losses(
            {"params": p}, key, jnp.asarray(x), labels=jnp.asarray(labels), train=True))
        return jnp.mean(losses), (losses, ts, masks)

    (want, (want_losses, want_ts, masks)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    assert len(masks) == 9  # every ResBlock of the shallow UNet
    loss_rng, _ = jax.random.split(key)
    t_key, loss_rng = jax.random.split(loss_rng)
    _, n_key = jax.random.split(loss_rng)
    ts = torch.from_numpy(np.array(jax.random.uniform(t_key, (3,))))
    noise = torch.from_numpy(np.array(jax.random.normal(n_key, x.shape)))
    losses, got_ts = model.losses(torch.from_numpy(x), labels=torch.from_numpy(labels).long(),
                                  ts=ts, noise=noise, train=True, dropout_masks=_ncts(masks))
    losses.mean().backward()
    np.testing.assert_array_equal(got_ts.numpy(), np.asarray(want_ts))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(want_losses), rtol=1e-5)
    _assert_grads_close(model, grads)


def test_vqvae_losses_match_jax():
    """VQVAE.losses in a training forward with jitter, no-VQ dropout, the
    revival loss and dropout: the losses, codes, used mask and encoder
    outputs, and every parameter's gradient."""
    audio = _audio(3)
    model, jax_model, variables = _vqvae(1, DROPOUT, audio)
    labels = np.array([1, 0, 2], np.int32)
    key = jax.random.key(8)
    cfg = dict(commitment=0.25, revival=0.05)

    def loss(p):
        out, masks = _capture_dropout(lambda: jax_model.losses(
            {"params": p, "buffers": variables["buffers"]}, key, jnp.asarray(audio),
            labels=jnp.asarray(labels), vq_loss_cfg=jvq.VQLossConfig(**cfg), jitter=0.4,
            no_vq_prob=0.4, train=True))
        return out["mse"] + out["vq_loss"], (out, masks)

    (want, (out, masks)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    t1 = out["idxs"].shape[1]
    got = model.losses(torch.from_numpy(audio), labels=torch.from_numpy(labels).long(),
                       vq_loss_cfg=vq.VQLossConfig(**cfg), jitter=0.4, no_vq_prob=0.4,
                       train=True, dropout_masks=_ncts(masks),
                       **_vqvae_draws(key, 3, t1))
    (got["mse"] + got["vq_loss"]).backward()
    np.testing.assert_array_equal(got["idxs"].numpy(), np.asarray(out["idxs"]))
    np.testing.assert_array_equal(got["used"].numpy(), np.asarray(out["used"]))
    assert 1 < got["used"].sum() < CODES
    for k in ("vq_loss", "mse", "mses", "enc_flat"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(out[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_grads_close(model, grads)


# ------------------------------------------------------ optimizer and EMA


def test_optimizer_matches_optax_on_the_same_grads():
    """AdamW with weight decay, a frozen prefix, the linear anneal and the
    global-norm clip (on in the first update, off in the second), from the
    same gradients: the updates within 3e-5 of the learning rate, beside
    the rounding of the parameters themselves (two float32 ulps). optax
    forms Adam's bias correction 1 - 0.999^t in float32, 1.3e-5 off at
    t = 1, which moves its updates by up to 1.5e-5 of the rate in these
    two steps; torch forms it in float64."""
    model = DiffusionModel(pred_name="unet", base_channels=BASE)
    model.predictor = UNetPredictor(base_channels=BASE, middle_dilations=(4,), **SHALLOW)
    _seed_weights(model, 2)
    params = _jax_variables(model)["params"]
    lr, lr_final, clip = 1e-2, 2e-3, 1.0
    frozen = ["predictor.time_embed"]
    tx = jax_build_optimizer(params, lr=lr, weight_decay=0.1,
                             frozen_fn=jax_prefix_predicate(["predictor/time_embed"]),
                             lr_final=lr_final, lr_anneal_steps=4, grad_clip=clip)
    opt = build_optimizer(model, lr=lr, weight_decay=0.1, frozen_fn=prefix_predicate(frozen),
                          lr_final=lr_final, lr_anneal_steps=4, grad_clip=clip)
    assert not model.predictor.time_embed.proj.weight.requires_grad
    rng = np.random.RandomState(3)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for scale in (1.0, 1e-3):  # the first clips, the second does not
        grads = jax.tree.map(lambda p: jnp.asarray(scale * rng.randn(*p.shape), jnp.float32),
                             params)
        assert (optax.global_norm(grads) >= clip) == (scale == 1.0)
        updates, opt_state = update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        tgrads = _torch_grads(grads)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone() if p.requires_grad else None
        opt.step()
        want = _torch_grads(new_params)
        for name, p in model.named_parameters():
            err = (p.detach() - want[name]).abs() - 2.4e-7 * want[name].abs()
            assert err.max().item() <= 3e-5 * lr, name
        params = new_params
    assert opt.count == 2 and opt.lr_at(1) == pytest.approx(lr - (lr - lr_final) / 4)


def test_ema_matches_jax():
    rng = np.random.RandomState(4)
    model = torch.nn.Linear(7, 5)
    init = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    ema = EMA(model, 0.999)
    tree = {k: jnp.asarray(v) for k, v in init.items()}
    rates = build_rate_tree(tree, {"": 0.999})
    for _ in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
        ema.update(model)
        tree = ema_update(tree, {k: jnp.asarray(v.detach().numpy())
                                 for k, v in model.named_parameters()}, rates)
    for k, v in ema.model.named_parameters():
        np.testing.assert_allclose(v.numpy(), np.asarray(tree[k]), rtol=0, atol=1e-7)
        assert not v.requires_grad


# --------------------------------------------------------- whole steps


def _loop_stub(model, **args):
    """What the loops' build_loss_fn reads off the loop."""
    args = types.SimpleNamespace(class_cond=True, commitment_coeff=0.25, revival_coeff=0.0,
                                 jitter=0.2, **args)
    return types.SimpleNamespace(
        model=model, args=args,
        vq_loss_config=lambda: jvq.VQLossConfig(commitment=0.25, revival=0.0))


def test_train_steps_match_jax(monkeypatch):
    """Two whole VQ-VAE train steps, batch 5 as two microbatches of 2 and a
    remainder of 1, the encoder frozen, the LR annealed, the gradients
    clipped, one EMA, and the codebook maintenance with revival (codes whose
    usage runs out die and are revived from the step's encoder outputs),
    against the JAX package's make_train_step (jit=False, jitted here)."""
    audio = _audio(5, seed=12)
    model, jax_model, variables = _vqvae(3, 0.0, audio)
    usage = np.array([1, 2] * 8, np.int32)
    model.vq.usage_count.copy_(torch.from_numpy(usage))
    buffers = {"vq": {"usage_count": jnp.asarray(usage)}}
    params = variables["params"]
    labels = np.array([0, 1, 2, 0, 1], np.int32)
    lr, lr_final, clip, rate = 1e-3, 5e-4, 0.5, 0.9

    picks = []
    revive = jax_steps.revive_dead_codes

    def revive_and_record(rng, dictionary, usage_, batch_vecs, dead_rate):
        probs = jnp.clip(jnp.min(jvq.embedding_distances(dictionary, batch_vecs), -1), 0.0)
        probs = jnp.where(jnp.sum(probs) > 0, probs, jnp.ones_like(probs))
        p = jax.random.categorical(rng, jnp.log(probs)[None, :], shape=(dictionary.shape[0],))
        jax.debug.callback(lambda v: picks.append(np.asarray(v)), p)
        return revive(rng, dictionary, usage_, batch_vecs, dead_rate)

    monkeypatch.setattr(jax_steps, "revive_dead_codes", revive_and_record)
    tx = jax_build_optimizer(params, lr=lr, frozen_fn=jax_prefix_predicate(["encoder"]),
                             lr_final=lr_final, lr_anneal_steps=1, grad_clip=clip)
    jax_step = jax.jit(jax_steps.make_train_step(
        jax_loops.VQVAETrainLoop.build_loss_fn(_loop_stub(jax_model)), tx,
        {str(rate): build_rate_tree(params, {"": rate})}, microbatches=2,
        micro_remainder=1, vq_rule=jax_steps.VQUpdateRule(dead_rate=4, revive=True),
        jit=False))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, buffers=buffers,
                       opt_state=tx.init(params), emas={str(rate): params})

    opt = build_optimizer(model, lr=lr, frozen_fn=prefix_predicate(["encoder"]),
                          lr_final=lr_final, lr_anneal_steps=1, grad_clip=clip)
    ema = EMA(model, rate)
    step = TrainStep(model, VQVAETrainLoop.build_loss_fn(_loop_stub(model)), opt, [ema],
                     microbatches=2, micro_remainder=1,
                     vq_rule=VQUpdateRule(dead_rate=4, revive=True))
    batch = {"samples": audio[..., 0], "label": labels}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    t1 = T // model.encoder.downsample_rate
    live = []
    for i, key in enumerate((jax.random.key(21), jax.random.key(22))):
        state, want = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        draws = [_vqvae_draws(k, n, t1)
                 for k, n in zip(jax.random.split(key, 3), (2, 2, 1))]
        got = step({"samples": torch.from_numpy(batch["samples"]),
                    "label": torch.from_numpy(labels).long()}, None, draws=draws,
                   revive_picks=torch.from_numpy(np.array(picks[i])).long())
        assert len(picks) == i + 1
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["extra"]["vq_loss"].item(),
                                   float(want["extra"]["vq_loss"]), rtol=1e-5)
        for k in ("mses", "ts"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5)
        assert got["codebook_used"].item() == int(want["codebook_used"])
        live.append(int(want["codebook_used"]))
        np.testing.assert_array_equal(model.vq.usage_count.numpy(),
                                      np.asarray(state.buffers["vq"]["usage_count"]))
    assert 0 < live[0] < CODES  # codes died in the first step and were revived
    # Each leaf's update (new minus start) against JAX's. Every element is
    # within the two steps' learning rates: where a gradient is below
    # Adam's eps (1e-8), its rounding decides the update's sign. A leaf that
    # JAX moved by at least half of what Adam moves a gradient well above
    # eps (about lr a step for the params; 1 - rate**2 of the first step for
    # the EMA) has 99% of its elements within 1% of lr. In a right step the
    # leaves below that are conv biases feeding a GroupNorm (gradient 0 up
    # to rounding); every GroupNorm affine, FiLM projection and embedding
    # is held per leaf.
    bound = 2 * (opt.lr_at(0) + opt.lr_at(1))
    for tree, module, moved in ((state.params, model, 0.5 * lr),
                                (state.emas[str(rate)], ema.model, 0.5 * (1 - rate ** 2) * lr)):
        want = _torch_grads(tree)
        held = 0
        for n, p in module.named_parameters():
            update, want_update = p.detach() - start[n], want[n] - start[n]
            diff = (update - want_update).abs()
            assert diff.max().item() <= bound, (n, diff.max().item())
            if n.startswith("encoder."):  # frozen: neither package moved it
                assert torch.equal(p.detach(), start[n]) and not want_update.any(), n
            elif want_update.abs().max().item() >= moved:
                assert (diff <= 0.01 * lr).double().mean().item() >= 0.99, n
                held += 1
            else:
                assert n.endswith("conv.bias"), (n, want_update.abs().max().item())
        assert held >= len(start) // 2, held
