"""The port's other train loops against the JAX package on the CPU: label
surgery (``add_labels``, ``label_parameter_paths``), the classifier's warm
start from a predictor (``load_from_predictor``), the timestep curriculum,
the flax-mirroring init of the guidance networks, the losses and
gradients of the add-classes, uncond, classifier and encoder-predictor
loops against each JAX loop's ``build_loss_fn`` on the same draws, and one
whole add-classes step against ``make_train_step`` with JAX's frozen
predicate.

The models are shallow (two levels, one block each; see
``test_torch_train.py``), seeded in the port and exported with
``params_to_jax``. Tolerances are ``test_torch_train.py``'s: losses within
1e-5 relative, each gradient leaf within 2e-4 of its largest entry plus
1e-7.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_train import (BASE, CODES, COND_MULT, LABELS, SHALLOW, T, _assert_grads_close,
                              _audio, _jax_variables, _seed_weights, _shallow, _torch_grads,
                              _vqvae, _vqvae_draws)

from vq_voice_swap_tpu import vq as jvq
from vq_voice_swap_tpu.classifier_model import ClassifierModel as JaxClassifierModel
from vq_voice_swap_tpu.classifier_model import EncoderPredictorModel as JaxEncPredModel
from vq_voice_swap_tpu.diffusion_model import DiffusionModel as JaxDiffusionModel
from vq_voice_swap_tpu.train import loops as jax_loops
from vq_voice_swap_tpu.train import steps as jax_steps
from vq_voice_swap_tpu.train.ema import build_rate_tree
from vq_voice_swap_tpu.train.state import TrainState
from vq_voice_swap_tpu.train.state import build_optimizer as jax_build_optimizer
from vq_voice_swap_tpu.vq_vae import VQVAE as JaxVQVAE
from vq_voice_swap_torch.classifier_model import ClassifierModel, EncoderPredictorModel
from vq_voice_swap_torch.convert import params_from_jax, torch_key
from vq_voice_swap_torch.diffusion_model import DiffusionModel, add_labels_to_params
from vq_voice_swap_torch.models.init import init_like_flax
from vq_voice_swap_torch.models.unet import UNetPredictor
from vq_voice_swap_torch.train import (EMA, ClassifierTrainLoop, EncoderPredictorTrainLoop,
                                       TrainStep, VQUpdateRule, VQVAEAddClassesTrainLoop,
                                       VQVAETrainLoop, VQVAEUncondTrainLoop, build_optimizer)
from vq_voice_swap_torch.vq import VQLossConfig
from vq_voice_swap_torch.vq_vae import VQVAE

GUIDANCE = dict(base_channels=BASE, **SHALLOW)


def _vq_stub(model, **args):
    """What the VQ-VAE loops' build_loss_fn reads off the loop."""
    args = types.SimpleNamespace(class_cond=True, commitment_coeff=0.25, revival_coeff=0.0,
                                 jitter=0.2, **args)
    return types.SimpleNamespace(
        model=model, args=args,
        vq_loss_config=lambda: VQLossConfig(commitment=0.25, revival=0.0))


def _jax_stub(model, **args):
    stub = _vq_stub(model, **args)
    stub.vq_loss_config = lambda: jvq.VQLossConfig(commitment=0.25, revival=0.0)
    return stub


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k == "label"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -------------------------------------------------------- label surgery


def _labelled_models():
    """A VQ-VAE (full topology at base 2: one class_embed table) and a
    WaveGrad diffusion model (fifteen FiLM label_emb tables), seeded; with
    their JAX twins and variables."""
    out = []
    for cls, jax_cls, kwargs in (
        (VQVAE, JaxVQVAE, dict(pred_name="unet", base_channels=2, enc_name="unet",
                               dictionary_size=CODES, num_labels=LABELS)),
        (DiffusionModel, JaxDiffusionModel, dict(pred_name="wavegrad", base_channels=BASE,
                                                 num_labels=LABELS)),
    ):
        model = cls(**kwargs)
        _seed_weights(model, len(out))
        out.append((model, jax_cls(**kwargs), _jax_variables(model)))
    return out


@pytest.mark.parametrize("end", [True, False])
def test_add_labels_matches_jax(end):
    """The same label tables, grown at the same end, with the new rows the
    JAX surgery drew passed in; every other leaf kept."""
    for model, jax_model, variables in _labelled_models():
        jax_paths = jax_model.label_parameter_paths(variables)
        assert [torch_key("params/" + p) for p in jax_paths] == model.label_parameter_paths()
        assert len(jax_paths) == (1 if model.pred_name == "unet" else 15)
        jax_grown, jax_vars = jax_model.add_labels(variables, 2, end=end)
        want = params_from_jax({"/".join(k): np.asarray(v) for k, v in
                                traverse_util.flatten_dict(jax_vars).items()})
        rows = {}
        for name in model.label_parameter_paths():
            rows[name] = want[name][LABELS:] if end else want[name][:2]
        grown = model.add_labels(2, end=end, new_rows=rows)
        assert type(grown) is type(model) and grown.num_labels == jax_grown.num_labels == 5
        got = grown.state_dict()
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert torch.equal(got[name], w), name
        kept = slice(0, LABELS) if end else slice(2, None)
        for name in model.label_parameter_paths():
            assert torch.equal(got[name][kept], model.state_dict()[name])


def test_add_labels_draws_standard_normal_rows_from_fresh_entropy():
    model = _labelled_models()[0][0]
    name = model.label_parameter_paths()[0]
    a = model.add_labels(200).state_dict()[name][LABELS:]
    b = model.add_labels(200).state_dict()[name][LABELS:]
    assert not torch.equal(a, b)  # two surgeries, two sets of rows
    assert abs(a.mean().item()) < 0.1 and abs(a.std().item() - 1.0) < 0.1
    seeded = [model.add_labels(2, generator=torch.Generator().manual_seed(5)) for _ in "ab"]
    assert torch.equal(seeded[0].state_dict()[name], seeded[1].state_dict()[name])
    with pytest.raises(ValueError, match="class-conditional"):
        DiffusionModel(pred_name="unet", base_channels=BASE).add_labels(1)


# ----------------------------------------------------- classifier warm start


def _predictor_and_classifier(pred_base: int):
    predictor = UNetPredictor(base_channels=pred_base, middle_dilations=(4,), **SHALLOW)
    _seed_weights(predictor, 2)
    classifier = ClassifierModel(num_labels=LABELS, **GUIDANCE)
    _seed_weights(classifier, 3)
    jax_classifier = JaxClassifierModel(num_labels=LABELS, **GUIDANCE)
    return predictor, classifier, jax_classifier


def test_load_from_predictor_matches_jax():
    """The stem takes the predictor's in_conv, time embeddings and its down
    blocks index for index (the stem's last downsample block has no
    counterpart): the same scalar count and values as the JAX package's."""
    predictor, classifier, jax_classifier = _predictor_and_classifier(BASE)
    pred_params = _jax_variables(predictor)["params"]
    jax_vars, want_n = jax_classifier.load_from_predictor(_jax_variables(classifier),
                                                          pred_params)
    before = {k: v.clone() for k, v in classifier.state_dict().items()}
    n = classifier.load_from_predictor(predictor)
    assert n == want_n > 0
    want = _torch_grads(jax_vars["params"])
    got = classifier.state_dict()
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    moved = [k for k in got if not torch.equal(got[k], before[k])]
    assert sum(got[k].numel() for k in moved) == n
    assert "stem.block.2.conv_out.conv.weight" in moved
    assert not any(k.startswith(("stem.block.3.", "head.", "stem.pool.")) for k in moved)


def test_load_from_predictor_refuses_a_shape_mismatch():
    predictor, classifier, jax_classifier = _predictor_and_classifier(2 * BASE)
    message = "has shape .* but the classifier stem expects"
    with pytest.raises(ValueError, match=message):
        jax_classifier.load_from_predictor(_jax_variables(classifier),
                                           _jax_variables(predictor)["params"])
    with pytest.raises(ValueError, match=message):
        classifier.load_from_predictor(predictor)


# --------------------------------------------------------------- curriculum


@pytest.mark.parametrize("step", [0, 1, 7, 10, 25])
def test_curriculum_power_matches_jax(step):
    args = types.SimpleNamespace(curriculum_start=30.0, curriculum_steps=10)
    stub = types.SimpleNamespace(total_steps=step, args=args)
    want = jax_loops._CurriculumMixin.curriculum_power(stub)
    assert ClassifierTrainLoop.curriculum_power(stub) == want
    stub.curriculum_power = lambda: ClassifierTrainLoop.curriculum_power(stub)
    batch = EncoderPredictorTrainLoop.prepare_batch(stub, {"samples": np.zeros((1, 4))})
    assert batch["ts_power"].dtype == np.float32 and batch["ts_power"] == np.float32(want)
    assert (want == 1.0) == (step >= 10)


def test_microbatches_pass_the_curriculum_power_whole():
    """A batch of 5 as two microbatches of 2 and a remainder of 1: each
    chunk's rows and weight, the scalar curriculum power in every chunk."""
    step = TrainStep(torch.nn.Linear(1, 1), None, None, microbatches=2, micro_remainder=1)
    batch = {"samples": torch.arange(5.0)[:, None].expand(5, 4), "label": torch.arange(5),
             "ts_power": torch.tensor(3.0)}
    chunks = step.chunks(batch)
    assert [w for w, _ in chunks] == [0.4, 0.4, 0.2]
    assert [c["label"].tolist() for _, c in chunks] == [[0, 1], [2, 3], [4]]
    assert all(c["ts_power"] is batch["ts_power"] for _, c in chunks)


# ---------------------------------------------------------------------- init


@pytest.mark.parametrize("which", ["classifier", "encoder predictor"])
def test_init_mirrors_flax(which):
    """A fresh guidance network against flax's init of the same structure
    (shallow, base 32): the same leaves, zero exactly where flax's are (the
    classifier's head, the ResBlock output convs, the biases), and each
    leaf of 1000 or more entries with a standard deviation within 10% of
    flax's."""
    kwargs = dict(base_channels=32, **SHALLOW)
    if which == "classifier":
        model, jax_model = (cls(num_labels=LABELS, **kwargs)
                            for cls in (ClassifierModel, JaxClassifierModel))
    else:
        model, jax_model = (cls(downsample_rate=2, num_latents=CODES, **kwargs)
                            for cls in (EncoderPredictorModel, JaxEncPredModel))
    init_like_flax(model, torch.Generator().manual_seed(0))
    variables = jax_model.init_variables(jax.random.key(0))
    want = _torch_grads(variables["params"])
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    checked = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if not w.any():
            assert not g.any(), name
            continue
        if w.numel() >= 1000:
            ratio = g.std().item() / w.std().item()
            assert abs(ratio - 1.0) < 0.1, (name, ratio)
            checked += 1
    assert checked >= 8
    if which == "classifier":
        assert not model.head.weight.any() and model.stem.pool.qkv_proj.conv.weight.any()


# ------------------------------------------------------ losses and gradients


def _grown_vqvae(seed: int, n_new: int, end: bool = True):
    """A shallow VQ-VAE's weights with its LABELS labels grown by n_new
    (seeded rows) in a shallow VQ-VAE of LABELS + n_new labels, and its JAX
    twin and variables."""
    base, _, _ = _vqvae(seed, 0.0, _audio(4, seed=13))
    state = add_labels_to_params(base.state_dict(), n_new, end=end,
                                 generator=torch.Generator().manual_seed(seed))
    kwargs = dict(pred_name="unet", base_channels=BASE, enc_name="unet", cond_mult=COND_MULT,
                  dictionary_size=CODES, num_labels=LABELS + n_new, dead_rate=4)
    model, jax_model = VQVAE(**kwargs), JaxVQVAE(**kwargs)
    _shallow(model, jax_model, BASE * COND_MULT, LABELS + n_new)
    model.load_state_dict(state)
    return model, jax_model, _jax_variables(model)


def test_uncond_loss_matches_jax():
    """The uncond loop's loss (labels moved up by one and dropped to 0 where
    the keep draw is at most --no-class-prob, codes zeroed by --no-vq-prob,
    jitter) and every gradient, on the JAX draws."""
    model, jax_model, variables = _grown_vqvae(4, 1, end=False)
    args = dict(no_class_prob=0.4, no_vq_prob=0.4)
    batch = {"samples": _audio(3, seed=14)[..., 0], "label": np.array([0, 2, 1], np.int32)}
    key = jax.random.key(15)
    jax_loss = jax_loops.VQVAEUncondTrainLoop.build_loss_fn(_jax_stub(jax_model, **args))
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, variables["buffers"], key, _jax_batch(batch), None),
        has_aux=True))(variables["params"])
    loss_key, mask_key = jax.random.split(key)
    keep = np.array(jax.random.uniform(mask_key, (3,)))
    assert 0 < (keep > 0.4).sum() < 3  # some labels dropped, some kept
    draws = dict(_vqvae_draws(loss_key, 3, T // 2),
                 no_class_nums=torch.from_numpy(keep))
    loss_fn = VQVAEUncondTrainLoop.build_loss_fn(_vq_stub(model, **args))
    got, got_aux = loss_fn(_torch_batch(batch), None, draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_array_equal(got_aux["idxs"].numpy(), np.asarray(aux["idxs"]))
    for k in ("mses", "ts"):
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(aux[k]), rtol=1e-5)
    _assert_grads_close(model, grads)


def test_classifier_loss_matches_jax():
    """The classifier loop's NLL at curriculum timesteps u ** power (power
    2.5) and every gradient, on the JAX draws."""
    model = ClassifierModel(num_labels=LABELS, **GUIDANCE)
    _seed_weights(model, 5)
    jax_model = JaxClassifierModel(num_labels=LABELS, **GUIDANCE)
    stub = types.SimpleNamespace(model=jax_model, args=types.SimpleNamespace(schedule="exp"))
    batch = {"samples": _audio(3, seed=16)[..., 0], "label": np.array([2, 0, 1], np.int32),
             "ts_power": np.asarray(2.5, np.float32)}
    key = jax.random.key(17)
    jax_loss = jax_loops.ClassifierTrainLoop.build_loss_fn(stub)
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, {}, key, _jax_batch(batch), None), has_aux=True))(
        _jax_variables(model)["params"])
    t_key, n_key = jax.random.split(key)
    draws = dict(t_nums=torch.from_numpy(np.array(jax.random.uniform(t_key, (3,)))),
                 noise=torch.from_numpy(np.array(jax.random.normal(n_key, (3, T, 1)))))
    loss_fn = ClassifierTrainLoop.build_loss_fn(types.SimpleNamespace(
        model=model, args=types.SimpleNamespace(schedule="exp")))
    got, got_aux = loss_fn(_torch_batch(batch), None, draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("mses", "ts"):
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(aux[k]), rtol=1e-5)
    _assert_grads_close(model, grads)


def test_encoder_predictor_loss_matches_jax():
    """The encoder-predictor loop's cross-entropy against a frozen VQ-VAE's
    codes (encoded with no grad) and every gradient, on the JAX draws."""
    vq_vae, jax_vq_vae, vq_vars = _vqvae(6, 0.0, _audio(3, seed=18))
    vq_vae.requires_grad_(False)
    kwargs = dict(downsample_rate=vq_vae.encoder.downsample_rate, num_latents=CODES, **GUIDANCE)
    model, jax_model = EncoderPredictorModel(**kwargs), JaxEncPredModel(**kwargs)
    _seed_weights(model, 7)
    batch = {"samples": _audio(3, seed=18)[..., 0], "label": np.array([0, 1, 2], np.int32),
             "ts_power": np.asarray(3.0, np.float32)}
    key = jax.random.key(19)
    jax_loss = jax_loops.EncoderPredictorTrainLoop.build_loss_fn(
        types.SimpleNamespace(model=jax_model, vq_vae=jax_vq_vae))
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, {}, key, _jax_batch(batch), vq_vars), has_aux=True))(
        _jax_variables(model)["params"])
    t_key, n_key = jax.random.split(key)
    draws = dict(t_nums=torch.from_numpy(np.array(jax.random.uniform(t_key, (3,)))),
                 noise=torch.from_numpy(np.array(jax.random.normal(n_key, (3, T, 1)))))
    loss_fn = EncoderPredictorTrainLoop.build_loss_fn(
        types.SimpleNamespace(model=model, vq_vae=vq_vae))
    got, got_aux = loss_fn(_torch_batch(batch), None, draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("mses", "ts"):
        np.testing.assert_allclose(got_aux[k].numpy(), np.asarray(aux[k]), rtol=1e-5)
    _assert_grads_close(model, grads)
    assert all(p.grad is None for p in vq_vae.parameters())


def test_add_classes_loss_and_step_match_jax():
    """The add-classes loop: its loss on the shifted labels and the label
    table's gradient against the JAX loop's, then two whole train steps
    against make_train_step with JAX's frozen predicate (all but the label
    table), one EMA and the codebook's usage counts (no revival): only the
    new rows' labels move, in both packages, by the same updates."""
    new = 2
    model, jax_model, variables = _grown_vqvae(8, new)
    params, buffers = variables["params"], variables["buffers"]
    stub = types.SimpleNamespace(model=model, pretrained_num_labels=LABELS)
    jax_stub = _jax_stub(jax_model)
    jax_stub.variables, jax_stub.pretrained_num_labels = variables, LABELS
    raw = {"samples": _audio(3, seed=20)[..., 0], "label": np.array([1, 0, 1], np.int32)}
    batch = VQVAEAddClassesTrainLoop.prepare_batch(stub, raw)
    jax_batch = jax_loops.VQVAEAddClassesTrainLoop.prepare_batch(jax_stub, raw)
    np.testing.assert_array_equal(batch["label"], jax_batch["label"])
    assert list(batch["label"]) == [4, 3, 4]
    frozen = VQVAEAddClassesTrainLoop.frozen_predicate(stub)
    jax_frozen = jax_loops.VQVAEAddClassesTrainLoop.frozen_predicate(jax_stub)
    names = [n for n, _ in model.named_parameters()]
    assert [n for n in names if not frozen(n)] == ["predictor.class_embed.weight"]
    assert [torch_key("params/" + p) for p in traverse_util.flatten_dict(params, sep="/")
            if not jax_frozen(p)] == ["predictor.class_embed.weight"]

    jax_loss = jax_loops.VQVAETrainLoop.build_loss_fn(jax_stub)
    key = jax.random.key(21)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss(p, buffers, key, _jax_batch(batch), None), has_aux=True))(params)
    lr, rate = 1e-2, 0.9
    opt = build_optimizer(model, lr=lr, frozen_fn=frozen)
    loss_fn = VQVAETrainLoop.build_loss_fn(_vq_stub(model))
    got, _ = loss_fn(_torch_batch(batch), None, _vqvae_draws(key, 3, T // 2))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    table = model.predictor.class_embed.weight
    want_grad = _torch_grads(grads)["predictor.class_embed.weight"]
    assert (table.grad - want_grad).abs().max() <= 2e-4 * want_grad.abs().max() + 1e-7
    assert want_grad[LABELS:].abs().max() > 0 and not want_grad[:LABELS].any()
    assert sum(p.requires_grad for p in model.parameters()) == 1

    tx = jax_build_optimizer(params, lr=lr, frozen_fn=jax_frozen)
    rule = VQUpdateRule(dead_rate=4, revive=False)
    jax_step = jax.jit(jax_steps.make_train_step(
        jax_loss, tx, {str(rate): build_rate_tree(params, {"": rate})},
        vq_rule=jax_steps.VQUpdateRule(dead_rate=4, revive=False), jit=False))
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, buffers=buffers,
                       opt_state=tx.init(params), emas={str(rate): params})
    ema = EMA(model, rate)
    step = TrainStep(model, loss_fn, opt, [ema], vq_rule=rule)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for key in (jax.random.key(22), jax.random.key(23)):
        state, metrics = jax_step(state, _jax_batch(batch), key)
        got = step(_torch_batch(batch), None, draws=[_vqvae_draws(key, 3, T // 2)])
        np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(model.vq.usage_count.numpy(),
                                      np.asarray(state.buffers["vq"]["usage_count"]))
    for tree, module in ((state.params, model), (state.emas[str(rate)], ema.model)):
        want = _torch_grads(tree)
        for n, p in module.named_parameters():
            if n == "predictor.class_embed.weight":
                update, want_update = p.detach() - start[n], want[n] - start[n]
                assert not update[:LABELS].any() and not want_update[:LABELS].any()
                assert want_update[LABELS:].abs().min() > 0
                assert (update - want_update).abs().max() <= 1e-3 * lr, n
            else:  # frozen: neither package moved it
                assert torch.equal(p.detach(), start[n]) and torch.equal(want[n], start[n]), n
