"""Ranks of a gloo process group on the CPU for tests/test_torch_parallel.py,
tests/test_torch_tensor_parallel.py and tests/test_torch_sequence_parallel.py.

``run_group(world, task, *args)`` spawns ``world`` processes, each of which
sets the launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` of a free localhost port), starts the
group through the port's ``init_distributed`` with one intra-op thread,
runs ``task(rank, world, *args)`` (a function of this module, found by its
name) and sends back what it returns. The parent waits ``timeout``
seconds for every rank and fails on a rank's error or a hang.

This module imports torch and the port only: the spawned ranks do not pay
for JAX.
"""

import functools
import os
import pickle
import queue
import shutil
import socket
import tempfile
import time
import traceback
import types
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from vq_voice_swap_torch.data import ChunkWriter
from vq_voice_swap_torch.data.datasets import ToneDataset
from vq_voice_swap_torch.data.loader import DataLoader
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.parallel import (GradBuffer, StepSync, cut_axes, data_rank, data_size,
                                          full_tensor_tp, init_distributed, init_grid,
                                          shard_model_fsdp, shard_model_tp, shard_optimizer_like,
                                          shard_params_like, shard_train_state)
from vq_voice_swap_torch.parallel.dist import local_tensor
from vq_voice_swap_torch.train import (EMA, TrainStep, VQUpdateRule, VQVAETrainLoop,
                                       build_optimizer, loops)
from vq_voice_swap_torch.util import step_generator
from vq_voice_swap_torch.vq import VQLossConfig
from vq_voice_swap_torch.vq_vae import VQVAE

# The shallow class-conditional VQ-VAE of tests/test_torch_train.py: two
# UNet levels of one block, base 4, 16 codes of 16 channels, 256 samples.
BASE, COND_MULT, CODES, LABELS, T = 4, 4, 16, 3, 256
SHALLOW = dict(channel_mult=(1, 2), depth_mult=1)
VQ_ARGS = dict(class_cond=True, commitment_coeff=0.25, revival_coeff=0.0, jitter=0.2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_vqvae(dropout: float = 0.0, dead_rate: int = 4) -> VQVAE:
    model = VQVAE(pred_name="unet", base_channels=BASE, enc_name="unet", cond_mult=COND_MULT,
                  dictionary_size=CODES, num_labels=LABELS, dropout=dropout, dead_rate=dead_rate)
    model.predictor = UNetPredictor(base_channels=BASE, middle_dilations=(4,),
                                    cond_channels=BASE * COND_MULT, num_labels=LABELS,
                                    **SHALLOW)
    model.encoder = UNetEncoder(base_channels=BASE, out_channels=BASE * COND_MULT, **SHALLOW)
    return model


def loop_stub(model):
    """What VQVAETrainLoop's build_loss_fn and build_drawer read."""
    args = types.SimpleNamespace(**VQ_ARGS)
    return types.SimpleNamespace(model=model, args=args, vq_loss_config=lambda: VQLossConfig(
        commitment=args.commitment_coeff, revival=args.revival_coeff))


def vq_train_step(model, opt, emas, micro_remainder: int, revive: bool = True,
                  sync=None) -> TrainStep:
    stub = loop_stub(model)
    return TrainStep(model, VQVAETrainLoop.build_loss_fn(stub), opt, emas,
                     microbatches=1, micro_remainder=micro_remainder,
                     vq_rule=VQUpdateRule(dead_rate=4, revive=revive),
                     drawer=VQVAETrainLoop.build_drawer(stub), sync=sync)


OPT = dict(lr=1e-3, lr_final=5e-4, lr_anneal_steps=2, grad_clip=0.5)


def _numpy(t: torch.Tensor, axis=None) -> np.ndarray:
    """``t`` whole (an FSDP shard gathered; a model shard cut along
    ``axis`` gathered over the model group)."""
    return full_tensor_tp(t, axis).cpu().numpy().copy()


# ---------------------------------------------------------------- tasks


def step_parity(rank: int, world: int, state: Dict[str, np.ndarray],
                batch: Dict[str, np.ndarray], steps: int) -> List[Dict[str, Any]]:
    """``steps`` train steps of this rank's rows (``r::world``) of the
    global batch, microbatch chunks 2 + 1 a rank, one EMA, under DP and
    then under FSDP: each step's metrics, the first step's gradients
    (whole), and the final state."""
    return [_steps(rank, world, state, batch, steps, fsdp) for fsdp in (False, True)]


def fsdp_remat(rank: int, world: int, state: Dict[str, np.ndarray],
               batch: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """One FSDP step without remat, then with ``full`` and ``convs``."""
    return [_steps(rank, world, state, batch, 1, True, remat) for remat in (False, "full", "convs")]


def _steps(rank, world, state, batch, steps, fsdp, remat=False):
    from torch.distributed.tensor import DTensor

    model = tiny_vqvae()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.set_remat(remat)
    opt = build_optimizer(model, **OPT)
    ema = EMA(model, 0.9)
    if fsdp:
        opt = _shard(model, opt, world)
        shard_params_like(ema.model, model)
    opt.grad_buffer = GradBuffer(opt.params)
    step = vq_train_step(model, opt, [ema], micro_remainder=1, sync=StepSync(opt.grad_buffer))
    out = record_steps(step, ema, {k: v[rank::world] for k, v in batch.items()}, steps)
    out["sharded"] = sorted(n for n, p in model.named_parameters() if isinstance(p, DTensor))
    out["local_numel"] = sum(local_tensor(p).numel() for p in model.parameters())
    return out


def record_steps(step: TrainStep, ema: EMA, batch: Dict[str, np.ndarray],
                 steps: int, axes: Dict[str, int] = {}) -> Dict[str, Any]:
    """Run ``steps`` steps of ``step`` on ``batch``, step i drawing from
    its (seed 0, i) generator: each step's metrics, the first step's
    gradients, and the final parameters, EMA and usage counts, whole
    (``axes``: the model shards' axes by name)."""
    model = step.model
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch["label"] = batch["label"].long()
    out: Dict[str, Any] = {"metrics": []}
    for i in range(steps):
        m = step(batch, step_generator(0, i, torch.device("cpu")))
        out["metrics"].append({"loss": m["loss"].item(), "vq_loss": m["extra"]["vq_loss"].item(),
                               "mses": m["mses"].numpy(), "ts": m["ts"].numpy(),
                               "codebook_used": int(m["codebook_used"])})
        if i == 0:
            out["grads"] = {n: _numpy(p.grad, axes.get(n)) for n, p in model.named_parameters()
                            if p.grad is not None}
    out["params"] = {n: _numpy(p, axes.get(n)) for n, p in model.named_parameters()}
    out["ema"] = {n: _numpy(p, axes.get(n)) for n, p in ema.model.named_parameters()}
    out["usage"] = model.vq.usage_count.numpy().copy()
    return out


def _shard(model, opt, world):
    """FSDP as the loop shards: the model, then AdamW over its shards."""
    names = {id(p): n for n, p in model.named_parameters()}
    opt_names = [names[id(p)] for p in opt.params]
    shard_model_fsdp(model, world)
    return shard_optimizer_like(opt, [model.get_parameter(n) for n in opt_names])


def jax_fsdp_step(rank: int, world: int, state: Dict[str, np.ndarray],
                  batch: Dict[str, np.ndarray], draws: Dict[str, np.ndarray]) -> float:
    """One FSDP step on given global draws (each rank keeps its rows), no
    microbatches and no revival: the step's loss."""
    model = tiny_vqvae()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = _shard(model, build_optimizer(model, lr=1e-3), world)
    opt.grad_buffer = GradBuffer(opt.params)
    step = vq_train_step(model, opt, [], micro_remainder=0, revive=False,
                         sync=StepSync(opt.grad_buffer))
    local = {k: torch.from_numpy(v[rank::world]) for k, v in batch.items()}
    local["label"] = local["label"].long()
    mine = {k: torch.from_numpy(v[rank::world]) for k, v in draws.items()}
    return step(local, None, draws=[mine])["loss"].item()


def _short_data(directory, batch_size, encoding="linear", seed=0, shard_index=0,
                num_shards=1, num_samples=T):
    """``tones`` at ``num_samples`` (256) samples a clip."""
    return DataLoader(ToneDataset(num_samples=num_samples), batch_size, seed=seed,
                      shard_index=shard_index, num_shards=num_shards), LABELS


def _patch_tiny_loop():
    """Train loops of this process on the shallow VQ-VAE and 256-sample
    tones (the loop's seeded init, not the tests' weights), new or
    resumed."""
    loops.create_data_loader = _short_data
    loops.VQVAETrainLoop.create_new_model = lambda self: tiny_vqvae()
    # Resumes too: the shallow UNet is not in the saved kwargs.
    ModelBase.from_manifest = classmethod(lambda cls, name, kwargs: tiny_vqvae())


def loop_runs(rank: int, world: int, root: str, runs: List[List[str]],
              copies: Dict[str, str]) -> None:
    """Each argv of ``runs`` (the output dir first), through the train
    loop; ``copies`` {dst: src} copies a run directory (on rank 0, after
    the run that writes src) before the run that reads dst."""
    import torch.distributed as dist

    _patch_tiny_loop()
    for argv in runs:
        out = os.path.join(root, argv[0])
        for dst, src in copies.items():
            if dst == argv[0] and rank == 0:
                shutil.copytree(os.path.join(root, src), out)
        dist.barrier()
        args = VQVAETrainLoop.arg_parser().parse_args(
            ["--device", "cpu", "--output-dir", out, "--class-cond", "--ema-rate", "0.9",
             *argv[1:], "tones"])
        VQVAETrainLoop(args).loop()
        dist.barrier()


def six_loops(rank: int, world: int, root: str, flags: Tuple[str, ...] = ("--fsdp",)) -> None:
    """One step of each of the six train loops at base 2 with ``flags``
    and --checkpoint-format dcp (the VQ-VAE they start from with npz)."""
    from vq_voice_swap_torch import (train_classifier, train_diffusion, train_enc_pred,
                                     train_vqvae, train_vqvae_add, train_vqvae_uncond)

    base = ["--device", "cpu", "--batch-size", "1", "--max-steps", "1", "--save-interval", "1",
            *flags]
    vqvae = os.path.join(root, "vqvae", "model.npz")
    runs = [
        (train_vqvae, ["--base-channels", "2", "--class-cond", "--dictionary-size", "8"],
         "vqvae"),
        (train_vqvae, ["--base-channels", "2", "--predictor", "wavegrad", "--encoder",
                       "wavegrad", "--checkpoint-format", "dcp"], "wavegrad"),
        (train_diffusion, ["--base-channels", "2", "--checkpoint-format", "dcp"], "diffusion"),
        (train_classifier, ["--base-channels", "2", "--checkpoint-format", "dcp"],
         "classifier"),
        (train_enc_pred, ["--base-channels", "2", "--vq-vae-path", vqvae,
                          "--checkpoint-format", "dcp"], "enc_pred"),
        (train_vqvae_add, ["--class-cond", "--pretrained-path", vqvae,
                           "--checkpoint-format", "dcp"], "add"),
        (train_vqvae_uncond, ["--class-cond", "--pretrained-path", vqvae,
                              "--checkpoint-format", "dcp"], "uncond"),
    ]
    for cli, argv, name in runs:
        # The classifier's stem pools a 256-sample clip to nothing.
        loops.create_data_loader = functools.partial(
            _short_data, num_samples=512 if name == "classifier" else T)
        cli.main(base + argv + ["--output-dir", os.path.join(root, name), "tones"])


# ------------------------------------------------------ tensor parallelism

CPU = torch.device("cpu")


def tp_suite(rank: int, world: int, parts: List[List[Any]]) -> List[Any]:
    """Run several tasks of this module in one spawned world, in order:
    ``parts`` is [[task name, *args], ...]; returns their results."""
    out = []
    for task, *args in parts:
        out.append(globals()[task](rank, world, *args))
        init_grid(1)
    return out


def tp_predictor(kind: str) -> torch.nn.Module:
    """The predictors of the forward checks: a shallow UNet (cond and
    labels) or a WaveGrad at base 4 (labels, cond_mult 2)."""
    from vq_voice_swap_torch.models.wavegrad import WaveGradPredictor

    if kind == "unet":
        return UNetPredictor(base_channels=BASE, middle_dilations=(4,), cond_channels=2 * BASE,
                             num_labels=LABELS, **SHALLOW)
    return WaveGradPredictor(base_channels=BASE, cond_mult=2, num_labels=LABELS)


def tp_forwards(rank: int, world: int, model_sizes: List[int],
                states: Dict[str, Dict[str, np.ndarray]],
                inputs: Dict[str, Dict[str, np.ndarray]]) -> Dict[int, Dict[str, np.ndarray]]:
    """{T: {kind: the predictor's output}} with its weights cut over model
    groups of T ranks (``states`` and ``inputs`` by kind)."""
    out = {}
    for size in model_sizes:
        init_grid(size, CPU)
        out[size] = {}
        for kind, state in states.items():
            model = tp_predictor(kind)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            shard_model_tp(model)
            with torch.no_grad():
                out[size][kind] = model(**{k: torch.from_numpy(v) for k, v in
                                           inputs[kind].items()}).numpy()
    return out


def place_tp(model, emas, opt, fsdp: bool):
    """``shard_train_state`` on the grid with the optimizer's gradient
    buffer, as the train loop places a run."""
    names = [n for n, _ in model.named_parameters()]
    opt = shard_train_state(model, emas, opt, names, fsdp)
    cut = cut_axes(model)
    opt.grad_buffer = GradBuffer(opt.params, [n in cut for n in names])
    return opt


def tp_steps(rank: int, world: int, model_size: int, state: Dict[str, np.ndarray],
             batch: Dict[str, np.ndarray], steps: int) -> List[Dict[str, Any]]:
    """``steps`` train steps on a grid of ``model_size`` columns, this data
    row's rows (``d::D``) of the global batch, microbatch chunks 2 + 1 a
    data row, one EMA: without and then with FSDP over the data rows."""
    init_grid(model_size, CPU)
    out = []
    for fsdp in (False, True):
        model = tiny_vqvae()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        ema = EMA(model, 0.9)
        opt = place_tp(model, [ema], build_optimizer(model, **OPT), fsdp)
        step = vq_train_step(model, opt, [ema], micro_remainder=1, sync=StepSync(opt.grad_buffer))
        rows = {k: v[data_rank()::data_size()] for k, v in batch.items()}
        axes = cut_axes(model)
        res = record_steps(step, ema, rows, steps, axes)
        res["cut"] = sorted(axes)
        res["local_numel"] = sum(local_tensor(p).numel() for p in model.parameters())
        out.append(res)
    return out


def tp_whole_agree(rank: int, world: int, model_size: int, state: Dict[str, np.ndarray],
                   batch: Dict[str, np.ndarray]) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """One train step on a grid of ``model_size`` columns whose ranks'
    gradients differ before the reduction (each rank adds its own noise,
    as a backward's atomic sums round differently on the card), without
    and then with FSDP: the whole leaves' parameters and EMA copies after
    it, gathered over the data group."""
    init_grid(model_size, CPU)
    out = []
    for fsdp in (False, True):
        model = tiny_vqvae()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        ema = EMA(model, 0.9)
        opt = place_tp(model, [ema], build_optimizer(model, **OPT), fsdp)
        buf, reduce = opt.grad_buffer, opt.grad_buffer.all_reduce
        noise = torch.Generator().manual_seed(rank)

        def noisy_reduce():
            for p in model.parameters():
                if p.grad is not None:
                    g = local_tensor(p.grad)
                    g.add_(1e-4 * g.abs().max() * torch.randn(g.shape, generator=noise))
            reduce()

        buf.all_reduce = noisy_reduce
        step = vq_train_step(model, opt, [ema], micro_remainder=1, sync=StepSync(buf))
        rows = {k: v[data_rank()::data_size()] for k, v in batch.items()}
        res = record_steps(step, ema, rows, 1)
        cut = cut_axes(model)
        out.append({k: {n: v for n, v in res[k].items() if n not in cut}
                    for k in ("params", "ema")})
    return out


def tp_jax_step(rank: int, world: int, model_size: int, state: Dict[str, np.ndarray],
                batch: Dict[str, np.ndarray], draws: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """One step on a grid of ``model_size`` columns on given global draws
    (each data row keeps its rows), no microbatches and no revival: the
    step's loss, and the parameters and AdamW first moments after it,
    whole."""
    init_grid(model_size, CPU)
    model = tiny_vqvae()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = place_tp(model, [], build_optimizer(model, lr=1e-3), False)
    step = vq_train_step(model, opt, [], micro_remainder=0, revive=False,
                         sync=StepSync(opt.grad_buffer))
    rows = slice(data_rank(), None, data_size())
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    local["label"] = local["label"].long()
    mine = {k: torch.from_numpy(v[rows]) for k, v in draws.items()}
    loss = step(local, None, draws=[mine])["loss"].item()
    axes = cut_axes(model)
    named = list(model.named_parameters())
    return dict(loss=loss, params={n: _numpy(p, axes.get(n)) for n, p in named},
                exp_avg={n: _numpy(opt.adamw.state[p]["exp_avg"], axes.get(n))
                         for n, p in named})


def tp_refusal(rank: int, world: int, model_size: int) -> str:
    """The ValueError of a grid of ``model_size`` columns."""
    try:
        init_grid(model_size, CPU)
    except ValueError as e:
        return str(e)
    return "no error"


def tiny_diffusion(fuse_levels: int = 0, act_int8_min_t: int = 0) -> DiffusionModel:
    """An unconditional diffusion model of the shallow UNet at base 4."""
    model = DiffusionModel(pred_name="unet", base_channels=BASE, act_int8_min_t=act_int8_min_t)
    model.predictor = UNetPredictor(base_channels=BASE, middle_dilations=(4,),
                                    fuse_levels=fuse_levels, act_int8_min_t=act_int8_min_t,
                                    **SHALLOW)
    return model


def tiny_from_manifest(cls, name, kwargs):
    """``ModelBase.from_manifest`` for the shallow test models' checkpoints."""
    if name == "VQVAE":
        return tiny_vqvae()
    return tiny_diffusion(kwargs.get("fuse_levels", 0), kwargs.get("act_int8_min_t", 0))


class RecordingWriter(ChunkWriter):
    """A ChunkWriter that also saves the float samples it writes, as
    ``<path>.npy`` (``path`` less sample_diffusion's ``.tmp.wav``)."""

    def write(self, samples):
        np.save(self.path.removesuffix(".tmp.wav") + ".npy", np.asarray(samples, np.float32))
        return super().write(samples)


def sampling_runs(rank: int, world: int, runs: List[List[Any]]) -> None:
    """Each [sampling CLI module name, argv] through its main on the CPU,
    its files written through RecordingWriter and its checkpoints read as
    the shallow test models."""
    import importlib

    saved = ModelBase.__dict__["from_manifest"]
    ModelBase.from_manifest = classmethod(tiny_from_manifest)
    try:
        for name, argv in runs:
            module = importlib.import_module(f"vq_voice_swap_torch.{name}")
            module.ChunkWriter = RecordingWriter
            module.main(["--device", "cpu", *argv])
    finally:
        ModelBase.from_manifest = saved


# ---------------------------------------------------- sequence parallelism


def seq_module(kind: str) -> torch.nn.Module:
    """The modules of the sequence-parallel checks, at JAX's test widths
    (tests/test_sequence_parallel.py): the UNet encoder (base 4, two
    levels, an out dilation 2); the UNet predictor with cond and labels
    ("unet"), unconditional ("unet_plain", the samplers') and with labels
    ("unet_labels", the train step's); WaveGrad at base 2, cond_mult 4."""
    from vq_voice_swap_torch.models.wavegrad import WaveGradEncoder, WaveGradPredictor

    unet = dict(base_channels=BASE, middle_dilations=(2,), **SHALLOW)
    return {
        "unet_encoder": lambda: UNetEncoder(base_channels=BASE, out_channels=8,
                                            out_dilations=(2,), **SHALLOW),
        "unet": lambda: UNetPredictor(cond_channels=8, num_labels=LABELS, **unet),
        "unet_plain": lambda: UNetPredictor(**unet),
        "unet_labels": lambda: UNetPredictor(num_labels=LABELS, **unet),
        "wavegrad": lambda: WaveGradPredictor(base_channels=2, cond_mult=4, num_labels=LABELS),
        "wavegrad_encoder": lambda: WaveGradEncoder(base_channels=2, cond_mult=4),
    }[kind]()


def _loaded(kind: str, state: Dict[str, np.ndarray]) -> torch.nn.Module:
    model = seq_module(kind) if kind != "vqvae" else tiny_vqvae()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def seq_suite(rank: int, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """Every sequence-parallel check of one spawned world, each input the
    whole sequence cut to this rank's shard; every output gathered whole.
    ``spec``: "blocks", "models", "samplers", "convert", "train", "cli"
    (see tests/test_torch_sequence_parallel.py)."""
    import torch.distributed as dist

    from vq_voice_swap_torch import long_audio_convert
    from vq_voice_swap_torch.diffusion import Diffusion, make_schedule
    from vq_voice_swap_torch.parallel import sequence as sq
    from vq_voice_swap_torch.train import build_optimizer

    mesh = sq.create_seq_mesh()
    t = torch.from_numpy

    def cut(x, axis=1):  # this rank's shard along ``axis``
        return sq.shard_sequence(mesh, t(x).movedim(axis, 1)).movedim(1, axis).contiguous()

    def whole(x, axis=1):
        return sq.gather_sequence(mesh, x.movedim(axis, 1)).movedim(1, axis).detach().numpy()

    out: Dict[str, Any] = {}
    b = spec["blocks"]
    out["conv"] = {d: whole(sq.seq_sharded_conv1d(mesh, cut(b["conv_x"], 2), t(b["conv_w"]),
                                                  t(b["conv_b"]), dilation=d), 2)
                   for d in b["dilations"]}
    for key in ("gn", "gn_large"):
        out[key] = whole(sq.seq_sharded_group_norm(
            mesh, cut(b[key + "_x"], 2), t(b["gn_scale"]), t(b["gn_bias"]), b["groups"]), 2)
    # The split backward: GroupNorm + FiLM + GELU, every input requiring grad.
    x = cut(b["bwd_x"], 2).requires_grad_()
    leaves = [t(b[k]).clone().requires_grad_() for k in ("gn_scale", "gn_bias", "ca", "cb")]
    y = sq.seq_sharded_group_norm(mesh, x, leaves[0], leaves[1], b["groups"], use_gelu=True,
                                  film=(leaves[2], leaves[3]))
    (y * cut(b["bwd_dy"], 2)).sum().backward()
    sums = torch.stack([torch.cat([v.grad.reshape(-1) for v in leaves])])
    dist.all_reduce(sums)
    out["gn_bwd"] = dict(dx=whole(x.grad, 2), leaves=sums[0].numpy())
    out["pool"] = whole(sq.seq_sharded_avg_pool(mesh, cut(b["pool_x"], 2), 2), 2)
    out["upsample"] = whole(sq.seq_sharded_upsample(mesh, cut(b["pool_x"], 2), 2), 2)
    # halo_exchange's gradient: sum(halo(x) * w), w [R, N, C, Tl + left + right].
    x = cut(b["halo_x"], 2).requires_grad_()
    (sq.halo_exchange(x, *b["halo"], mesh) * t(b["halo_w"][rank])).sum().backward()
    out["halo_grad"] = whole(x.grad, 2)
    try:
        sq.halo_exchange(x, x.shape[-1] + 1, 0, mesh)
        out["wide_halo"] = "no error"
    except ValueError as e:
        out["wide_halo"] = str(e)

    with torch.no_grad():
        out["models"] = {}
        for kind, (state, inputs) in spec["models"].items():
            model = _loaded(kind, state)
            args = {k: (cut(v) if k in ("x", "cond") else t(v)) for k, v in inputs.items()}
            if kind.endswith("encoder"):
                fn = (sq.seq_parallel_unet_encoder if kind.startswith("unet")
                      else sq.seq_parallel_wavegrad_encoder)
                got = fn(mesh, model, args["x"])
            else:
                got = sq.seq_parallel_predictor(mesh, model, **args)
            out["models"][kind] = whole(got)

        sp = spec["samplers"]
        model, diffusion = _loaded("unet_plain", sp["state"]), Diffusion(make_schedule("exp"))
        out["samplers"] = {}
        for sampler in ("ddpm", "ddim", "dpmpp"):
            gen = torch.Generator().manual_seed(sp["seed"])
            got = sq.seq_parallel_sample(mesh, diffusion, model, cut(sp["x_T"]), sp["steps"],
                                         gen, sampler=sampler, constrain=True)
            out["samplers"][sampler] = whole(got)

        cv = spec["convert"]
        model = _loaded("vqvae", cv["state"])
        gen = torch.Generator().manual_seed(cv["seed"])
        got = sq.seq_parallel_vqvae_convert(mesh, model, cut(cv["x"]), gen,
                                            labels=t(cv["labels"]), steps=cv["steps"],
                                            sampler="dpmpp", constrain=True)
        out["convert"] = whole(got)

    tr = spec["train"]
    model = _loaded("unet_labels", tr["state"])
    opt = build_optimizer(model, lr=1e-3)
    step = sq.make_seq_parallel_train_step(mesh, Diffusion(make_schedule("exp")), model, opt)
    gen = torch.Generator().manual_seed(tr["seed"])
    loss, losses = step(cut(tr["x"]), labels=t(tr["labels"]), generator=gen)
    out["train"] = dict(loss=loss.item(), losses=losses.numpy(),
                        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                        params={n: p.detach().numpy().copy()
                                for n, p in model.named_parameters()})

    saved = ModelBase.__dict__["from_manifest"]
    ModelBase.from_manifest = classmethod(tiny_from_manifest)
    try:
        out["cli"] = long_audio_convert.main(spec["cli"] + ["--device", "cpu"])
    finally:
        ModelBase.from_manifest = saved
    out["collectives"] = dict(sq.COLLECTIVES)
    return out


# ---------------------------------------------------------------- spawning


def _entry(rank: int, world: int, port: int, task: str, args_path: str, results) -> None:
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        torch.set_num_threads(1)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        init_distributed("cpu", timeout_s=120)
        results.put((rank, "ok", globals()[task](rank, world, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_group(world: int, task: str, *args, timeout: float = 240.0) -> List[Any]:
    """Run ``task`` on ``world`` spawned gloo ranks; the results in rank
    order. Raises on any rank's error, or after ``timeout`` seconds.
    ``args`` reach the ranks through a file: sent with each process, they
    would hold its start until the one before had imported this module."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    tmp = tempfile.mkdtemp()
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_entry, args=(r, world, port, task, args_path, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                r, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"{task}: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{task}: {world - len(got)} of {world} ranks gave no "
                                       f"result in {timeout} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"{task}: rank {r} failed:\n{value}")
            got[r] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp)
    return [got[r] for r in range(world)]
