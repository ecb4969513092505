"""Ranks of a gloo process group on the CPU for tests/test_torch_parallel.py.

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
import queue
import shutil
import socket
import time
import traceback
import types
from typing import Any, Dict, List

import numpy as np
import torch

from vq_voice_swap_torch.data.datasets import ToneDataset
from vq_voice_swap_torch.data.loader import DataLoader
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.models.unet import UNetEncoder, UNetPredictor
from vq_voice_swap_torch.parallel import (GradBuffer, StepSync, full_tensor, init_distributed,
                                          shard_model_fsdp, shard_optimizer_like,
                                          shard_params_like)
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


def _numpy(t: torch.Tensor) -> np.ndarray:
    return full_tensor(t).detach().cpu().numpy().copy()


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
                 steps: int) -> Dict[str, Any]:
    """Run ``steps`` steps of ``step`` on ``batch``, step i drawing from
    its (seed 0, i) generator: each step's metrics, the first step's
    gradients, and the final parameters, EMA and usage counts, whole."""
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
            out["grads"] = {n: _numpy(p.grad) for n, p in model.named_parameters()
                            if p.grad is not None}
    out["params"] = {n: _numpy(p) for n, p in model.named_parameters()}
    out["ema"] = {n: _numpy(p) for n, p in ema.model.named_parameters()}
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


def six_loops(rank: int, world: int, root: str) -> None:
    """One step of each of the six train loops at base 2 with --fsdp and
    --checkpoint-format dcp (the VQ-VAE they start from with npz)."""
    from vq_voice_swap_torch import (train_classifier, train_diffusion, train_enc_pred,
                                     train_vqvae, train_vqvae_add, train_vqvae_uncond)

    base = ["--device", "cpu", "--batch-size", "1", "--max-steps", "1", "--save-interval", "1",
            "--fsdp"]
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


# ---------------------------------------------------------------- spawning


def _entry(rank: int, world: int, port: int, task: str, args: tuple, results) -> None:
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        torch.set_num_threads(1)
        init_distributed("cpu", timeout_s=120)
        results.put((rank, "ok", globals()[task](rank, world, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def run_group(world: int, task: str, *args, timeout: float = 240.0) -> List[Any]:
    """Run ``task`` on ``world`` spawned gloo ranks; the results in rank
    order. Raises on any rank's error, or after ``timeout`` seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, task, args, results))
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
    return [got[r] for r in range(world)]
