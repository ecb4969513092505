"""Training loops on one device (counterpart of the JAX package's
``vq_voice_swap_tpu/train/loops.py``): ``DiffusionTrainLoop``,
``VQVAETrainLoop``, ``VQVAEAddClassesTrainLoop`` (new speakers' label
embeddings alone), ``VQVAEUncondTrainLoop`` (classifier-free guidance
fine-tuning), ``ClassifierTrainLoop`` and ``EncoderPredictorTrainLoop``.

The data is ``data_dir``: ``tones``, ``chirps`` (``:N`` for more items)
or a LibriSpeech-style directory, indexed and decoded into a window cache
at first use (``data/``). A loop creates or resumes the model, its EMAs
and the optimizer from ``--output-dir``, then runs one train step per
batch. Step N draws from
its own generator, seeded from (--seed, N), so a resumed run draws what
an uninterrupted one would. Metric fetches lag the steps by
``--pipeline-depth``, so the host queues the next step while the card
runs the last; every ``--save-interval`` steps the loop writes
``model.npz`` and ``model_ema_<rate>.npz`` (the JAX package's format,
VQ usage counts included), the optimizer state ``opt.pt`` and a
``# saved`` line in ``train_log.txt``.

``--steps-per-dispatch K`` runs the steps in windows of K whose batches
are staged first; on CUDA the step is captured once as CUDA graphs and
replayed K times a window (``train/graphs.py``), on the CPU the window is
K eager steps. Either way a step's draws come from its own generator
through the loop's drawer, and the rest of the step (AdamW, the codebook,
the EMAs) runs as the eager step runs it, so the run computes what the K=1
run computes. A ``max_steps``
tail that K does not divide runs one step at a time; a save lands on the
first window boundary at or after each ``--save-interval`` and is of the
state at that boundary. ``--grad-checkpoint [full|convs]`` rematerialises
the UNet ResBlocks in the backward (the diffusion and VQ-VAE loops; the
classifier and encoder-predictor loops take no remat, as in the JAX
package). ``--async-save`` snapshots the state (``--async-snapshot host``:
pinned host memory; ``device``: a copy on the card) and writes the files
on a worker thread between ``# saving @ N`` and ``# saved``.
``--profile-dir`` writes a torch.profiler Chrome trace of the loop.

A JAX npz run directory resumes: its optimizer state (``opt.npz``, flax
msgpack) is read into AdamW (``convert/flax_msgpack.py``). Orbax
directories are refused.

Launched by ``torchrun`` (``python -m torch.distributed.run
--nproc-per-node N -m vq_voice_swap_torch.train_<loop> ...``), a loop is
one rank of a data-parallel run (``parallel/``): each rank drives one
device (``cuda:LOCAL_RANK``; NCCL, or gloo with ``--device cpu``), reads
its shard of every epoch, and the run computes what one device computes
on the global batch, ``--batch-size`` (per rank) times N. Rank 0's built
or resumed state is broadcast at the start; only rank 0 logs, writes
``run_info_*.json`` and saves. ``--fsdp`` stores the parameters, EMAs and
AdamW moments sharded over the ranks (FSDP2); its steps run eagerly, also
in --steps-per-dispatch windows. ``--checkpoint-format dcp`` writes
``model.dcp/``, ``model_ema_<rate>.dcp/`` and ``opt.dcp/`` with
``torch.distributed.checkpoint``, every rank its own shards
(``train/dcp.py``), synchronously (``--async-save`` warns and is ignored
there); ``ModelBase.load`` and so every CLI reads ``model.dcp`` and the
EMA directories; npz saves gather the state first. ``--tensor-parallel T`` lays the N ranks out as N / T data rows of
T model columns (``parallel.dist.init_grid``): each data row reads its
shard of every epoch at ``--batch-size``, and its T ranks hold the
parameters, EMAs and AdamW moments cut along their output features
(``parallel/tensor.py``) and compute the same rows together; with
``--fsdp`` the data group shards those shards further. Its steps run
eagerly, also in --steps-per-dispatch windows. Without the launcher's
environment a loop is the single-device loop, and ``--tensor-parallel``
above 1 raises a ValueError, as it does where T does not divide the
world.
"""

import argparse
import json
import os
import sys
import threading
import time
from abc import ABC, abstractmethod
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..classifier_model import ClassifierModel, EncoderPredictorModel
from ..convert.flax_msgpack import load_optax_adamw
from ..data import create_data_loader
from ..diffusion import Diffusion, make_schedule
from ..diffusion_model import DiffusionModel
from ..model_base import ModelBase
from ..models.init import init_like_flax
from ..observe import Logger, LossTracker, span
from ..parallel import (GradBuffer, StepSync, agree, broadcast_from_primary, cut_axes,
                        data_rank, data_size, full_tensor_tp, init_distributed, init_grid,
                        launched, rank, shard_train_state, world_size)
from ..util import step_generator
from ..vq import VQLossConfig
from ..vq_vae import VQVAE
from . import dcp
from .ema import EMA
from .graphs import GraphedTrainStep
from .state import build_optimizer, prefix_predicate
from .steps import Drawer, LossFn, TrainStep, VQUpdateRule

__all__ = [
    "ClassifierTrainLoop",
    "DiffusionTrainLoop",
    "EncoderPredictorTrainLoop",
    "TrainLoop",
    "VQVAEAddClassesTrainLoop",
    "VQVAETrainLoop",
    "VQVAEUncondTrainLoop",
    "step_generator",
]

# A JAX Orbax run's model and optimizer directories (an interrupted Orbax
# save leaves them as ``<name>.new``), which this port does not read.
ORBAX_CHECKPOINTS = ("model.orbax", "opt.orbax")

# Small launches that open a --profile-dir trace on CUDA: torch.profiler
# loses the device records of a profiling run's first launches (PERF.md §6).
PROFILE_PAD = 4096


def copy_intersection(model: torch.nn.Module, src: torch.nn.Module, source: str) -> int:
    """Copy into ``model`` the parameters and buffers of ``src`` that share
    a name with its own (their shapes must agree); returns the number of
    scalars copied."""
    src_state = src.state_dict()
    copied = {}
    for name, value in model.state_dict().items():
        if name in src_state:
            if src_state[name].shape != value.shape:
                raise ValueError(f"parameter {name} has shape {tuple(value.shape)} in "
                                 f"the model but {tuple(src_state[name].shape)} in {source}")
            copied[name] = src_state[name]
    model.load_state_dict(copied, strict=False)
    return sum(v.numel() for v in copied.values())


def repeat_dataset(loader):
    """Iterate a data loader forever."""
    while True:
        yield from loader


class TrainLoop(ABC):
    """Subclasses give the model, its loss and its flags."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = init_distributed(args.device)
        self.grid = init_grid(args.tensor_parallel, self.device)
        self.world, self.primary = world_size(), rank() == 0
        self.data_size = data_size()
        self.distributed = launched()
        if args.fsdp and not self.distributed:
            raise ValueError("--fsdp shards over the ranks of a launched run: start it with "
                             "python -m torch.distributed.run --nproc-per-node N -m ...")
        os.makedirs(args.output_dir, exist_ok=True)
        orbax = [f for f in ORBAX_CHECKPOINTS
                 if os.path.exists(self.path(f)) or os.path.exists(self.path(f + ".new"))]
        if orbax and not os.path.exists(self.opt_path()):
            raise RuntimeError(
                f"{args.output_dir} holds the JAX package's Orbax checkpoint "
                f"({', '.join(orbax)}) and no {os.path.basename(self.opt_path())}: this port "
                "reads npz and dcp run directories "
                "only. Convert it with the JAX package (its checkpoint module's "
                "load_checkpoint_orbax, then save_checkpoint to model.npz and "
                "model_ema_<rate>.npz, and the optimizer state as opt.npz, as its npz "
                "runs write them), or warm-start from an npz model with --pretrained-path "
                "into a fresh --output-dir."
            )
        if args.async_save and self.dcp and self.primary:
            print("warning: --async-save is ignored with --checkpoint-format dcp (the "
                  "sharded save is collective, so it runs in the train loop's thread and "
                  "the loop waits for it)", file=sys.stderr)
        self.rng_seed = args.seed
        self.steps_per_dispatch = max(1, args.steps_per_dispatch or 1)
        self.data_loader, self.num_labels = create_data_loader(
            args.data_dir, args.batch_size, encoding=args.encoding, seed=self.rng_seed,
            shard_index=data_rank(), num_shards=self.data_size)
        self.model, self.resume = self.create_model()

        self.ema_rates = [float(r) for r in args.ema_rate.split(",")]
        if len(set(self.ema_rates)) != len(self.ema_rates):
            raise ValueError(f"duplicate EMA rates in {args.ema_rate!r}")
        self.emas = self.create_emas()
        self.optimizer = build_optimizer(
            self.model, lr=args.lr, weight_decay=args.weight_decay,
            frozen_fn=self.frozen_predicate(), lr_final=args.lr_final,
            lr_anneal_steps=args.lr_anneal_steps, grad_clip=args.grad_clip)
        names = {id(p): n for n, p in self.model.named_parameters()}
        self.opt_names = [names[id(p)] for p in self.optimizer.params]
        if self.dcp and dcp.exists(self.opt_path()):
            print("loading optimizer state from checkpoint...")
            dcp.load_optimizer(self.opt_path(), self.optimizer, self.opt_names)
        elif os.path.exists(self.opt_path()):
            print("loading optimizer state from checkpoint...")
            # Read to the CPU: AdamW moves the moments to their parameters'
            # device and leaves each step count where it finds it, and a
            # count on the card would cost two host syncs a parameter a step.
            self.optimizer.load_state_dict(
                torch.load(self.opt_path(), map_location="cpu", weights_only=True))
        elif os.path.exists(self.path("opt.npz")):
            print("loading the JAX package's optimizer state (opt.npz)...")
            with open(self.path("opt.npz"), "rb") as f:
                load_optax_adamw(self.optimizer, self.model, f.read())

        self.logger = Logger(self.path("train_log.txt"), resume=self.resume,
                             write=self.primary)
        if self.distributed:
            self._sync_state_from_primary()
            if args.fsdp or self.grid is not None:
                # --tensor-parallel cuts the state over the model group,
                # --fsdp shards it over the data group.
                self.optimizer = shard_train_state(
                    self.model, self.emas, self.optimizer, self.opt_names, args.fsdp)
        self.tracker = LossTracker()
        self.total_steps = self.logger.start_step
        self.loop_steps = 0

        microbatches, micro_remainder = 1, 0
        if args.microbatch and args.microbatch < args.batch_size:
            microbatches = args.batch_size // args.microbatch
            micro_remainder = args.batch_size % args.microbatch
        sync = None
        if self.distributed:
            # The plain parameters' gradients in one flat buffer, summed over
            # the data group (under FSDP the shards' are reduce-scattered by
            # its hooks).
            cut = self.tp_axes
            self.optimizer.grad_buffer = GradBuffer(
                self.optimizer.params, [n in cut for n in self.opt_names])
            sync = StepSync(self.optimizer.grad_buffer)
        self.train_step = TrainStep(
            self.model, self.build_loss_fn(), self.optimizer, self.emas,
            microbatches=microbatches, micro_remainder=micro_remainder,
            vq_rule=self.vq_update_rule(), drawer=self.build_drawer(), sync=sync)
        # Windows of K steps replay the step's forwards and backward from a
        # CUDA graph on the card (not under FSDP, whose collectives run in
        # module hooks that a capture does not hold, nor under tensor
        # parallelism, whose gathers run over gloo between two ranks that
        # share a card); else they run eagerly.
        self.graphed_step = None
        if (self.device.type == "cuda" and self.steps_per_dispatch > 1 and not args.fsdp
                and self.grid is None):
            self.graphed_step = GraphedTrainStep(self.train_step)
        self._pending: deque = deque()
        self._last_finish: Optional[float] = None
        self._last_done: Optional[torch.cuda.Event] = None
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[Exception] = None
        self.write_run_info()

    @property
    def dcp(self) -> bool:
        return self.args.checkpoint_format == "dcp"

    @property
    def tp_axes(self) -> Dict[str, int]:
        """{parameter name: the axis it is cut along over the model group}."""
        return cut_axes(self.model)

    def _sync_state_from_primary(self) -> None:
        """Make rank 0's built or resumed state every rank's: the model's
        parameters and buffers, the EMAs, AdamW's state, its count and the
        log's start step. The ranks must agree on what they found in the
        run directory first (a run over several hosts needs it on a shared
        filesystem)."""
        opt_state = [self.optimizer.adamw.state.get(p, {}) for p in self.optimizer.params]
        agree([int(self.resume), *(len(st) for st in opt_state)],
              f"what {self.args.output_dir} holds (resume, AdamW state a parameter); a run "
              "over several hosts needs its --output-dir on a shared filesystem")
        steps = torch.tensor([self.logger.start_step, self.optimizer.count])
        tensors = [t.detach() for t in self.model.state_dict().values()]
        for ema in self.emas:
            tensors += [p.detach() for p in ema.model.parameters()]
        for st in opt_state:
            tensors += [st[k] for k in sorted(st)]
        broadcast_from_primary(tensors + [steps])
        self.logger.start_step, self.optimizer.count = (int(v) for v in steps)

    # ----------------------------------------------------------- main loop

    def loop(self, max_steps: Optional[int] = None) -> None:
        if max_steps is None:
            max_steps = self.args.max_steps
        with self._profiling():
            try:
                if self.steps_per_dispatch > 1:
                    self._loop_windows(max_steps, self.steps_per_dispatch)
                else:
                    for i, batch in enumerate(repeat_dataset(self.data_loader)):
                        if max_steps is not None and i >= max_steps:
                            break
                        self.total_steps = i + self.logger.start_step
                        self.loop_steps = i
                        self.step(batch)
            finally:
                self._flush_pending()
                self.finish_pending_save()

    def step(self, batch: Dict[str, np.ndarray]) -> None:
        """Run one train step; fetch the metrics of the step
        --pipeline-depth steps back; save on the interval."""
        generator = step_generator(self.rng_seed, self.total_steps, self.device)
        batch = self.prepare_batch(batch)
        with span("vvs.train.stage"):
            device_batch = self.to_device(batch)
        dispatched = time.perf_counter()
        metrics = self.train_step(device_batch, generator)
        self._queue(self.loop_steps, [metrics], dispatched)
        if (self.total_steps + 1) % self.args.save_interval == 0:
            self._flush_pending()  # the '# saved' line follows this step's line
            self.save(self.loop_steps + 1)

    def _loop_windows(self, max_steps: Optional[int], k_steps: int) -> None:
        """--steps-per-dispatch: windows of K steps whose batches are
        prepared (``prepare_batch`` sees each step's ``total_steps``) and
        staged on the device first; a tail shorter than K runs through
        ``step``."""
        it = iter(repeat_dataset(self.data_loader))
        i = 0
        while max_steps is None or i < max_steps:
            if max_steps is not None and max_steps - i < k_steps:
                self.total_steps = i + self.logger.start_step
                self.loop_steps = i
                self.step(next(it))
                i += 1
                continue
            batches = []
            for k in range(k_steps):
                self.total_steps = i + k + self.logger.start_step
                batches.append(self.prepare_batch(next(it)))
            self.loop_steps = i
            self._window(batches, i)
            i += k_steps

    def _window(self, batches: List[Dict[str, np.ndarray]], base: int) -> None:
        """Run one window's steps (loop steps base .. base+K-1); save when
        the window crosses a --save-interval boundary, of the state after
        its last step."""
        k_steps = len(batches)
        start = self.logger.start_step
        with span("vvs.train.stage"):
            staged = self.to_device({k: np.stack([b[k] for b in batches]) for k in batches[0]})
        run = self.graphed_step or self.train_step
        dispatched = time.perf_counter()
        metrics = []
        for j in range(k_steps):
            generator = step_generator(self.rng_seed, base + j + start, self.device)
            batch = {k: v[j] for k, v in staged.items()}
            if self.graphed_step is None:
                # The eager window: the same draws, through the drawer.
                metrics.append(run(batch, generator, draws=run.draw(batch, generator)))
            else:
                metrics.append(run(batch, generator))
        done = None
        if self.graphed_step is not None:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
        self._queue(base, metrics, dispatched, done)
        last = base + start + k_steps  # steps done after the window
        if last // self.args.save_interval != (last - k_steps) // self.args.save_interval:
            self._flush_pending()
            self.save(base + k_steps)

    def _queue(self, loop_steps: int, metrics: List[Dict[str, Any]], dispatched: float,
               done: Optional[torch.cuda.Event] = None) -> None:
        """Hold a dispatch's metrics (one step or a window; ``done`` marks
        a replayed window's end on the card) and fetch the oldest beyond
        --pipeline-depth."""
        self._pending.append((loop_steps, metrics, dispatched, done))
        while len(self._pending) > max(1, self.args.pipeline_depth):
            self._flush_one()

    def prepare_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Hook to change the host batch (label offsets, curriculum scalars)."""
        return batch

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch on the device, through pinned memory on CUDA."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.long() if k == "label" else t
        return out

    def _flush_one(self) -> None:
        """Fetch and log the metrics of the oldest dispatch (waits for it):
        one line a step, each with the dispatch's samples/s. That is timed
        between completions on the host (the first dispatch's from its
        dispatch); a replayed window after another, between their ends on
        the card, since a replay can hold the host to the card's pace and
        the host then sees a completion only when the next window is
        queued."""
        with span("vvs.train.flush"):
            loop_steps, window, dispatched, done = self._pending.popleft()
            losses = [float(m["loss"]) for m in window]
            now = time.perf_counter()
            if done is not None and self._last_done is not None:
                done.synchronize()
                seconds = self._last_done.elapsed_time(done) / 1e3
            else:
                seconds = now - (self._last_finish or dispatched)
            self._last_finish = now
            self._last_done = done
            rate = self.args.batch_size * self.data_size * len(window) / seconds
            for j, (metrics, loss) in enumerate(zip(window, losses)):
                self.tracker.add(metrics["ts"].cpu().numpy(),
                                 metrics["mses"].float().cpu().numpy())
                other = {k: float(v) for k, v in metrics["extra"].items()}
                if "codebook_used" in metrics:
                    other["codebook_used"] = float(metrics["codebook_used"])
                other["samples_per_sec"] = rate
                other.update(self.tracker.log_dict())
                self.logger.log(loop_steps + j + 1, loss=loss, **other)

    def _flush_pending(self) -> None:
        while self._pending:
            self._flush_one()

    @contextmanager
    def _profiling(self) -> Iterator[None]:
        """--profile-dir: a torch.profiler trace of the loop, written as a
        Chrome trace (``trace_<time>.json``) when the loop ends."""
        profile_dir = self.args.profile_dir
        if not profile_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.start()
        try:
            if cuda:
                pad = torch.zeros(1, device=self.device)
                for _ in range(PROFILE_PAD):
                    pad.add_(1.0)
                torch.cuda.synchronize(self.device)
            yield
        finally:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, f"trace_{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(path)
            print(f"wrote a profiler trace to {path}")

    # ------------------------------------------------------------- plumbing

    def path(self, name: str) -> str:
        return os.path.join(self.args.output_dir, name)

    def checkpoint_path(self) -> str:
        return self.path("model.dcp" if self.dcp else "model.npz")

    def ema_path(self, rate: float) -> str:
        return self.path(f"model_ema_{rate}.{'dcp' if self.dcp else 'npz'}")

    def opt_path(self) -> str:
        return self.path("opt.dcp" if self.dcp else "opt.pt")

    def create_model(self) -> Tuple[ModelBase, bool]:
        saved = self.checkpoint_path()
        if dcp.exists(saved) if self.dcp else os.path.exists(saved):
            print("loading from checkpoint...")
            model = self.model_class().load(saved, device=self.device, frozen=False)
            resume = True
        else:
            print("creating new model")
            model = self.create_new_model()
            init_like_flax(model, torch.Generator().manual_seed(self.rng_seed))
            resume = False
            if self.args.pretrained_path:
                print(f"loading pretrained: {self.args.pretrained_path} ...")
                print(f"loaded {self.load_from_pretrained(model)} pre-trained parameters")
            model = model.to(self.device)
        print(f"total parameters: {sum(p.numel() for p in model.parameters())}")
        return model, resume

    def load_from_pretrained(self, model: ModelBase) -> int:
        """Copy the parameters and buffers that share a name with the
        --pretrained-path checkpoint's (their shapes must agree); returns
        the number of scalars copied."""
        src = self.check_pretrained(ModelBase.load(self.args.pretrained_path, device="cpu"))
        return copy_intersection(model, src, self.args.pretrained_path)

    def check_pretrained(self, src: ModelBase) -> ModelBase:
        return src

    def create_emas(self) -> List[EMA]:
        emas = []
        for rate in self.ema_rates:
            ema = EMA(self.model, rate)
            if not self.dcp and os.path.exists(self.ema_path(rate)):
                print(f"loading EMA {rate} from checkpoint...")
                ema.model.load_state_dict(
                    ModelBase.load(self.ema_path(rate), device=self.device).state_dict())
            emas.append(ema)
        if self.dcp:
            paths = [self.ema_path(ema.rate) for ema in emas]
            for rate in dcp.load_emas(self.checkpoint_path(), paths, emas):
                print(f"loading EMA {rate} from checkpoint...")
        return emas

    def save(self, steps_done: int) -> None:
        """Write the model, its EMAs and the optimizer state, then
        ``# saved``. With --async-save, snapshot them, mark ``# saving @
        steps_done`` and write from a worker thread (one save in flight; a
        failed one raises at the next save or at the loop's end). On N
        ranks every rank gathers the sharded state (collectives, so in this
        thread) and rank 0 writes; ``dcp`` saves are collective and
        synchronous."""
        if self.dcp:
            dcp.save_run(self.checkpoint_path(), [self.ema_path(e.rate) for e in self.emas],
                         self.opt_path(), self.model, self.emas, self.optimizer,
                         self.opt_names, self.tp_axes)
            self.logger.mark_save()
            return
        if not self.primary:
            if self.args.fsdp or self.grid is not None:
                self._state(lambda t: t)  # every rank takes part in the gathers
            return
        if not self.args.async_save:
            self._write_checkpoints(self._state(lambda t: t))
            return
        if self.args.async_snapshot == "device":
            snapshot = self._state(lambda t: t.detach().clone())
        else:
            snapshot = self._state(self._pinned_copy)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self.finish_pending_save()
        self.logger.mark_saving(steps_done)

        def worker():
            try:
                if done is not None:
                    done.synchronize()  # the snapshot's copies have landed
                self._write_checkpoints(snapshot)
            except Exception as e:  # raised at the next join
                self._save_error = e

        self._save_error = None
        self._save_thread = threading.Thread(target=worker, daemon=False)
        self._save_thread.start()

    def _pinned_copy(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t.detach().clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t.detach(), non_blocking=True)
        return out

    def _state(self, take: Callable[[torch.Tensor], torch.Tensor]) -> Dict[str, Any]:
        """The state a save writes, each tensor through ``take``: the
        model's state_dict, each EMA's parameters with the model's buffers
        (usage counts), and the optimizer's state_dict; shards whole."""
        axes = self.tp_axes

        def whole(name: str, t: torch.Tensor) -> torch.Tensor:
            return take(full_tensor_tp(t, axes.get(name) if t.ndim else None))

        model = {k: whole(k, v) for k, v in self.model.state_dict().items()}
        buffers = {n for n, _ in self.model.named_buffers()}
        emas = []
        for ema in self.emas:
            state = {n: whole(n, p) for n, p in ema.model.named_parameters()}
            state.update((n, model[n]) for n in buffers)
            emas.append(state)
        opt = self.optimizer.state_dict()
        opt["adamw"]["state"] = {i: {k: whole(self.opt_names[i], v) for k, v in st.items()}
                                 for i, st in opt["adamw"]["state"].items()}
        return {"model": model, "emas": emas, "opt": opt}

    def _write_checkpoints(self, state: Dict[str, Any]) -> None:
        self.model.save(self.checkpoint_path(), state["model"])
        for ema, ema_state in zip(self.emas, state["emas"]):
            ema.model.save(self.ema_path(ema.rate), ema_state)
        tmp = self.opt_path() + ".tmp"
        torch.save(state["opt"], tmp)
        os.replace(tmp, self.opt_path())
        self.logger.mark_save()

    def finish_pending_save(self) -> None:
        """Wait for an asynchronous save; raise if it failed."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
            err, self._save_error = self._save_error, None
            if err is not None:
                raise RuntimeError("asynchronous checkpoint save failed") from err

    def write_run_info(self) -> None:
        if not self.primary:
            return
        info = dict(args=vars(self.args), command=sys.argv[0], start_steps=self.total_steps,
                    num_devices=self.world,
                    tensor_parallel=1 if self.grid is None else self.grid.model_size,
                    device=str(self.device),
                    steps_per_dispatch_route="cuda_graph" if self.graphed_step else "eager")
        with open(self.path(f"run_info_{int(time.time())}.json"), "w") as f:
            json.dump(info, f, indent=4)

    def frozen_predicate(self) -> Optional[Callable[[str], bool]]:
        return None

    def vq_update_rule(self) -> Optional[VQUpdateRule]:
        return None

    def model_dtype(self) -> Optional[str]:
        return "bfloat16" if self.args.bf16 else None

    # ------------------------------------------------------------ abstract

    @abstractmethod
    def model_class(self) -> type:
        """The ModelBase subclass this loop trains."""

    @abstractmethod
    def create_new_model(self) -> ModelBase:
        """A fresh model on the CPU (the loop initialises its weights)."""

    @abstractmethod
    def build_loss_fn(self) -> LossFn:
        """The train step's loss_fn(batch, generator, draws)."""

    @abstractmethod
    def build_drawer(self) -> Drawer:
        """The train step's drawer(batch, generator): loss_fn's draws."""

    @classmethod
    @abstractmethod
    def default_output_dir(cls) -> str:
        ...

    @classmethod
    def arg_parser(cls) -> argparse.ArgumentParser:
        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser.add_argument("--lr", default=1e-4, type=float)
        parser.add_argument("--lr-final", default=None, type=float,
                            help="linearly anneal to this LR over --lr-anneal-steps")
        parser.add_argument("--lr-anneal-steps", default=None, type=int)
        parser.add_argument("--grad-clip", default=None, type=float,
                            help="clip gradients to this global norm")
        parser.add_argument("--ema-rate", default="0.9999", type=str)
        parser.add_argument("--weight-decay", default=0.0, type=float)
        parser.add_argument("--batch-size", default=8, type=int)
        parser.add_argument("--microbatch", default=None, type=int)
        parser.add_argument("--output-dir", default=cls.default_output_dir(), type=str)
        parser.add_argument("--pretrained-path", default=None, type=str)
        parser.add_argument("--save-interval", default=1000, type=int)
        parser.add_argument(
            "--grad-checkpoint", nargs="?", const="full", default=False,
            choices=["full", "convs"],
            help="rematerialize ResBlocks in the backward: 'full' (bare flag; least "
                 "memory, recomputes the convolutions) or 'convs' (saves conv_in's "
                 "output, recomputes only the norm/GELU/FiLM chains). The bare flag "
                 "takes a following positional argument: place it after the data dir "
                 "or write --grad-checkpoint=full")
        parser.add_argument("--encoding", default="linear", type=str)
        parser.add_argument("--seed", default=0, type=int)
        parser.add_argument("--bf16", action="store_true",
                            help="compute in bfloat16 (params stay float32)")
        parser.add_argument("--profile-dir", default=None, type=str,
                            help="write a torch.profiler Chrome trace of the loop here")
        parser.add_argument("--pipeline-depth", default=1, type=int,
                            help="how many steps metric fetches may lag behind")
        parser.add_argument("--steps-per-dispatch", default=1, type=int,
                            help="run the steps in windows of K staged batches; on CUDA "
                                 "the step is one CUDA graph replayed K times a window, "
                                 "except under --fsdp and --tensor-parallel, whose windows "
                                 "run eagerly (saves land on window boundaries)")
        parser.add_argument("--async-save", action="store_true",
                            help="write checkpoints from a worker thread, overlapping "
                                 "the writes with training")
        parser.add_argument("--async-snapshot", default="host", type=str,
                            choices=("host", "device"),
                            help="where --async-save snapshots the state: host (pinned "
                                 "memory; the loop waits for the copies) or device (a "
                                 "copy on the card until the worker has written it)")
        parser.add_argument("--max-steps", default=None, type=int,
                            help="stop after this many steps (default: run until killed)")
        parser.add_argument("--tensor-parallel", default=1, type=int,
                            help="model-axis size of a 2-D data x model grid of the "
                                 "ranks of a launched run; weights/optimizer shard on "
                                 "their output-feature axis (the world size must be "
                                 "divisible)")
        parser.add_argument("--fsdp", action="store_true",
                            help="ZeRO-3 over the ranks of a launched run: parameters, "
                                 "EMAs and AdamW moments stored sharded (state memory a "
                                 "rank scales 1/N); composes with --tensor-parallel, "
                                 "sharding over the data rows; --steps-per-dispatch "
                                 "windows run eagerly")
        parser.add_argument("--checkpoint-format", default="npz", choices=("npz", "dcp"),
                            help="npz: single files, gathered and written by rank 0; dcp: "
                                 "model.dcp/ and opt.dcp/ through torch.distributed."
                                 "checkpoint, every rank writing its shards (synchronous; "
                                 "resumes at any world size). Orbax is not ported")
        parser.add_argument("--device", default=None,
                            help="torch device (default: cuda; cuda:LOCAL_RANK under torchrun)")
        parser.add_argument("data_dir", type=str)
        return parser


class DiffusionTrainLoop(TrainLoop):
    """Unconditional or class-conditional diffusion training."""

    def model_class(self):
        return DiffusionModel

    def create_new_model(self):
        return DiffusionModel(
            pred_name=self.args.predictor,
            base_channels=self.args.base_channels,
            schedule_name=self.args.schedule,
            dropout=self.args.dropout,
            num_labels=self.num_labels if self.args.class_cond else None,
            dtype=self.model_dtype(),
            remat=self.args.grad_checkpoint,
        )

    def create_model(self):
        model, resume = super().create_model()
        # A training setting: a resumed run takes this run's flag.
        model.set_remat(self.args.grad_checkpoint)
        return model, resume

    def build_loss_fn(self):
        model = self.model
        class_cond = self.args.class_cond

        def loss_fn(batch, generator, draws):
            x = batch["samples"][..., None]
            labels = batch["label"] if class_cond else None
            losses, ts = model.losses(x, labels=labels, generator=generator, train=True,
                                      **draws)
            return losses.mean(), {"mses": losses.detach(), "ts": ts, "extra": {}}

        return loss_fn

    def build_drawer(self):
        model = self.model

        def drawer(batch, generator):
            return model.loss_draws(batch["samples"][..., None], generator, train=True)

        return drawer

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--predictor", default="unet", type=str)
        parser.add_argument("--base-channels", default=32, type=int)
        parser.add_argument("--dropout", default=0.0, type=float)
        parser.add_argument("--schedule", default="exp", type=str)
        parser.add_argument("--class-cond", action="store_true")
        return parser

    @classmethod
    def default_output_dir(cls):
        return "ckpt_diffusion"


class VQVAETrainLoop(DiffusionTrainLoop):
    """The speaker-conversion VQ-VAE trainer."""

    def model_class(self):
        return VQVAE

    def create_new_model(self):
        return VQVAE(
            pred_name=self.args.predictor,
            base_channels=self.args.base_channels,
            enc_name=self.args.encoder,
            cond_mult=self.args.cond_mult,
            dictionary_size=self.args.dictionary_size,
            dead_rate=self.args.dead_rate,
            schedule_name=self.args.schedule,
            dropout=self.args.dropout,
            num_labels=self.num_labels if self.args.class_cond else None,
            dtype=self.model_dtype(),
            remat=self.args.grad_checkpoint,
        )

    def create_model(self):
        model, resume = super().create_model()
        model.dead_rate = self.args.dead_rate  # a runtime setting, not a weight
        return model, resume

    @contextmanager
    def _pretrained_loaded(self) -> Iterator[VQVAE]:
        """Load --pretrained-path once for create_model: it sets the label
        count and kwargs that the label-surgery loops build their model
        from, and their load_from_pretrained grows it; the copy is dropped
        on exit."""
        if not self.args.pretrained_path:
            raise ValueError("must load from a pre-trained VQVAE (--pretrained-path)")
        if not self.args.class_cond:
            raise ValueError("must train a class-conditional model (--class-cond)")
        pretrained = VQVAE.load(self.args.pretrained_path, device="cpu")
        if pretrained.num_labels is None:
            raise ValueError(f"{self.args.pretrained_path} is not class-conditional")
        self._pretrained = pretrained
        self.pretrained_num_labels = pretrained.num_labels
        self.pretrained_kwargs = pretrained.save_kwargs()
        try:
            yield pretrained
        finally:
            self._pretrained = None

    def check_pretrained(self, src):
        # A VQVAE or a bare DiffusionModel: the predictor intersects either way.
        if not isinstance(src, DiffusionModel):
            raise ValueError(f"unsupported pretrained model: {type(src).__name__}")
        return src

    def vq_loss_config(self) -> VQLossConfig:
        return VQLossConfig(commitment=self.args.commitment_coeff,
                            revival=self.args.revival_coeff)

    def build_loss_fn(self):
        model = self.model
        class_cond = self.args.class_cond
        vq_cfg = self.vq_loss_config()
        jitter = self.args.jitter

        def loss_fn(batch, generator, draws):
            x = batch["samples"][..., None]
            labels = batch["label"] if class_cond else None
            out = model.losses(x, labels=labels, vq_loss_cfg=vq_cfg, jitter=jitter,
                               train=True, generator=generator, **draws)
            return out["mse"] + out["vq_loss"], {
                "mses": out["mses"].detach(),
                "ts": out["ts"],
                "extra": {"vq_loss": out["vq_loss"]},
                "idxs": out["idxs"],
                "used": out["used"],
                "enc_flat": out["enc_flat"],
            }

        return loss_fn

    def build_drawer(self):
        model = self.model
        jitter = self.args.jitter

        def drawer(batch, generator):
            return model.loss_draws(batch["samples"][..., None], generator, train=True,
                                    jitter=jitter)

        return drawer

    def frozen_predicate(self):
        prefixes = []
        if self.args.freeze_encoder:
            prefixes.append("encoder")
        if self.args.freeze_vq:
            prefixes.append("vq")
        return prefix_predicate(prefixes) if prefixes else None

    def should_revive(self) -> bool:
        # Hard revival only without the revival loss and with a trained codebook.
        return not self.args.revival_coeff and not self.args.freeze_vq

    def vq_update_rule(self):
        return VQUpdateRule(dead_rate=self.args.dead_rate, revive=self.should_revive())

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--encoder", default="unet", type=str)
        parser.add_argument("--cond-mult", default=16, type=int)
        parser.add_argument("--dictionary-size", default=512, type=int)
        parser.add_argument("--freeze-encoder", action="store_true")
        parser.add_argument("--freeze-vq", action="store_true")
        parser.add_argument("--commitment-coeff", default=0.25, type=float)
        parser.add_argument("--revival-coeff", default=0.0, type=float)
        parser.add_argument("--dead-rate", default=100, type=int)
        parser.add_argument("--jitter", default=0.0, type=float)
        return parser

    @classmethod
    def default_output_dir(cls):
        return "ckpt_vqvae"


class VQVAEAddClassesTrainLoop(VQVAETrainLoop):
    """Grow a trained VQ-VAE's label space with the dataset's speakers and
    train only their label embeddings: the dataset's labels follow the
    pretrained ones, and everything else is frozen (no gradient, no
    moments, no update; the codebook is not revived)."""

    def create_model(self):
        with self._pretrained_loaded():
            return super().create_model()

    def create_new_model(self):
        kwargs = dict(self.pretrained_kwargs)
        kwargs["num_labels"] = self.num_labels + self.pretrained_num_labels
        return VQVAE(**kwargs)

    def load_from_pretrained(self, model):
        grown = self._pretrained.add_labels(self.num_labels)
        return copy_intersection(model, grown, self.args.pretrained_path)

    def prepare_batch(self, batch):
        return {**batch, "label": batch["label"] + self.pretrained_num_labels}

    def frozen_predicate(self):
        label_paths = set(self.model.label_parameter_paths())
        return lambda name: name not in label_paths

    def should_revive(self):
        return False  # the codebook serves the original speakers

    @classmethod
    def default_output_dir(cls):
        return "ckpt_vqvae_added"


class VQVAEUncondTrainLoop(VQVAETrainLoop):
    """Fine-tune a trained VQ-VAE for classifier-free guidance: a new label
    0 (unconditional) goes before the pretrained ones; each row's label is
    dropped to 0 with probability --no-class-prob and its codes zeroed
    with probability --no-vq-prob."""

    def create_model(self):
        with self._pretrained_loaded():
            # An embedding lookup past the table raises here, where flax
            # clamps it; refuse up front either way.
            if self.num_labels > self.pretrained_num_labels:
                raise ValueError(
                    f"dataset has {self.num_labels} speakers but the pretrained VQVAE "
                    f"knows {self.pretrained_num_labels}; grow the label space with "
                    "train_vqvae_add first")
            return super().create_model()

    def create_new_model(self):
        kwargs = dict(self.pretrained_kwargs)
        kwargs["num_labels"] = self.pretrained_num_labels + 1
        return VQVAE(**kwargs)

    def load_from_pretrained(self, model):
        grown = self._pretrained.add_labels(1, end=False)
        return copy_intersection(model, grown, self.args.pretrained_path)

    def build_loss_fn(self):
        model = self.model
        vq_cfg = self.vq_loss_config()
        jitter = self.args.jitter
        no_class_prob = self.args.no_class_prob
        no_vq_prob = self.args.no_vq_prob

        def loss_fn(batch, generator, draws):
            """``draws`` may hold ``no_class_nums`` [N] (a row keeps its
            label where its uniform draw is above --no-class-prob) and
            VQVAE.losses's draws."""
            draws = dict(draws)
            x = batch["samples"][..., None]
            label = batch["label"]
            nums = draws.pop("no_class_nums", None)
            if nums is None:
                nums = torch.rand(label.shape, generator=generator, device=label.device)
            labels = (label + 1) * (nums.to(label.device) > no_class_prob).to(label.dtype)
            out = model.losses(x, labels=labels, vq_loss_cfg=vq_cfg, jitter=jitter,
                               no_vq_prob=no_vq_prob, train=True, generator=generator,
                               **draws)
            return out["mse"] + out["vq_loss"], {
                "mses": out["mses"].detach(),
                "ts": out["ts"],
                "extra": {"vq_loss": out["vq_loss"]},
                "idxs": out["idxs"],
                "used": out["used"],
                "enc_flat": out["enc_flat"],
            }

        return loss_fn

    def build_drawer(self):
        model = self.model
        jitter = self.args.jitter
        no_vq_prob = self.args.no_vq_prob

        def drawer(batch, generator):
            label = batch["label"]
            nums = torch.rand(label.shape, generator=generator, device=label.device)
            return {"no_class_nums": nums, **model.loss_draws(
                batch["samples"][..., None], generator, train=True, jitter=jitter,
                no_vq_prob=no_vq_prob)}

        return drawer

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--no-class-prob", default=0.1, type=float)
        parser.add_argument("--no-vq-prob", default=0.1, type=float)
        return parser

    @classmethod
    def default_output_dir(cls):
        return "ckpt_vqvae_uncond"


def noised_at(diffusion: Diffusion, x: torch.Tensor, power: torch.Tensor,
              generator: Optional[torch.Generator], draws: Dict[str, Any]):
    """(ts, samples): timesteps ``u ** power`` and x diffused to them, from
    ``draws``'s ``t_nums`` (u, [N]) and ``noise`` (x's shape) where given,
    else drawn from ``generator`` in that order."""
    u = draws.get("t_nums")
    if u is None:
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    ts = u.to(x.device) ** power
    return ts, diffusion.sample_q(x, ts, epsilon=noise.to(x.device))


def noised_draws(x: torch.Tensor, generator: Optional[torch.Generator]) -> Dict[str, Any]:
    """``noised_at``'s draws, in its order: ``t_nums``, then ``noise``."""
    return {
        "t_nums": torch.rand((x.shape[0],), generator=generator, device=x.device),
        "noise": torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device),
    }


class _CurriculumMixin:
    """A timestep curriculum: ts = u ** power, the power annealed linearly
    from --curriculum-start to 1 over --curriculum-steps."""

    def curriculum_power(self) -> float:
        if self.total_steps < self.args.curriculum_steps:
            frac = self.total_steps / self.args.curriculum_steps
            return self.args.curriculum_start * (1 - frac) + frac
        return 1.0

    def prepare_batch(self, batch):
        return {**batch, "ts_power": np.asarray(self.curriculum_power(), np.float32)}

    def build_drawer(self):
        def drawer(batch, generator):
            return noised_draws(batch["samples"][..., None], generator)

        return drawer

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--curriculum-start", default=30.0, type=float)
        parser.add_argument("--curriculum-steps", default=0, type=int)
        return parser


class ClassifierTrainLoop(_CurriculumMixin, TrainLoop):
    """Train the noised-audio speaker classifier: the NLL of the clip's
    label from the clip diffused to a curriculum timestep."""

    def model_class(self):
        return ClassifierModel

    def create_new_model(self):
        return ClassifierModel(num_labels=self.num_labels,
                               base_channels=self.args.base_channels,
                               dtype=self.model_dtype())

    def load_from_pretrained(self, model):
        src = ModelBase.load(self.args.pretrained_path, device="cpu")
        if not isinstance(src, DiffusionModel):
            raise ValueError(f"unsupported pretrained model: {type(src).__name__}")
        return model.load_from_predictor(src.predictor)

    def build_loss_fn(self):
        model = self.model
        diffusion = Diffusion(make_schedule(self.args.schedule))

        def loss_fn(batch, generator, draws):
            x = batch["samples"][..., None]
            ts, samples = noised_at(diffusion, x, batch["ts_power"], generator, draws)
            logp = F.log_softmax(model(samples, ts), dim=-1)
            nlls = -torch.gather(logp, -1, batch["label"][:, None])[:, 0]
            return nlls.mean(), {"mses": nlls.detach(), "ts": ts, "extra": {}}

        return loss_fn

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--base-channels", default=32, type=int)
        parser.add_argument("--schedule", default="exp", type=str)
        return parser

    @classmethod
    def default_output_dir(cls):
        return "ckpt_classifier"


class EncoderPredictorTrainLoop(_CurriculumMixin, TrainLoop):
    """Train the VQ-code predictor of encoder-predictor guidance: the
    cross-entropy of a frozen VQ-VAE's codes of the clip from the clip
    diffused to a curriculum timestep. The codes are encoded on the
    device with no grad in every step."""

    def model_class(self):
        return EncoderPredictorModel

    def create_model(self):
        self.vq_vae = VQVAE.load(self.args.vq_vae_path, device=self.device, frozen=True)
        return super().create_model()

    def create_new_model(self):
        return EncoderPredictorModel(
            base_channels=self.args.base_channels,
            downsample_rate=self.vq_vae.encoder.downsample_rate,
            num_latents=self.vq_vae.dictionary_size,
            dtype=self.model_dtype(),
        )

    def build_loss_fn(self):
        model = self.model
        vq_vae = self.vq_vae

        def loss_fn(batch, generator, draws):
            x = batch["samples"][..., None]
            with torch.no_grad():
                targets = vq_vae.encode(x)
            ts, samples = noised_at(vq_vae.diffusion, x, batch["ts_power"], generator, draws)
            losses = model.losses(samples, ts, targets)
            return losses.mean(), {"mses": losses.detach(), "ts": ts, "extra": {}}

        return loss_fn

    @classmethod
    def arg_parser(cls):
        parser = super().arg_parser()
        parser.add_argument("--vq-vae-path", type=str, required=True)
        parser.add_argument("--base-channels", type=int, default=32)
        return parser

    @classmethod
    def default_output_dir(cls):
        return "ckpt_enc_pred"
