"""Training loops on one device (counterpart of the JAX package's
``TrainLoop``, ``DiffusionTrainLoop`` and ``VQVAETrainLoop`` in
``vq_voice_swap_tpu/train/loops.py``).

A loop creates or resumes the model, its EMAs and the optimizer from
``--output-dir``, then runs one train step per batch. Step N draws from
its own generator, seeded from (--seed, N), so a resumed run draws what
an uninterrupted one would. Metric fetches lag the steps by
``--pipeline-depth``, so the host queues the next step while the card
runs the last; every ``--save-interval`` steps the loop writes
``model.npz`` and ``model_ema_<rate>.npz`` (the JAX package's format,
VQ usage counts included), the optimizer state ``opt.pt`` and a
``# saved`` line in ``train_log.txt``.

The JAX package's optimizer state (``opt.npz``, msgpack) and its Orbax
checkpoints are not read: a run directory that holds either and no
``opt.pt`` is refused rather than resumed with fresh moments. Not ported: tensor parallelism, FSDP, Orbax
checkpoints, asynchronous saves, several steps per dispatch, activation
rematerialisation and the profiler flag; the CLIs refuse them.
"""

import argparse
import json
import os
import sys
import time
from abc import ABC, abstractmethod
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import create_data_loader
from ..diffusion_model import DiffusionModel
from ..model_base import ModelBase
from ..models.init import init_like_flax
from ..observe import Logger, LossTracker
from ..util import resolve_device
from ..vq import VQLossConfig
from ..vq_vae import VQVAE
from .ema import EMA
from .state import build_optimizer, prefix_predicate
from .steps import LossFn, TrainStep, VQUpdateRule

__all__ = ["DiffusionTrainLoop", "TrainLoop", "VQVAETrainLoop", "step_generator"]

# The JAX package's flags that the port does not run, and why.
NOT_PORTED = {
    "--tensor-parallel": "tensor parallelism",
    "--fsdp": "FSDP",
    "--async-save": "asynchronous saves",
    "--async-snapshot": "asynchronous saves",
    "--steps-per-dispatch": "several steps per dispatch",
    "--grad-checkpoint": "activation rematerialisation",
    "--profile-dir": "the profiler flag",
}


# What a JAX run directory holds that this port cannot resume from: the
# msgpack optimizer state of an npz run, and an Orbax run's model and
# optimizer (an interrupted Orbax save leaves them as ``<name>.new``).
JAX_CHECKPOINTS = ("opt.npz", "model.orbax", "opt.orbax")


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} ({NOT_PORTED[option_string]}) is not ported to "
                     "vq_voice_swap_torch yet (ROADMAP.md queue 1)")


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of global step ``step``, seeded from (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def repeat_dataset(loader):
    """Iterate a data loader forever."""
    while True:
        yield from loader


class TrainLoop(ABC):
    """Subclasses give the model, its loss and its flags."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        os.makedirs(args.output_dir, exist_ok=True)
        jax_ckpts = [f for f in JAX_CHECKPOINTS
                     if os.path.exists(self.path(f)) or os.path.exists(self.path(f + ".new"))]
        if jax_ckpts and not os.path.exists(self.opt_path()):
            raise RuntimeError(
                f"{args.output_dir} holds the JAX package's checkpoint ({', '.join(jax_ckpts)}) "
                "and no opt.pt: this port cannot read its optimizer state, and resuming with "
                "fresh Adam moments (or starting afresh over its log) would be a different "
                "run. Warm-start from an npz model with --pretrained-path into a fresh "
                "--output-dir instead."
            )
        self.device = resolve_device(args.device)
        self.rng_seed = args.seed
        self.data_loader, self.num_labels = create_data_loader(
            args.data_dir, args.batch_size, encoding=args.encoding, seed=self.rng_seed)
        self.model, self.resume = self.create_model()

        self.ema_rates = [float(r) for r in args.ema_rate.split(",")]
        if len(set(self.ema_rates)) != len(self.ema_rates):
            raise ValueError(f"duplicate EMA rates in {args.ema_rate!r}")
        self.emas = self.create_emas()
        self.optimizer = build_optimizer(
            self.model, lr=args.lr, weight_decay=args.weight_decay,
            frozen_fn=self.frozen_predicate(), lr_final=args.lr_final,
            lr_anneal_steps=args.lr_anneal_steps, grad_clip=args.grad_clip)
        if os.path.exists(self.opt_path()):
            print("loading optimizer state from checkpoint...")
            self.optimizer.load_state_dict(
                torch.load(self.opt_path(), map_location=self.device, weights_only=True))

        self.logger = Logger(self.path("train_log.txt"), resume=self.resume)
        self.tracker = LossTracker()
        self.total_steps = self.logger.start_step
        self.loop_steps = 0

        microbatches, micro_remainder = 1, 0
        if args.microbatch and args.microbatch < args.batch_size:
            microbatches = args.batch_size // args.microbatch
            micro_remainder = args.batch_size % args.microbatch
        self.train_step = TrainStep(
            self.model, self.build_loss_fn(), self.optimizer, self.emas,
            microbatches=microbatches, micro_remainder=micro_remainder,
            vq_rule=self.vq_update_rule())
        self._pending: deque = deque()
        self._last_finish: Optional[float] = None
        self.write_run_info()

    # ----------------------------------------------------------- main loop

    def loop(self, max_steps: Optional[int] = None) -> None:
        if max_steps is None:
            max_steps = self.args.max_steps
        try:
            for i, batch in enumerate(repeat_dataset(self.data_loader)):
                if max_steps is not None and i >= max_steps:
                    break
                self.total_steps = i + self.logger.start_step
                self.loop_steps = i
                self.step(batch)
        finally:
            self._flush_pending()

    def step(self, batch: Dict[str, np.ndarray]) -> None:
        """Run one train step; fetch the metrics of the step
        --pipeline-depth steps back; save on the interval."""
        generator = step_generator(self.rng_seed, self.total_steps, self.device)
        dispatched = time.perf_counter()
        metrics = self.train_step(self.to_device(batch), generator)
        self._pending.append((self.loop_steps, metrics, dispatched))
        while len(self._pending) > max(1, self.args.pipeline_depth):
            self._flush_one()
        if (self.total_steps + 1) % self.args.save_interval == 0:
            self._flush_pending()  # the '# saved' line follows this step's line
            self.save()

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
        """Fetch and log the metrics of the oldest step (waits for it)."""
        loop_steps, metrics, dispatched = self._pending.popleft()
        loss = float(metrics["loss"])
        now = time.perf_counter()
        # Between completions; the first step's from its dispatch.
        baseline = self._last_finish or dispatched
        self._last_finish = now
        self.tracker.add(metrics["ts"].cpu().numpy(), metrics["mses"].float().cpu().numpy())
        other = {k: float(v) for k, v in metrics["extra"].items()}
        if "codebook_used" in metrics:
            other["codebook_used"] = float(metrics["codebook_used"])
        other["samples_per_sec"] = self.args.batch_size / (now - baseline)
        other.update(self.tracker.log_dict())
        self.logger.log(loop_steps + 1, loss=loss, **other)

    def _flush_pending(self) -> None:
        while self._pending:
            self._flush_one()

    # ------------------------------------------------------------- plumbing

    def path(self, name: str) -> str:
        return os.path.join(self.args.output_dir, name)

    def checkpoint_path(self) -> str:
        return self.path("model.npz")

    def ema_path(self, rate: float) -> str:
        return self.path(f"model_ema_{rate}.npz")

    def opt_path(self) -> str:
        return self.path("opt.pt")

    def create_model(self) -> Tuple[DiffusionModel, bool]:
        if os.path.exists(self.checkpoint_path()):
            print("loading from checkpoint...")
            model = self.model_class().load(self.checkpoint_path(), device=self.device)
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
        src_state = src.state_dict()
        copied = {}
        for name, value in model.state_dict().items():
            if name in src_state:
                if src_state[name].shape != value.shape:
                    raise ValueError(f"parameter {name} has shape {tuple(value.shape)} in "
                                     f"the model but {tuple(src_state[name].shape)} in "
                                     f"{self.args.pretrained_path}")
                copied[name] = src_state[name]
        model.load_state_dict(copied, strict=False)
        return sum(v.numel() for v in copied.values())

    def check_pretrained(self, src: ModelBase) -> ModelBase:
        return src

    def create_emas(self) -> List[EMA]:
        emas = []
        for rate in self.ema_rates:
            ema = EMA(self.model, rate)
            if os.path.exists(self.ema_path(rate)):
                print(f"loading EMA {rate} from checkpoint...")
                ema.model.load_state_dict(
                    ModelBase.load(self.ema_path(rate), device=self.device).state_dict())
            emas.append(ema)
        return emas

    def save(self) -> None:
        self.model.save(self.checkpoint_path())
        with torch.no_grad():
            for ema in self.emas:
                # An EMA file carries the model's current buffers (usage counts).
                for dst, src in zip(ema.model.buffers(), self.model.buffers()):
                    dst.copy_(src)
                ema.model.save(self.ema_path(ema.rate))
        tmp = self.opt_path() + ".tmp"
        torch.save(self.optimizer.state_dict(), tmp)
        os.replace(tmp, self.opt_path())
        self.logger.mark_save()

    def write_run_info(self) -> None:
        info = dict(args=vars(self.args), command=sys.argv[0], start_steps=self.total_steps,
                    num_devices=1, device=str(self.device))
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
    def create_new_model(self) -> DiffusionModel:
        """A fresh model on the CPU (the loop initialises its weights)."""

    @abstractmethod
    def build_loss_fn(self) -> LossFn:
        """The train step's loss_fn(batch, generator, draws)."""

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
        parser.add_argument("--encoding", default="linear", type=str)
        parser.add_argument("--seed", default=0, type=int)
        parser.add_argument("--bf16", action="store_true",
                            help="compute in bfloat16 (params stay float32)")
        parser.add_argument("--pipeline-depth", default=1, type=int,
                            help="how many steps metric fetches may lag behind")
        parser.add_argument("--max-steps", default=None, type=int,
                            help="stop after this many steps (default: run until killed)")
        parser.add_argument("--checkpoint-format", default="npz", choices=("npz",),
                            help="npz only; Orbax directories are not ported")
        parser.add_argument("--device", default=None,
                            help="torch device (default: cuda)")
        for flag in NOT_PORTED:
            parser.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)
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
        )

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
        )

    def create_model(self):
        model, resume = super().create_model()
        model.dead_rate = self.args.dead_rate  # a runtime setting, not a weight
        return model, resume

    def check_pretrained(self, src):
        # A VQVAE or a bare DiffusionModel: the predictor intersects either way.
        if not isinstance(src, DiffusionModel):
            raise ValueError(f"unsupported pretrained model: {type(src).__name__}")
        return src

    def build_loss_fn(self):
        model = self.model
        class_cond = self.args.class_cond
        vq_cfg = VQLossConfig(commitment=self.args.commitment_coeff,
                              revival=self.args.revival_coeff)
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

    def frozen_predicate(self):
        prefixes = []
        if self.args.freeze_encoder:
            prefixes.append("encoder")
        if self.args.freeze_vq:
            prefixes.append("vq")
        return prefix_predicate(prefixes) if prefixes else None

    def vq_update_rule(self):
        # Hard revival only without the revival loss and with a trained codebook.
        revive = not self.args.revival_coeff and not self.args.freeze_vq
        return VQUpdateRule(dead_rate=self.args.dead_rate, revive=revive)

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
