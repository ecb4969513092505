"""Training loops on one device (counterpart of the JAX package's
``vq_voice_swap_tpu/train/loops.py``): ``DiffusionTrainLoop``,
``VQVAETrainLoop``, ``VQVAEAddClassesTrainLoop`` (new speakers' label
embeddings alone), ``VQVAEUncondTrainLoop`` (classifier-free guidance
fine-tuning), ``ClassifierTrainLoop`` and ``EncoderPredictorTrainLoop``.

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
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..classifier_model import ClassifierModel, EncoderPredictorModel
from ..data import create_data_loader
from ..diffusion import Diffusion, make_schedule
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
            # Read to the CPU: AdamW moves the moments to their parameters'
            # device and leaves each step count where it finds it, and a
            # count on the card would cost two host syncs a parameter a step.
            self.optimizer.load_state_dict(
                torch.load(self.opt_path(), map_location="cpu", weights_only=True))

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
        device_batch = self.to_device(self.prepare_batch(batch))
        dispatched = time.perf_counter()
        metrics = self.train_step(device_batch, generator)
        self._pending.append((self.loop_steps, metrics, dispatched))
        while len(self._pending) > max(1, self.args.pipeline_depth):
            self._flush_one()
        if (self.total_steps + 1) % self.args.save_interval == 0:
            self._flush_pending()  # the '# saved' line follows this step's line
            self.save()

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

    def create_model(self) -> Tuple[ModelBase, bool]:
        if os.path.exists(self.checkpoint_path()):
            print("loading from checkpoint...")
            model = self.model_class().load(self.checkpoint_path(), device=self.device,
                                            frozen=False)
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
    def create_new_model(self) -> ModelBase:
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
