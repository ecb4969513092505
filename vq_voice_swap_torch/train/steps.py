"""The train step (counterpart of ``vq_voice_swap_tpu/train/steps.py``):
microbatch gradient accumulation with a weighted remainder, the optimizer
update, the VQ codebook maintenance and the EMAs.

A batch that does not divide into microbatches is accumulated as the JAX
package accumulates it: ``microbatches`` equal chunks and one remainder
chunk, each chunk's gradient, loss and ``extra`` metrics weighted by its
share of the batch; the chunks' ``used`` masks are OR-ed and their per-row
outputs concatenated. After the update the codebook's usage counts decay
by the number of forwards (used codes go to dead_rate), ``codebook_used``
counts the live codes, and dead codes are revived from the step's encoder
outputs when the rule says so; then the EMAs follow the new parameters.

The step's random draws can leave it: ``draw`` returns, for each forward,
every tensor the loss would draw from the step's generator, in the order
the loss draws them (a ``Drawer`` of the loop's). A step given those draws
computes what it would have drawn itself. The step is four parts:
``forward_backward`` (the forwards and the accumulated gradients, which
``train/graphs.py`` captures in a CUDA graph), the optimizer update,
``codebook`` (the usage update, and the revival's probabilities) and
``finish`` (the revival from picks drawn from those probabilities, then
the EMAs).

On N ranks (a ``sync``, ``parallel.dist.StepSync``) the step computes what
the one-device step computes on the global batch: every rank draws the
global chunks' draws and keeps its rows, weights its chunks' losses by
their share of the global batch (its local weights over N), and after the
backward ``synchronize`` sums the gradients and the scalar metrics and
gathers the per-row ones; the codebook ORs the ``used`` masks over the
ranks and revives from every rank's encoder rows, in the global batch's
order, so that every rank draws the same picks and keeps the same
codebook. Under tensor parallelism the ranks of a model group are one data
row: they draw the same rows' draws and compute the same loss, and these
collectives run over the data group (``parallel/dist.py``).
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.dist import StepSync
from ..vq import draw_revival_picks, revival_probs, revive_dead_codes, update_usage
from .ema import EMA
from .state import Optimizer

__all__ = ["Drawer", "LossFn", "Revival", "TrainStep", "VQUpdateRule"]

# loss_fn(batch, generator, draws) -> (scalar loss, aux): aux holds "mses"
# and "ts" (per row), "extra" ({name: scalar}) and, for a VQ model, "idxs",
# "used" and "enc_flat". ``draws`` are keyword arguments of the model's
# losses that replace its random draws (empty in training).
LossFn = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator], Dict[str, Any]],
                  Tuple[torch.Tensor, Dict[str, Any]]]

# drawer(sub_batch, generator) -> the draws of one forward of loss_fn on
# sub_batch: the keyword arguments that replace its random draws, drawn
# from generator in the order loss_fn would draw them.
Drawer = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator]], Dict[str, Any]]


@dataclass
class Revival:
    """What the revival of dead codes needs from ``TrainStep.codebook``:
    the decayed usage counts, the step's encoder rows and their k-means++
    probabilities."""

    usage: torch.Tensor
    enc_flat: torch.Tensor
    probs: torch.Tensor


@dataclass(frozen=True)
class VQUpdateRule:
    """How the train step maintains the VQ codebook's usage counts."""

    dead_rate: int
    revive: bool  # revive dead codes after each update


class TrainStep:
    """(batch, generator) -> metrics: one optimizer step of ``model``.

    ``microbatches`` is the number of full chunks and ``micro_remainder``
    the size of a trailing partial one (0: none). Metrics stay on the
    device: "loss", "mses", "ts", "extra" and, with a ``vq_rule``,
    "codebook_used". ``drawer`` gives ``draw``; ``sync`` makes it one
    rank's share of a distributed step."""

    def __init__(
        self,
        model: nn.Module,
        loss_fn: LossFn,
        optimizer: Optimizer,
        emas: Sequence[EMA] = (),
        microbatches: int = 1,
        micro_remainder: int = 0,
        vq_rule: Optional[VQUpdateRule] = None,
        drawer: Optional[Drawer] = None,
        sync: Optional[StepSync] = None,
    ):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.emas = list(emas)
        self.microbatches = microbatches
        self.micro_remainder = micro_remainder
        self.vq_rule = vq_rule
        self.drawer = drawer
        self.sync = sync
        self.world = sync.world if sync is not None else 1

    @property
    def n_forwards(self) -> int:
        return self.microbatches + (1 if self.micro_remainder else 0)

    def chunks(self, batch: Dict[str, torch.Tensor]) -> List[Tuple[float, Dict[str, torch.Tensor]]]:
        """(weight, sub-batch) of each forward; a scalar entry (a curriculum
        power) goes to every sub-batch whole."""
        if self.microbatches == 1 and not self.micro_remainder:
            return [(1.0, batch)]
        size = max(v.shape[0] for v in batch.values() if v.ndim)
        full = size - self.micro_remainder
        micro, rem = divmod(full, self.microbatches)
        if rem:
            raise ValueError(f"batch {size} != {self.microbatches}x{micro}"
                             f"+{self.micro_remainder}")
        bounds = [(i * micro, (i + 1) * micro) for i in range(self.microbatches)]
        if self.micro_remainder:
            bounds.append((full, size))
        return [((hi - lo) / size, {k: v[lo:hi] if v.ndim else v for k, v in batch.items()})
                for lo, hi in bounds]

    def draw(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> List[Dict[str, Any]]:
        """The draws of each forward of the step, drawn from ``generator``
        as the step itself would draw them (on N ranks: this rank's rows of
        the global chunks' draws)."""
        if self.sync is not None:
            return [self.sync.local_draws(self.drawer, mb, generator)
                    for _, mb in self.chunks(batch)]
        return [self.drawer(mb, generator) for _, mb in self.chunks(batch)]

    def __call__(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator],
        draws: Optional[Sequence[Dict[str, Any]]] = None,
        revive_picks: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """``draws`` (one dict per forward) and ``revive_picks`` replace
        the step's random draws from ``generator``."""
        if self.sync is not None and draws is None:
            draws = self.draw(batch, generator)
        metrics, auxes = self.forward_backward(batch, generator, draws)
        self.synchronize(metrics, auxes)
        self.optimizer.step()
        revival = self.codebook(metrics, auxes)
        if revival is not None and revive_picks is None:
            revive_picks = draw_revival_picks(revival.probs, revival.usage.shape[0], generator)
        self.finish(revival, revive_picks)
        return metrics

    def forward_backward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator],
        draws: Optional[Sequence[Dict[str, Any]]] = None,
    ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
        """The forwards and their weighted gradients (written to ``.grad``):
        (metrics, each forward's aux)."""
        self.optimizer.zero_grad()
        loss = 0.0
        extra: Dict[str, torch.Tensor] = {}
        auxes = []
        for i, (weight, mb) in enumerate(self.chunks(batch)):
            weight = weight / self.world
            mb_loss, aux = self.loss_fn(mb, generator, draws[i] if draws else {})
            (mb_loss if weight == 1.0 else mb_loss * weight).backward()
            loss = loss + mb_loss.detach() * weight
            for k, v in aux["extra"].items():
                extra[k] = extra.get(k, 0.0) + v.detach() * weight
            auxes.append(aux)
        metrics = {"loss": loss, "mses": _cat(auxes, "mses"), "ts": _cat(auxes, "ts"),
                   "extra": extra}
        return metrics, auxes

    def synchronize(self, metrics: Dict[str, Any], auxes: List[Dict[str, Any]]) -> None:
        """On N ranks, after the backward: the gradients summed over the
        ranks, and ``metrics`` made the global step's (in place)."""
        if self.sync is None:
            return
        self.sync.reduce_grads()
        keys = sorted(metrics["extra"])
        summed = self.sync.sum_scalars([metrics["loss"]] + [metrics["extra"][k] for k in keys])
        metrics["loss"] = summed[0]
        metrics["extra"] = dict(zip(keys, summed[1:]))
        rows = [a["ts"].shape[0] for a in auxes]
        for k in ("mses", "ts"):
            metrics[k] = self.sync.gather_rows(metrics[k], rows)

    def codebook(self, metrics: Dict[str, Any],
                 auxes: List[Dict[str, Any]]) -> Optional[Revival]:
        """After the update: the usage counts' update, and ``metrics``'
        "codebook_used". The counts are written to the codebook, or, when
        the rule revives, returned with the revival's probabilities."""
        if self.vq_rule is None:
            return None
        with torch.no_grad():
            vq = self.model.vq
            used = auxes[0]["used"]
            for a in auxes[1:]:
                used = used | a["used"]
            if self.sync is not None:
                used = self.sync.any_used(used)
            usage = update_usage(vq.usage_count, _cat(auxes, "idxs"), self.vq_rule.dead_rate,
                                 decay=self.n_forwards, used=used)
            # Liveness before revival refills the dead codes.
            metrics["codebook_used"] = (usage > 0).sum()
            if not self.vq_rule.revive:
                vq.usage_count.copy_(usage)
                return None
            enc_flat = _cat(auxes, "enc_flat")
            if self.sync is not None:
                enc_flat = self.sync.gather_rows(enc_flat, [a["ts"].shape[0] for a in auxes])
            return Revival(usage, enc_flat, revival_probs(vq.dictionary, enc_flat))

    def finish(self, revival: Optional[Revival], picks: Optional[torch.Tensor]) -> None:
        """Revive the dead codes from ``picks`` (row indices of the
        revival's encoder rows, one a code), then update the EMAs."""
        if revival is not None:
            with torch.no_grad():
                vq = self.model.vq
                dictionary, usage = revive_dead_codes(
                    vq.dictionary, revival.usage, revival.enc_flat, self.vq_rule.dead_rate,
                    picks=picks)
                vq.dictionary.copy_(dictionary)
                vq.usage_count.copy_(usage)
        for ema in self.emas:
            ema.update(self.model)


def _cat(auxes: List[Dict[str, Any]], key: str) -> torch.Tensor:
    return torch.cat([a[key] for a in auxes])
