"""The forwards and backward of a train step captured as a CUDA graph and
replayed: the card's counterpart of the JAX package's ``lax.scan`` over K
steps (``--steps-per-dispatch``).

``GraphedTrainStep(step)`` is called as the step is, once a train step.
Its first call warms the forwards and backward up on a side stream
(cuBLAS and cuDNN handles, Triton's compile, the kernels' ticket buffers
of that stream; nothing it computes is kept) and captures them on that
stream. Each call then:

1. draws the step's random tensors from its generator (``TrainStep.draw``,
   as the eager step would draw them) and copies them and the batch (the
   curriculum's ``ts_power`` included) into the graph's static inputs;
2. replays the graph: every forward and the accumulated gradients, the
   thousands of launches that hold the eager step to the host's pace;
3. runs the rest of the step as the eager step runs it, on the graph's
   outputs: on N ranks the gradients' all-reduce and the metrics' (the
   flat gradient buffer's views are the graph's static gradients), the
   optimizer update, the codebook's usage counts, the
   revival (its picks are drawn from probabilities the step computes) and
   the EMAs. These are the eager step's own calls, so the step's
   arithmetic is the eager step's: AdamW keeps its step counts on the CPU
   and its learning rate on the host;
4. returns the metrics, cloned from the graph's outputs, which the next
   replay overwrites.

Parameters and their gradients keep their memory between replays, so load
a resumed state before the first call, in place. A failed warm-up or
capture raises.
"""

from typing import Any, Dict, Optional

import torch

from ..util import tree_map
from ..vq import draw_revival_picks
from .steps import TrainStep

__all__ = ["GraphedTrainStep", "WARMUP_STEPS"]

# Eager forward-backward passes on the capturing stream before the capture.
WARMUP_STEPS = 2


def _copy_into(dst: Any, src: Any) -> None:
    """Copy every tensor of ``src`` into ``dst``'s (the same structure)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src, non_blocking=True)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"a step's inputs changed keys: {sorted(src)} vs {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError("a step's inputs changed length")
        for d, s in zip(dst, src):
            _copy_into(d, s)


class GraphedTrainStep:
    """``step`` (a ``TrainStep`` with the loop's drawer, on CUDA) with its
    forwards and backward replayed from a CUDA graph."""

    def __init__(self, step: TrainStep):
        if step.drawer is None:
            raise ValueError("a captured step needs the loop's drawer")
        self.step = step
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        step = self.step
        draws = step.draw(batch, generator)
        if self.graph is None:
            self._capture(batch, draws)
        _copy_into(self.inputs, (batch, draws))
        self.graph.replay()
        # The gradients the graph writes, whatever an eager step since has
        # set the parameters' .grad to.
        for p, g in zip(step.optimizer.params, self.grads):
            p.grad = g
        metrics = tree_map(torch.clone, self.metrics)
        step.synchronize(metrics, self.auxes)
        step.optimizer.step()
        revival = step.codebook(metrics, self.auxes)
        picks = None
        if revival is not None:
            picks = draw_revival_picks(revival.probs, revival.usage.shape[0], generator)
        step.finish(revival, picks)
        return metrics

    def _capture(self, batch, draws) -> None:
        step = self.step
        device = batch["samples"].device
        self.inputs = tree_map(torch.clone, (batch, draws))
        static_batch, static_draws = self.inputs
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                step.forward_backward(static_batch, None, static_draws)
        torch.cuda.current_stream(device).wait_stream(stream)
        step.optimizer.zero_grad()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.metrics, self.auxes = step.forward_backward(static_batch, None, static_draws)
        self.grads = [p.grad for p in step.optimizer.params]
