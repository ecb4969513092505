"""Named spans of the port's hot paths, on the profiler's clock.

``span(name)`` is a ``torch.profiler.record_function`` range while a
torch.profiler session is active (``--profile-dir``, or any caller's
``torch.profiler.profile``), so the span lands in the same trace as the
ops and kernels it encloses; otherwise it is one shared no-op context,
which costs a flag read (an inactive ``record_function`` still costs
microseconds a call).

The spans, each opened where its work happens and never across a
``yield``:

- ``vvs.encode``: ``VQVAE.encode``, the encoder and the VQ assignment;
- ``vvs.step``: one iteration of a sampler loop (``diffusion/process.py``),
  the predictor call and the update;
- ``vvs.predict``: ``DiffusionModel.predict_eps``, one predictor forward;
- ``vvs.data.wait``: the consumer's wait on the loader's queue
  (``data/loader.py``);
- ``vvs.train.stage``: a train window's (or step's) batch stacked and
  copied to the device (``train/loops.py``);
- ``vvs.train.flush``: ``TrainLoop._flush_one``, the metrics fetch of the
  oldest dispatch and its log lines.

Span names avoid "Launch", "Memcpy" and "Memset", which trace readers take
for the CUDA runtime's calls."""

from contextlib import nullcontext

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span"]

_OFF = nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is active, else a
    no-op context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
