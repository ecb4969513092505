"""Processes, ranks and the collectives of data-parallel training
(counterpart of the JAX package's ``parallel/mesh.py``, and of
``create_mesh_2d`` in its ``parallel/tensor.py``).

A run launched by ``torchrun`` (``python -m torch.distributed.run``) finds
``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` in its environment;
``init_distributed`` then starts the process group (NCCL on CUDA, gloo on
the CPU) and returns this rank's device, ``cuda:LOCAL_RANK`` unless the
caller names a card. Without those variables it is a no-op and the run is
the single-device run. Set but failing, it raises: a rank that fell back to
training alone would race the others' writes to the run directory.

The train step's collectives are plain ones, not ``DistributedDataParallel``
(whose reducer hooks a captured CUDA graph must not hold): ``GradBuffer``
keeps the gradients as views of one flat buffer, all-reduced with one call
a step, and ``StepSync`` holds the rest (metrics, the VQ ``used`` masks, the
rows that the codebook's revival draws from). At world size 1 every one of
them leaves its input's bits as they are.

The grid. ``init_grid(T)`` lays the N ranks out as D = N / T data rows
by T model columns, row-major as the JAX package's ``create_mesh_2d``:
ranks ``d*T .. d*T+T-1`` are data row d's model group (tensor parallelism,
``parallel/tensor.py``), ranks ``m, T+m, ...`` model index m's data group.
Without a grid (T = 1) every rank is a data row of its own and the data
group is the default group. The grid is process-wide state, as the default
process group it lays out is: every rank calls ``init_grid`` once, after
``init_distributed`` and before it places a model.

Row layout. Data row d's local row j is row ``d + D * j`` of the global
batch (D data rows): the data loader gives every data row a strided slice
of one shared permutation (``data/loader.py``), so the global batch is the
batch that the world-size-1 run at D times the batch size draws, row for
row; the T ranks of a model group see the same rows and make the same
draws. Microbatch chunk c of the global batch is made of every data row's
chunk c, interleaved the same way. The train step's collectives run on
the data group.
"""

import atexit
import datetime
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from ..util import resolve_device, tree_map

__all__ = [
    "GradBuffer",
    "Grid",
    "StepSync",
    "agree",
    "broadcast_from_primary",
    "data_group",
    "data_rank",
    "data_size",
    "gather_data_rows",
    "grid",
    "init_distributed",
    "init_grid",
    "is_primary",
    "launched",
    "local_tensor",
    "rank",
    "rank_device",
    "world_size",
]

# The variables a launcher sets; any one of them means a distributed run.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def launched() -> bool:
    """Is this process one rank of a launched (torchrun) run?"""
    return any(os.environ.get(k) for k in LAUNCH_ENV)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def rank_device(device: Optional[str]) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``cuda`` (the default)
    in a launched run, else the device named. Raises when CUDA is asked
    for and absent, or the card is not on this host."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) if launched() else 0)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {os.environ.get('RANK', 0)} runs on {dev}, but this host "
                               f"has {torch.cuda.device_count()} CUDA device(s)")
    return dev


def init_distributed(device: Optional[str] = None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Start the process group of a launched run and return this rank's
    device (``rank_device``); without the launcher's environment, just the
    device. ``backend`` defaults to NCCL for CUDA and gloo otherwise.
    Raises if the launcher's environment is set but the group cannot
    start."""
    if not launched():
        return resolve_device(device)
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
    except Exception as e:
        raise RuntimeError(
            "torch.distributed failed to start, but the launcher's environment is set "
            f"({', '.join(f'{k}={os.environ.get(k)}' for k in LAUNCH_ENV + ('MASTER_PORT',))}): "
            "refusing to fall back to single-process training") from e
    atexit.register(_shutdown)
    return dev


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Grid:
    """The (data, model) grid of a launched run's ranks (see the module)."""

    def __init__(self, tensor_parallel: int, device_type: str):
        world, me = world_size(), rank()
        self.model_size, self.data_size = tensor_parallel, world // tensor_parallel
        self.data_rank, self.model_rank = divmod(me, tensor_parallel)
        self.mesh: DeviceMesh = init_device_mesh(
            device_type, (self.data_size, self.model_size), mesh_dim_names=("data", "model"))
        self.data_group = self.mesh.get_group("data")
        self.model_group = self.mesh.get_group("model")


_GRID: Optional[Grid] = None


def init_grid(tensor_parallel: int, device: Optional[torch.device] = None) -> Optional[Grid]:
    """Lay the ranks out as a (data, model) grid of ``tensor_parallel``
    model columns (every rank calls it, after ``init_distributed``) and
    return it; None at 1, where the run is a data-parallel one.
    Raises ValueError, as the JAX package's ``create_mesh_2d`` does, when
    the world is not a launched one that ``tensor_parallel`` divides."""
    global _GRID
    _GRID = None
    tensor_parallel = max(1, tensor_parallel or 1)
    if tensor_parallel == 1:
        return None
    if not dist.is_initialized() or world_size() % tensor_parallel:
        raise ValueError(
            f"--tensor-parallel {tensor_parallel} needs a launched world that "
            f"{tensor_parallel} divides (python -m torch.distributed.run --nproc-per-node N "
            f"-m ...), got a world of {world_size()}")
    device_type = (device or torch.device("cpu")).type
    _GRID = Grid(tensor_parallel, device_type)
    return _GRID


def grid() -> Optional[Grid]:
    """The grid that ``init_grid`` laid out, or None."""
    return _GRID


def data_rank() -> int:
    return rank() if _GRID is None else _GRID.data_rank


def data_size() -> int:
    return world_size() if _GRID is None else _GRID.data_size


def data_group() -> Optional[dist.ProcessGroup]:
    """The data group's process group (None: the default group)."""
    return None if _GRID is None else _GRID.data_group


def gather_data_rows(local: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-row tensor whose rows ``local`` holds
    this data row's share of, in the row layout (one all-gather over the
    data group)."""
    size = data_size()
    if size == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous(), group=data_group())
    return torch.stack(parts, dim=1).reshape(size * local.shape[0], *local.shape[1:])


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (sharing its memory), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _comm_device() -> torch.device:
    """The device the default group's collectives take tensors on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@torch.no_grad()
def broadcast_from_primary(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite ``tensors`` (plain, the same list on every rank) with rank
    0's, one broadcast a dtype: rank 0's freshly built or resumed state
    becomes every rank's (the JAX loop's ``_sync_state_from_primary``)."""
    if world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    comm = _comm_device()
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        if dtype == torch.bool:
            flat = torch.cat([t.reshape(-1).to(comm, torch.uint8) for t in group])
        else:
            flat = torch.cat([t.reshape(-1).to(comm) for t in group])
        dist.broadcast(flat, 0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def agree(values: Sequence[int], what: str) -> None:
    """Raise unless every rank passes the same ``values``."""
    if world_size() == 1:
        return
    mine = torch.tensor(list(values), dtype=torch.int64, device=_comm_device())
    every = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(every, mine)
    if any(not torch.equal(e, every[0]) for e in every):
        raise RuntimeError(f"the ranks disagree on {what}: "
                           f"{[e.tolist() for e in every]} (rank order)")


class GradBuffer:
    """The gradients of the plain tensors of ``params`` (one dtype, one
    device) as views of one flat buffer. Each ``.grad`` is pointed at its
    view once, here: autograd then accumulates into it in place, and a
    CUDA graph captured later writes its gradients there. ``zero_grad``
    zeroes the buffer in place and sets the gradients of the other
    parameters (FSDP's shards, ``DTensor``s) to None; ``all_reduce`` sums
    the buffer over the data group in one call.

    On the grid ``model_cut`` flags the parameters cut over the model
    group (``tensor.cut_axes``). Each rank's shard of a cut one has its
    own gradient; a whole one has the same gradient on every rank of a
    model group only up to the order of a backward's atomic sums, so
    ``all_reduce`` then broadcasts model rank 0's gradients of the whole
    ones over the model group (the buffer holds them first), and their
    copies never drift apart. ``data_group``, ``model_group`` and
    ``model_cut`` are what the optimizer's clip sums a norm over."""

    def __init__(self, params: Sequence[torch.Tensor], model_cut: Optional[Sequence[bool]] = None):
        g = grid()
        if g is not None and model_cut is None:
            raise ValueError("on a (data, model) grid a gradient buffer needs model_cut")
        self.model_cut = list(model_cut) if model_cut is not None else [False] * len(params)
        self.data_group = data_group()
        self.model_group = None if g is None else g.model_group
        plain = [(p, cut) for p, cut in zip(params, self.model_cut) if not isinstance(p, DTensor)]
        self.params = [p for p, cut in plain if not cut] + [p for p, cut in plain if cut]
        self.n_whole = sum(p.numel() for p, cut in plain if not cut)
        self.others = [p for p in params if isinstance(p, DTensor)]
        self.whole_others = [p for p, cut in zip(params, self.model_cut)
                             if isinstance(p, DTensor) and not cut]
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) > 1:
            raise ValueError(f"a gradient buffer holds one dtype, got {sorted(map(str, dtypes))}")
        n = sum(p.numel() for p in self.params)
        device = self.params[0].device if self.params else torch.device("cpu")
        self.flat = torch.zeros(n, dtype=self.params[0].dtype if self.params else torch.float32,
                                device=device)
        offset = 0
        for p in self.params:
            p.grad = self.flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()

    def zero_grad(self) -> None:
        self.flat.zero_()
        for p in self.others:
            p.grad = None

    def all_reduce(self) -> None:
        if self.params:
            dist.all_reduce(self.flat, group=self.data_group)
        if self.model_group is None:
            return
        src = dist.get_global_rank(self.model_group, 0)
        if self.n_whole:
            dist.broadcast(self.flat[:self.n_whole], src, group=self.model_group)
        shards = [p.grad.to_local() for p in self.whole_others if p.grad is not None]
        if shards:  # FSDP's shards of whole leaves, reduce-scattered by its hooks
            flat = torch.cat([t.reshape(-1) for t in shards])
            dist.broadcast(flat, src, group=self.model_group)
            for t, v in zip(shards, flat.split([t.numel() for t in shards])):
                t.copy_(v.view_as(t))


class StepSync:
    """The collectives of one train step on this rank (see the module's
    row layout): ``grads`` (a ``GradBuffer``, or None) is all-reduced
    after the backward; the rest is called by ``TrainStep``."""

    def __init__(self, grads: Optional[GradBuffer] = None):
        self.grads = grads
        self.world = data_size()
        self.rank = data_rank()
        self.group = data_group()

    def local_draws(self, drawer: Callable, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator]) -> Dict[str, Any]:
        """``drawer``'s draws for this data row's rows of the global chunk
        that ``batch`` (its chunk) belongs to: drawn at the global chunk's
        size (drawers read shapes only) and cut to its rows, so every rank
        consumes the generator as the world-size-1 run at the global batch
        does."""
        if self.world == 1:
            return drawer(batch, generator)
        ghost = {k: v.new_empty((v.shape[0] * self.world, *v.shape[1:])) if v.ndim else v
                 for k, v in batch.items()}
        return tree_map(lambda t: t[self.rank::self.world], drawer(ghost, generator))

    def reduce_grads(self) -> None:
        if self.grads is not None:
            self.grads.all_reduce()

    def sum_scalars(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's weighted share of scalar metrics, summed, in one
        all-reduce."""
        if not values:
            return values
        stacked = torch.stack([v.float() for v in values])
        dist.all_reduce(stacked, group=self.group)
        return [s.to(v.dtype) for s, v in zip(stacked.unbind(), values)]

    def gather_rows(self, local: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
        """The global batch's rows of a per-row tensor: ``local`` is this
        rank's chunks concatenated (chunk c: ``rows[c]`` batch rows, each
        ``local.shape[0] / sum(rows)`` entries along dim 0); returns the
        global chunks in order, each interleaved by data row."""
        if self.world == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        every = torch.stack(parts)
        per_row = local.shape[0] // sum(rows)
        rest = local.shape[1:]
        out, offset = [], 0
        for n in rows:
            block = every[:, offset * per_row:(offset + n) * per_row]
            out.append(block.reshape(self.world, n, per_row, *rest).transpose(0, 1)
                       .reshape(self.world * n * per_row, *rest))
            offset += n
        return torch.cat(out)

    def any_used(self, used: torch.Tensor) -> torch.Tensor:
        """The OR over the data rows of a [D] bool mask."""
        as_int = used.to(torch.uint8)
        dist.all_reduce(as_int, op=dist.ReduceOp.MAX, group=self.group)
        return as_int.bool()
