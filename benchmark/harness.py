"""What every cell of the benchmark shares: the manifest and the files it
names, seeds, seeded weights and inputs made on the device, the traced
window and its reading, and the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
the mix names its driver (``drivers/<driver>.py``), which runs the cell;
its limits are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``. Nothing here knows a cell by name."""

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vq_voice_swap_tpu")
SAMPLE_RATE = 16000


# ------------------------------------------------------------------ files


def read_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    driver: Any
    bench_dir: str = HERE


def reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell's entry, configuration, mix, limits, driver and metrics."""
    manifest = read_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no cell {cell_name!r} in BENCHMARK.json: {sorted(cells)}")
    spec = cells[cell_name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(root, configs[spec["config"]]["file"])
    traffic = read_json(bench_dir, "traffic", spec["traffic"] + ".json")
    limits = read_json(bench_dir, "limits", cell_name + ".json")
    driver = load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                         "bench_driver_" + traffic["driver"])
    return Cell(cell_name, spec, config, traffic, limits,
                [m for m in manifest["end_to_end"] if reports(m, cell_name)],
                [m for m in manifest["per_layer"] if reports(m, cell_name)], driver, bench_dir)


# ------------------------------------------------------------------ seeds


def mix_seed(seed: int, *parts: Any) -> int:
    """A 63-bit seed from the run's seed and a stream's name and index."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *parts: Any) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix_seed(seed, *parts))


def seeded_state(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights for every parameter of ``model``, drawn on the
    device in one call: each weight of two or more axes N(0, 1/fan_in) (the
    residual blocks' output convolutions at 0.3 of that), the codebook
    N(0, 1), GroupNorm scales near 1, every other vector small. The draw
    follows the parameters' names in sorted order, so two modules that
    name their parameters alike get the same weights."""
    params = sorted(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    noise = torch.randn(total, generator=generator(device, seed, "weights"), device=device)
    state, at = {}, 0
    for name, p in params:
        x = noise[at:at + p.numel()].view(p.shape)
        at += p.numel()
        if name.endswith("dictionary"):
            v = x
        elif p.ndim >= 2:
            v = x * ((0.3 if ".conv_out." in name else 1.0) / math.sqrt(p[0].numel()))
        elif "norm" in name and name.endswith("weight"):
            v = 1.0 + 0.1 * x
        else:
            v = 0.1 * x
        state[name] = v.clone()
    return state


def load_weights(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load ``state`` (every parameter of ``module``; buffers keep their
    initial values) into ``module``, refusing a name that does not match."""
    res = module.load_state_dict(state, strict=False)
    buffers = {n for n, _ in module.named_buffers()}
    if res.unexpected_keys or set(res.missing_keys) - buffers:
        raise ValueError(f"weights do not match the module: {res}")


@contextmanager
def full_float32():
    """float32 matmuls and convolutions without TF32, then as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def speech_batch(n: int, t: int, device, seed: int, *parts: Any) -> torch.Tensor:
    """n speech-like 16 kHz clips [n, t, 1] drawn on the device: a gliding
    harmonic voice (f0 90-220 Hz, 7 partials) under a syllable-rate
    envelope, plus noise."""
    g = generator(device, seed, "clips", *parts)
    u = torch.rand((n, 4), generator=g, device=device)
    time_s = torch.arange(t, device=device, dtype=torch.float32) / SAMPLE_RATE
    f0 = (90 + 130 * u[:, :1]) * (1 + 0.3 * torch.sin(2 * math.pi * (0.4 + u[:, 1:2]) * time_s
                                                         + 6.283 * u[:, 2:3]))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / SAMPLE_RATE
    tone = sum(torch.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 + 0.5 * torch.sin(2 * math.pi * 4 * time_s + 6.283 * u[:, 3:4]) ** 2
    noise = torch.randn((n, t), generator=g, device=device)
    return (0.15 * env * tone + 0.02 * noise)[:, :, None].contiguous()


# ------------------------------------------------------------------ trace


PROFILE_PAD = 4096  # small launches that take the profiler's lost first records
LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")
MARK = "bench_window"


def kernel_class(name: str) -> str:
    """A device record's class, by its kernel's name."""
    if "group_norm_stats_int8_kernel" in name:
        return "group_norm_stats_int8"
    if "group_norm_stats_kernel" in name:
        return "group_norm_stats"
    if "group_norm_bwd_" in name:
        return "group_norm_bwd"
    if name.startswith("apply_kernel"):
        return "group_norm_apply"
    if "vq_assign_kernel" in name:
        return "vq_assign"
    if "conv1d_int8_kernel" in name:
        return "conv1d_int8"
    if name.startswith(("amax_kernel", "codes_kernel")):
        return "quantize"
    if "resblock_" in name:
        return "fused_resblock"
    if "nccl" in name.lower():
        return "nccl"
    lowered = name.lower()
    if any(k in lowered for k in ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "sm90")):
        return "conv_matmul"
    return "other"


@dataclass
class Trace:
    """The device records of a traced stretch of the window: (name, start
    in s from the stretch's start, seconds), the host ops, and the
    stretch's wall seconds."""

    records: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    units: int = 0

    def busy_s(self) -> float:
        spans = sorted((s, s + d) for _, s, d in self.records)
        busy, end = 0.0, -1.0
        for s, e in spans:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def seconds_by_class(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, d in self.records:
            k = kernel_class(name)
            out[k] = out.get(k, 0.0) + d
        return out

    def launches_by_class(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, _, _ in self.records:
            k = kernel_class(name)
            out[k] = out.get(k, 0) + 1
        return out

    def breakdown(self) -> Dict[str, List]:
        by_name: Dict[str, float] = {}
        for name, _, d in self.records:
            by_name[name[:96]] = by_name.get(name[:96], 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = sorted((s, s + d) for _, s, d in self.records)
        gaps, end = [], 0.0
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window_s > end:
            gaps.append((end, self.window_s))
        named = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            mid = (g0 + g1) / 2
            inside = [(d, n) for n, s, d in self.host_ops if s <= mid <= s + d]
            named.append([min(inside)[1][:96] if inside else "host idle", g1 - g0])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def traced(fn: Callable[[], int]) -> Trace:
    """Run fn() under torch.profiler after PROFILE_PAD small launches; fn
    returns how many units of work it did. The records are fn's launches',
    found by correlation id; a launch without a device record fails."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            pad.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(MARK):
            units = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != cuda]
    origin = min(e.start_ns() for e in host if e.name() == MARK)
    launches = sorted((e for e in host if any(k in e.name() for k in LAUNCH_CALLS)),
                      key=lambda e: e.start_ns())
    ids = [e.correlation_id() for e in launches if e.start_ns() >= origin]
    recorded: Dict[int, list] = {}
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            recorded.setdefault(e.correlation_id(), []).append(e)
    missing = [c for c in ids if c not in recorded]
    if missing:
        raise RuntimeError(f"{len(missing)} of {len(ids)} launches have no device record")
    records = [(e.name(), (e.start_ns() - origin) / 1e9, e.duration_ns() / 1e9)
               for c in ids for e in recorded[c]]
    host_ops = [(e.name(), (e.start_ns() - origin) / 1e9, e.duration_ns() / 1e9)
                for e in host if e.start_ns() >= origin and e.name() != MARK
                and not any(k in e.name() for k in LAUNCH_CALLS)]
    return Trace(records, host_ops, wall, units)


# ------------------------------------------------------------------ run


@dataclass
class Window:
    """What the per-layer readers read: the driver's facts about the
    window (``info``: sizes, work, wall time, peaks, spans) and its trace."""

    info: Dict[str, Any]
    trace: Optional[Trace] = None


@dataclass
class Outcome:
    """A driver's answer: its end-to-end readings (the harness adds
    setup_s), the requests attempted and failed, the checks (name, value:
    compared where the cell's limits name them, else only reported), the
    device's peak memory and, traced, the window."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float]] = field(default_factory=list)
    memory_peak_bytes: int = 0
    window: Optional[Window] = None


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    setup_s: Optional[float] = None

    def stamp(self, what: str) -> None:
        """Say on standard error how far set-up has come."""
        print(f"setup: {what} done at {time.perf_counter() - self.t0:.3f} s", file=sys.stderr)

    def setup_done(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t0


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, count: int, peak: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float
             ) -> Dict[str, Any]:
    """Run the cell once and build its result line."""
    ctx = Context(cell, seed, seconds, trace, torch.device(device), t0)
    out: Outcome = cell.driver.run(ctx)
    checks, reported = [], {}
    correct = out.failed == 0 and out.attempted > 0
    for name, value in out.checks:
        if name not in cell.limits:
            reported[name] = value
            continue
        limit = cell.limits[name]
        correct = correct and value <= limit  # NaN is never within its limit
        checks.append((name, value, limit))
    correct = correct and len(checks) == len(cell.limits)  # every limit has its number
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        values = dict(out.end_to_end, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = load_module(os.path.join(cell.bench_dir, "metrics", m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    count = int(cell.spec.get("chips", 1))
    line = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device_info(ctx.device, count, out.memory_peak_bytes)}
    if trace and out.window is not None and out.window.trace is not None:
        tr = out.window.trace
        line["device"]["busy_s"] = tr.busy_s()
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    if reported:
        line["reported"] = reported
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line
