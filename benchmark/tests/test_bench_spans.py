"""``span_idle.py`` and the six span readers (``metrics/*_idle_pct.*``,
``metrics/loader_wait_ms.train.py``) on synthetic traces with known
records and spans, each reader's span-count guard, and the program's own
spans, recorded on the CPU through the drivers' calls, read as the traced
stretch on the card reads them."""

import os
import shutil
import tempfile
import time

import pytest
import torch

from conftest import BENCH, tiny_cell

import harness
import span_idle

SWAP = ("predict_idle_pct.swap", "step_idle_pct.swap", "encode_idle_pct.swap")
TRAIN = ("loader_wait_ms.train", "stage_idle_pct.train", "flush_idle_pct.train")


def reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "bench_metric_" + name.replace(".", "_"))


def read_all(names, window):
    return {n: reader(n).read(window) for n in names}


def spans(name, *intervals):
    return [(name, s, e - s) for s, e in intervals]


# The device runs [0, 1], [2, 4.5] (two overlapping records) and [6, 7]
# and [9.5, 10] of a 10 s stretch: idle [1, 2], [4.5, 6], [7, 9.5], 50%.
SWAP_RECORDS = [("k", 0.0, 1.0), ("k", 2.0, 2.0), ("k", 3.5, 1.0), ("k", 6.0, 1.0),
                ("k", 9.5, 0.5)]
# One batch of two steps: an encode, then two steps each around a call.
SWAP_SPANS = (spans("vvs.encode", (0.5, 1.5)) + spans("vvs.step", (1.8, 5.0), (5.0, 9.0))
              + spans("vvs.predict", (2.0, 4.8), (5.5, 8.0)) + [("aten::add", 2.5, 0.1)])


def swap_window(host_ops=SWAP_SPANS, units=2):
    return harness.Window({"steps": 2}, harness.Trace(SWAP_RECORDS, host_ops, 10.0, units))


def test_span_idle_exact():
    tr = swap_window().trace
    assert span_idle.idle(tr) == [(1.0, 2.0), (4.5, 6.0), (7.0, 9.5)]
    assert span_idle.covered(tr, "vvs.step") == [(1.8, 9.0)]
    assert span_idle.minus([(1.8, 9.0)], [(2.0, 4.8), (5.5, 8.0)]) == \
        pytest.approx([(1.8, 2.0), (4.8, 5.5), (8.0, 9.0)])
    assert span_idle.intersect_s(span_idle.idle(tr), [(1.8, 9.0)]) == pytest.approx(3.7)


def test_overlapping_spans_of_one_name_count_once():
    ops = spans("vvs.x", (0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0))
    tr = harness.Trace([("k", 0.0, 0.5)], ops, 10.0, 1)
    assert span_idle.count(tr, "vvs.x") == 4
    assert span_idle.covered(tr, "vvs.x") == [(0.0, 3.0), (5.0, 6.0), (9.0, 10.0)]
    assert span_idle.idle_pct(tr, "vvs.x") == pytest.approx(100 * (2.5 + 1.0 + 1.0) / 10)


def test_swap_readers_exact_and_adding_up_to_the_idle_share():
    win = swap_window()
    got = read_all(SWAP, win)
    # predict: [4.5, 4.8] + [5.5, 6] + [7, 8]; step outside predict:
    # [1.8, 2] + [4.8, 5.5] + [8, 9]; encode: [1, 1.5].
    assert got == pytest.approx({"predict_idle_pct.swap": 18.0, "step_idle_pct.swap": 19.0,
                                 "encode_idle_pct.swap": 5.0})
    idle = reader("idle_pct.swap").read(win)
    assert idle == pytest.approx(50.0)
    outside = 100 * (0.3 + 0.5) / 10  # [1.5, 1.8] and [9, 9.5]: in no span
    assert sum(got.values()) + outside == pytest.approx(idle)


# Three windows of two steps in a 10 s stretch; the device runs [0, 1],
# [3, 5] and [8, 9]: idle [1, 3], [5, 8], [9, 10], 60%. Each window takes
# two batches, stages them and (after the first) flushes the window before.
TRAIN_RECORDS = [("k", 0.0, 1.0), ("k", 3.0, 2.0), ("k", 8.0, 1.0)]
TRAIN_SPANS = (spans("vvs.data.wait", (0.0, 0.1), (0.1, 0.2), (1.5, 1.6), (1.6, 1.7),
                     (5.2, 5.3), (5.3, 5.4))
               + spans("vvs.train.stage", (0.2, 1.5), (1.7, 2.0), (5.4, 6.0))
               + spans("vvs.train.flush", (2.0, 3.5), (6.0, 8.5)))


def train_window(host_ops=TRAIN_SPANS, units=6):
    return harness.Window({"steps": 99}, harness.Trace(TRAIN_RECORDS, host_ops, 10.0, units))


def test_train_readers_exact():
    win = train_window()
    got = read_all(TRAIN, win)
    # 0.6 s of waits over 6 steps; stage idle of the steady windows
    # [1.7, 2] + [5.4, 6]; flush idle [2, 3] + [6, 8].
    assert got == pytest.approx({"loader_wait_ms.train": 100.0, "stage_idle_pct.train": 9.0,
                                 "flush_idle_pct.train": 30.0})
    idle = reader("idle_pct.train").read(win)
    first = 100 * 0.5 / 10  # the first stage's idle, [1, 1.5]: left out
    waits = 100 * 0.4 / 10  # the waits' idle: [1.5, 1.7] and [5.2, 5.4]
    outside = 100 * 1.2 / 10  # [5, 5.2] and [9, 10]
    assert got["stage_idle_pct.train"] + got["flush_idle_pct.train"] + first + waits + \
        outside == pytest.approx(idle)


def test_the_stretchs_first_stage_is_left_out_by_start():
    """The first stage of the stretch runs on the card the harness emptied;
    the reader leaves out the earliest, wherever the trace lists it."""
    stages = [op for op in TRAIN_SPANS if op[0] == "vvs.train.stage"]
    others = [op for op in TRAIN_SPANS if op[0] != "vvs.train.stage"]
    got = reader("stage_idle_pct.train").read(train_window(others + stages[::-1]))
    assert got == pytest.approx(9.0)
    assert span_idle.covered(train_window().trace, "vvs.train.stage", skip=1) == \
        [(1.7, 2.0), (5.4, 6.0)]


def test_an_epoch_end_adds_one_wait():
    extra = spans("vvs.data.wait", (9.0, 9.5))
    assert reader("loader_wait_ms.train").read(train_window(TRAIN_SPANS + extra)) == \
        pytest.approx(1e3 * 1.1 / 6)
    twice = extra + spans("vvs.data.wait", (9.6, 9.7))
    assert reader("loader_wait_ms.train").read(train_window(TRAIN_SPANS + twice)) is None


def drop(ops, name, k=1):
    """``ops`` with the last k spans named ``name`` left out."""
    keep = [op for op in ops if op[0] != name]
    return keep + [op for op in ops if op[0] == name][:-k]


@pytest.mark.parametrize("metric, ops", [
    ("predict_idle_pct.swap", drop(SWAP_SPANS, "vvs.predict")),
    ("step_idle_pct.swap", drop(SWAP_SPANS, "vvs.step")),
    ("step_idle_pct.swap", drop(SWAP_SPANS, "vvs.predict")),
    ("encode_idle_pct.swap", drop(SWAP_SPANS, "vvs.encode")),
    ("encode_idle_pct.swap", SWAP_SPANS + spans("vvs.encode", (9.1, 9.2))),
])
def test_swap_readers_refuse_a_wrong_span_count(metric, ops):
    assert reader(metric).read(swap_window(ops)) is None


@pytest.mark.parametrize("metric, ops", [
    ("loader_wait_ms.train", drop(TRAIN_SPANS, "vvs.data.wait")),
    ("stage_idle_pct.train", drop(TRAIN_SPANS, "vvs.train.stage", 2) +
     spans("vvs.train.stage", (7.0, 7.1), (7.2, 7.3), (7.4, 7.5))),  # 4 does not divide 6
    ("flush_idle_pct.train", drop(TRAIN_SPANS, "vvs.train.flush")),
    ("flush_idle_pct.train", TRAIN_SPANS + spans("vvs.train.flush", (9.0, 9.2))),
    # One window of six steps: no steady window to read.
    ("stage_idle_pct.train", drop(TRAIN_SPANS, "vvs.train.stage", 2)),
    ("flush_idle_pct.train", drop(drop(TRAIN_SPANS, "vvs.train.stage", 2),
                                  "vvs.train.flush", 2)),
])
def test_train_readers_refuse_a_wrong_span_count(metric, ops):
    assert reader(metric).read(train_window(ops)) is None


@pytest.mark.parametrize("names, window", [(SWAP, swap_window), (TRAIN, train_window)])
def test_no_spans_or_no_trace_reads_nothing(names, window):
    """A program without the spans (the parent of this change), a stretch
    without units, or a run without a trace."""
    bare = window([("aten::add", 0.0, 1.0)])
    empty = window(units=0)
    for win in (bare, empty, harness.Window({"steps": 2})):
        assert set(read_all(names, win).values()) == {None}


# ---------------------------------------------------------------- program


def cpu_traced(fn):
    """``harness.traced`` on the CPU: the host events of fn's stretch, no
    device records (the stretch is idle throughout)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        with record_function(harness.MARK):
            units = fn()
        wall = time.perf_counter() - t0
    host = list(prof.profiler.kineto_results.events())
    origin = min(e.start_ns() for e in host if e.name() == harness.MARK)
    ops = [(e.name(), (e.start_ns() - origin) / 1e9, e.duration_ns() / 1e9)
           for e in host if e.start_ns() >= origin and e.name() != harness.MARK]
    return harness.Trace([], ops, wall, units)


def test_the_program_spans_of_three_swap_batches():
    cell = tiny_cell("swap.int8.b64")
    ctx = harness.Context(cell, 2**31 + 5, 0.5, True, torch.device("cpu"), time.perf_counter())
    _, model, recorder = cell.driver.setup(ctx, lambda _: None)
    info = cell.driver.layer_info(ctx)

    def stretch():
        bad = torch.zeros((), dtype=torch.long)
        for i in range(3):
            cell.driver.one_batch(ctx, model, recorder, i, bad, {})
        return 3 * info["steps"]

    win = harness.Window(info, cpu_traced(stretch))
    got = read_all(SWAP, win)
    assert None not in got.values(), got
    # No device records: the whole stretch is idle, and the spans split it.
    assert 0 < sum(got.values()) <= 100.0 + 1e-9


def test_the_program_spans_of_three_train_windows():
    cell = tiny_cell("train.bf16.k4")
    # 3 speakers x 10 windows of a 6 s file: 7 batches of 4 an epoch, so
    # the stretch's steps 3 .. 8 cross one epoch's end.
    cell.traffic["utterance_seconds"] = 6.0
    ctx = harness.Context(cell, 2**31 + 9, 0.1, True, torch.device("cpu"), time.perf_counter())
    k = cell.traffic["steps_per_dispatch"]
    root = tempfile.mkdtemp(prefix="bench_spans_")
    try:
        _, loop, _ = cell.driver.build(ctx, root)
        feed = cell.driver.Feed(loop)
        feed.run(1, 0)
        feed.run(k, 1)
        loop._flush_pending()  # as the driver flushes before its stretch

        def stretch():
            for w in range(3):
                feed.run(k, 1 + k * (w + 1))
            return 3 * k

        win = harness.Window({"steps": 1 + 4 * k}, cpu_traced(stretch))
        loop._flush_pending()
        feed.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tr = win.trace
    assert [span_idle.count(tr, n) for n in ("vvs.data.wait", "vvs.train.stage",
                                             "vvs.train.flush")] == [3 * k + 1, 3, 2]
    got = read_all(TRAIN, win)
    assert None not in got.values(), got
    assert got["stage_idle_pct.train"] + got["flush_idle_pct.train"] <= 100.0 + 1e-9
