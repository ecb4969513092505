"""The port's profiler spans (``observe/spans.py``) on the CPU: a swap's
``vvs.encode``, ``vvs.step`` and ``vvs.predict``, a windowed train loop's
``vvs.data.wait``, ``vvs.train.stage`` and ``vvs.train.flush``, each
counted and nested as the benchmark's readers expect, the spans in a
``--profile-dir`` trace, and no profiler range at all while no profiler
runs."""

import glob
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vq_voice_swap_torch import train_vqvae
from vq_voice_swap_torch.observe import spans
from vq_voice_swap_torch.train import VQVAETrainLoop
from vq_voice_swap_torch.vq_vae import VQVAE

TRAIN_ARGS = ["--device", "cpu", "--base-channels", "2", "--batch-size", "2",
              "--class-cond", "--ema-rate", "0.99", "tones"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def span_intervals(prof):
    """{name: [(start_ns, end_ns), ...]} of the trace's ``vvs.`` spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vvs."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= e for s, e in outers)


def tiny_vqvae():
    torch.manual_seed(0)
    return VQVAE(pred_name="unet", base_channels=8, enc_name="conv-mfcc-ulaw",
                 dictionary_size=16, num_labels=3).eval()


def test_a_swap_records_one_encode_and_a_step_and_predict_a_call():
    model = tiny_vqvae()
    clips = torch.randn(2, 4 * model.downsample_rate, 1) * 0.1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        codes = model.encode(clips)
        model.decode(codes, labels=torch.tensor([0, 2]), steps=2, sampler="dpmpp",
                     constrain=True)
    got = span_intervals(prof)
    assert {k: len(v) for k, v in got.items()} == {"vvs.encode": 1, "vvs.step": 2,
                                                  "vvs.predict": 2}
    assert all(inside(p, got["vvs.step"]) for p in got["vvs.predict"])
    assert not any(inside(s, got["vvs.encode"]) for s in got["vvs.step"])


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_the_other_samplers_record_a_step_around_each_call(sampler):
    model = tiny_vqvae()
    codes = torch.zeros(1, 4, dtype=torch.long)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.decode(codes, labels=torch.tensor([1]), steps=3, sampler=sampler,
                     generator=torch.Generator().manual_seed(1))
    got = span_intervals(prof)
    assert {k: len(v) for k, v in got.items()} == {"vvs.step": 3, "vvs.predict": 3}
    assert all(inside(p, got["vvs.step"]) for p in got["vvs.predict"])


def test_a_windowed_train_loop_records_its_waits_stages_and_flushes(tmp_path):
    """--steps-per-dispatch 2, four steps: a wait a step, a stage a window,
    and, at --pipeline-depth 1, a flush for each window after the first
    (the last window's metrics are fetched after the profiled stretch)."""
    loop = VQVAETrainLoop(VQVAETrainLoop.arg_parser().parse_args(
        TRAIN_ARGS + ["--steps-per-dispatch", "2", "--output-dir", str(tmp_path)]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop._loop_windows(4, 2)
    loop._flush_pending()
    got = span_intervals(prof)
    counts = {k: len(v) for k, v in got.items() if k.startswith("vvs.data.")
              or k.startswith("vvs.train.")}
    assert counts == {"vvs.data.wait": 4, "vvs.train.stage": 2, "vvs.train.flush": 1}
    # The flush of window 1 follows window 2's stage, on the one host thread.
    assert got["vvs.train.flush"][0][0] > max(s for s, _ in got["vvs.train.stage"])


def test_profile_dir_trace_holds_the_spans(tmp_path):
    out, trace = tmp_path / "run", tmp_path / "trace"
    train_vqvae.main(TRAIN_ARGS + ["--max-steps", "1", "--output-dir", str(out),
                                   "--profile-dir", str(trace)])
    files = glob.glob(str(trace / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    # The one-step loop takes a second batch before it sees --max-steps.
    assert [names.count(n) for n in ("vvs.data.wait", "vvs.train.stage",
                                     "vvs.train.flush")] == [2, 1, 1]


def test_no_profiler_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert spans.span("vvs.step") is spans.span("vvs.encode")
    model = tiny_vqvae()
    with torch.no_grad():
        codes = model.encode(torch.randn(1, 4 * model.downsample_rate, 1) * 0.1)
        model.decode(codes, labels=torch.tensor([1]), steps=2, sampler="dpmpp")
