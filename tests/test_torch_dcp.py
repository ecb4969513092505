"""The port's sharded run-directory format, ``--checkpoint-format dcp``
(vq_voice_swap_torch/train/dcp.py), against what the JAX package's Orbax
format guarantees (vq_voice_swap_tpu/checkpoint.py ``_commit_staged`` and
``staged_fallback``, train/loops.py ``_ckpt_exists``;
tests/test_checkpoint.py's staged-fallback test):

- a crash in a save's commit window leaves ``<dir>`` missing and a complete
  ``<dir>.new``; a run whose ``model.dcp`` / ``opt.dcp`` / EMA directories
  were left so resumes with the same weights, EMA, optimizer step and log
  position (here in a one-rank gloo world, so the collective save and load
  run);
- ``ModelBase.load``, and so every CLI, reads ``model.dcp`` and a named
  EMA (``model_ema_<rate>.dcp``) on one process without a group, and
  ``sample_diffusion --device cpu`` samples from them;
- the EMAs that runs saved inside ``model.dcp`` before they had
  directories of their own still resume;
- ``--async-save`` with dcp warns that the save runs synchronously.

The runs train the shallow VQ-VAE of tests/torch_parallel_worker.py on
256-sample tones for two steps (about a second each); the diffusion run
the base-2 UNet. Comparisons are exact: the same bits are read back.
"""

import os
import shutil

import pytest
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp_io
import torch_parallel_worker as tpw

from vq_voice_swap_torch import sample_diffusion, train_diffusion
from vq_voice_swap_torch.diffusion_model import DiffusionModel
from vq_voice_swap_torch.model_base import ModelBase
from vq_voice_swap_torch.train import VQVAETrainLoop, loops
from vq_voice_swap_torch.vq_vae import VQVAE

RATE = 0.9


@pytest.fixture(autouse=True)
def _short_tones(monkeypatch):
    """One intra-op thread; every loop on 256-sample tones."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(loops, "create_data_loader", tpw._short_data)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch):
    """The VQ-VAE loop on the shallow model, new or resumed (the shallow
    UNet is not in the saved kwargs, so ``from_manifest`` builds it too)."""
    monkeypatch.setattr(loops.VQVAETrainLoop, "create_new_model", lambda self: tpw.tiny_vqvae())
    monkeypatch.setattr(ModelBase, "from_manifest",
                        classmethod(lambda cls, name, kwargs: tpw.tiny_vqvae()))


@pytest.fixture
def one_rank_world(monkeypatch):
    """The launcher's environment of a one-rank world: the loop starts a
    gloo group, and its saves and loads are collective."""
    for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(tpw.free_port()))):
        monkeypatch.setenv(k, v)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _loop(out, *flags):
    """A VQ-VAE loop on ``out`` (resumed where it holds a run)."""
    args = VQVAETrainLoop.arg_parser().parse_args(
        ["--device", "cpu", "--output-dir", str(out), "--class-cond", "--ema-rate", str(RATE),
         "--checkpoint-format", "dcp", "--batch-size", "2", *flags, "tones"])
    return VQVAETrainLoop(args)


def _train(out, *flags):
    _loop(out, "--max-steps", "2", "--save-interval", "2", *flags).loop()


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _saved(out):
    """The run's saved model, EMA and optimizer count, read back."""
    model = ModelBase.load(str(out / "model.dcp"), device="cpu")
    ema = ModelBase.load(str(out / f"model_ema_{RATE}.dcp"), device="cpu")
    return _state(model), _state(ema)


@pytest.mark.parametrize("staged", [("model.dcp",), ("opt.dcp",),
                                    ("model.dcp", f"model_ema_{RATE}.dcp", "opt.dcp")],
                         ids=["model", "opt", "all"])
def test_staged_dirs_resume_with_the_same_state(tmp_path, tiny, one_rank_world, staged):
    """Directories left as complete ``.new`` (a crash between a commit's
    renames) are read: the resumed loop holds the saved weights, EMA and
    optimizer state and continues the log after step 2."""
    out = tmp_path / "run"
    _train(out)
    model, ema = _saved(out)
    opt = _loop(out).optimizer.state_dict()
    for name in staged:
        os.rename(out / name, out / (name + ".new"))
    resumed = _loop(out, "--max-steps", "1", "--save-interval", "1")
    assert resumed.resume and resumed.total_steps == 2 and resumed.optimizer.count == 2
    _same(_state(resumed.model), model)
    _same({n: p.detach() for n, p in resumed.emas[0].model.named_parameters()},
          {n: ema[n] for n, _ in resumed.emas[0].model.named_parameters()})
    got = resumed.optimizer.state_dict()["adamw"]["state"]
    want = opt["adamw"]["state"]
    assert got.keys() == want.keys() and len(want) > 0
    for i in want:
        _same(got[i], want[i])
    resumed.loop()  # one more step, whose save commits over the staged directories
    assert not any(os.path.exists(out / (n + s)) for n in staged for s in (".new", ".old"))


def test_a_resave_commits_through_old_and_leaves_no_staging(tmp_path, tiny):
    """A second save swaps the directories in (``<dir>.old`` transient):
    after it only the committed directories remain, holding the new step's
    state."""
    out = tmp_path / "run"
    _train(out)
    first, _ = _saved(out)
    _loop(out, "--max-steps", "1", "--save-interval", "1").loop()
    names = sorted(os.listdir(out))
    assert [n for n in names if n.endswith((".new", ".old"))] == []
    assert {"model.dcp", f"model_ema_{RATE}.dcp", "opt.dcp"} <= set(names)
    again, _ = _saved(out)
    assert any(not torch.equal(again[k], first[k]) for k in first)
    assert _loop(out).optimizer.count == 3


def test_model_base_loads_the_dcp_model_and_a_named_ema(tmp_path, tiny):
    """``ModelBase.load`` reads ``model.dcp`` and ``model_ema_<rate>.dcp``
    (the loop's weights and EMA, bit for bit), also from ``.new``."""
    out = tmp_path / "run"
    _train(out)
    loop = _loop(out)
    model, ema = _saved(out)
    _same(model, _state(loop.model))
    for n, p in loop.emas[0].model.named_parameters():
        assert torch.equal(ema[n], p.detach()), n
    for n, b in loop.model.named_buffers():
        assert torch.equal(ema[n], b), n
    assert isinstance(ModelBase.load(str(out / "model.dcp"), device="cpu"), VQVAE)
    shutil.move(out / "model.dcp", out / "model.dcp.new")
    _same(_state(ModelBase.load(str(out / "model.dcp"), device="cpu")), model)


def test_legacy_emas_inside_model_dcp_still_resume(tmp_path, tiny):
    """A run saved with the EMAs inside ``model.dcp`` (``ema_<rate>.*``,
    the layout before they had directories of their own) resumes with
    them."""
    out = tmp_path / "run"
    _train(out)
    _, ema = _saved(out)
    loop = _loop(out)
    legacy = {f"model.{k}": v for k, v in loop.model.state_dict().items()}
    legacy.update((f"ema_{RATE}.{n}", p.detach())
                  for n, p in loop.emas[0].model.named_parameters())
    manifest = (out / "model.dcp" / "model.json").read_text()
    shutil.rmtree(out / "model.dcp")
    shutil.rmtree(out / f"model_ema_{RATE}.dcp")
    dcp_io.save(legacy, checkpoint_id=str(out / "model.dcp"))
    (out / "model.dcp" / "model.json").write_text(manifest)
    resumed = _loop(out)
    for n, p in resumed.emas[0].model.named_parameters():
        assert torch.equal(p.detach(), ema[n]), n


def test_async_save_with_dcp_warns(tmp_path, tiny, capsys):
    _loop(tmp_path / "run", "--async-save", "--max-steps", "0")
    err = capsys.readouterr().err
    assert "warning: --async-save is ignored with --checkpoint-format dcp" in err


@pytest.mark.parametrize("which", ["model", "ema"])
def test_sample_diffusion_reads_a_dcp_run(tmp_path, which):
    """``sample_diffusion --device cpu`` samples from a dcp diffusion run's
    ``model.dcp`` and from its named EMA, as from the npz of the same
    weights (the base-2 UNet, whose kwargs the manifest holds)."""
    run = tmp_path / "run"
    train_diffusion.main(["--device", "cpu", "--base-channels", "2", "--batch-size", "1",
                          "--max-steps", "1", "--save-interval", "1", "--ema-rate", str(RATE),
                          "--checkpoint-format", "dcp", "--output-dir", str(run), "tones"])
    path = run / ("model.dcp" if which == "model" else f"model_ema_{RATE}.dcp")
    model = ModelBase.load(str(path), device="cpu")
    assert isinstance(model, DiffusionModel)
    npz = tmp_path / "same.npz"
    model.save(str(npz))
    outs = []
    for i, ckpt in enumerate((path, npz)):
        out = tmp_path / f"samples_{i}"
        sample_diffusion.main(["--device", "cpu", "--checkpoint-path", str(ckpt),
                               "--sample-steps", "2", "--num-samples", "1",
                               "--sample-path", str(out)])
        files = sorted(os.listdir(out))
        assert len(files) == 1 and files[0].endswith(".wav")
        outs.append((out / files[0]).read_bytes())
    assert outs[0] == outs[1]


def test_model_base_refuses_a_directory_that_is_not_dcp(tmp_path):
    """A directory without the dcp manifest (an Orbax run's, say) is
    refused with a message, not read as an npz."""
    (tmp_path / "model.orbax").mkdir()
    with pytest.raises(ValueError, match="not a --checkpoint-format dcp model directory"):
        ModelBase.load(str(tmp_path / "model.orbax"), device="cpu")
