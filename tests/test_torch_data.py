"""The port's data layer against the JAX package's, on the CPU: the file
index, the windows and labels of a LibriSpeech-style directory (a 22050 Hz
file and a file shorter than a window among them), the window cache (each
package reads the other's, bit for bit; the torn-write repair; the mmap
refresh after another builder appended), the C window gather (against its
numpy loop and the JAX package's gather, its bounds check included), the
loader's batches over two epochs with one and two shards, and the audio
I/O's WAV path and its ffmpeg pipe plumbing through a stand-in ``Popen``.

numpy only: no model, no JAX jit. The gather's C source is built with the
host compiler at first use; its tests skip where there is no ``cc``.
"""

import os
import shutil
import subprocess
import sys
import wave

import numpy as np
import pytest

import vq_voice_swap_torch.data.audio_io as aio
from vq_voice_swap_tpu.data import LibriSpeech as JaxLibriSpeech
from vq_voice_swap_tpu.data import build_file_index as jax_build_file_index
from vq_voice_swap_tpu.data import create_data_loader as jax_create_data_loader
from vq_voice_swap_tpu.data.audio_io import ChunkReader as JaxChunkReader
from vq_voice_swap_tpu.data.cache import WindowCache as JaxWindowCache
from vq_voice_swap_tpu.data.native import batch_gather_windows as jax_gather
from vq_voice_swap_torch.data import (
    ChunkReader,
    ChunkWriter,
    DataLoader,
    LibriSpeech,
    build_file_index,
    create_data_loader,
    lookup_audio_duration,
    read_audio_input,
)
from vq_voice_swap_torch.data.cache import WindowCache
from vq_voice_swap_torch.data.native import batch_gather_windows, batch_gather_windows_plain
from vq_voice_swap_torch.ops import cuda_build


def _write_wav(path, samples, rate=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * (2**15 - 1)).astype("<i2").tobytes())


def _noise(seed, seconds, rate=16000):
    return 0.2 * np.random.RandomState(seed).randn(int(rate * seconds))


def _tree(root):
    """Three speakers (sorted as strings: "103" < "19" < "7"), two chapters
    of 4.8 s files each, one 22050 Hz file of 4.6 s and one of 0.5 s."""
    for i, spk in enumerate(("19", "7", "103")):
        for ch in ("1", "2"):
            _write_wav(os.path.join(root, spk, ch, f"{spk}-{ch}.wav"), _noise(10 * i + int(ch), 4.8))
    _write_wav(os.path.join(root, "7", "3", "resampled.wav"), _noise(40, 4.6, 22050), 22050)
    _write_wav(os.path.join(root, "103", "3", "short.wav"), _noise(41, 0.5))
    os.makedirs(os.path.join(root, ".hidden"))
    return root


@pytest.fixture
def tree(tmp_path):
    return _tree(str(tmp_path / "ds"))


@pytest.fixture
def need_cc():
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler (cc) to build the window gather")


# ------------------------------------------------------------ the dataset


def test_file_index_windows_and_labels_match_jax(tree):
    assert build_file_index(tree) == jax_build_file_index(tree)
    ours = LibriSpeech(tree, use_cache=False)
    theirs = JaxLibriSpeech(tree, use_cache=False)  # reads the index.json ours wrote
    assert ours.speaker_ids == theirs.speaker_ids == ["103", "19", "7"]
    assert [(w.label, w.path, w.offset) for w in ours.windows] == [
        (w.label, w.path, w.offset) for w in theirs.windows]
    assert len(ours) == 28  # 6 files of 4.8 s: 4 each; 4.6 s: 3; the short one: 1
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["label"] == want["label"]
        np.testing.assert_array_equal(got["samples"], want["samples"])
    short = [i for i, w in enumerate(ours.windows) if w.path.endswith("short.wav")]
    assert len(short) == 1 and not ours[short[0]]["samples"][8000:].any()  # zero-padded


@pytest.mark.parametrize("encoding", ["linear", "ulaw"])
def test_cached_items_and_batches_match_jax_and_the_direct_read(tree, tmp_path, encoding,
                                                                need_cc):
    ours = LibriSpeech(tree, encoding=encoding, cache_dir=str(tmp_path / "ours"))
    theirs = JaxLibriSpeech(tree, encoding=encoding, cache_dir=str(tmp_path / "theirs"))
    direct = LibriSpeech(tree, encoding=encoding, use_cache=False)
    idxs = np.arange(len(ours))[::-1]
    batch = ours.get_batch(idxs)
    want = theirs.get_batch(idxs)
    assert batch["label"].dtype == want["label"].dtype == np.int32
    np.testing.assert_array_equal(batch["label"], want["label"])
    np.testing.assert_array_equal(batch["samples"], want["samples"])
    for row, i in enumerate(idxs):
        np.testing.assert_array_equal(ours[int(i)]["samples"], batch["samples"][row])
        np.testing.assert_array_equal(direct[int(i)]["samples"], batch["samples"][row])


@pytest.mark.parametrize("builder,reader", [(WindowCache, JaxWindowCache),
                                            (JaxWindowCache, WindowCache)])
def test_window_cache_reads_in_the_other_package(tree, tmp_path, builder, reader, need_cc):
    paths = sorted(os.path.join(r, f) for r, _, fs in os.walk(tree) for f in fs
                   if f.endswith(".wav"))
    cache_dir = str(tmp_path / "cache")
    built = builder(cache_dir, 16000)
    built.build(paths)
    read = reader(cache_dir, 16000)
    assert read.index == built.index
    read.build(paths)  # nothing to add
    assert os.path.getsize(read.arena_path) == 4 * sum(n for _, n in read.index.values())
    refs = [(p, off) for p in paths for off in (0, 3200, 70000)]
    np.testing.assert_array_equal(read.read_windows(refs, 64000),
                                  built.read_windows(refs, 64000))
    for p, off in refs[:6]:
        np.testing.assert_array_equal(read.read_window(p, off, 64000),
                                      built.read_window(p, off, 64000))


def test_window_cache_repairs_torn_write(tmp_path):
    """A builder killed mid-write leaves bytes no span covers, 7 here (not a
    multiple of 4): the next build truncates them and appends after the
    index's end."""
    sig_a, sig_b = _noise(3, 1.0), _noise(4, 1.0)
    path_a, path_b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _write_wav(path_a, sig_a)
    _write_wav(path_b, sig_b)
    cache_dir = str(tmp_path / "cache")
    cache = WindowCache(cache_dir, 16000)
    cache.build([path_a])
    with open(cache.arena_path, "ab") as f:
        f.write(b"\x01" * 7)

    fresh = WindowCache(cache_dir, 16000)
    fresh.build([path_a, path_b])
    np.testing.assert_allclose(fresh.read_window(path_a, 0, 8000), sig_a[:8000], atol=1e-3)
    np.testing.assert_allclose(fresh.read_window(path_b, 0, 8000), sig_b[:8000], atol=1e-3)
    assert os.path.getsize(fresh.arena_path) == 4 * 32000


def test_window_cache_refreshes_its_map_after_another_builder(tmp_path):
    """Another builder extended the arena while this one held a map of the
    shorter file: build() must reopen the map even when it has nothing
    left to add, or the new file reads as zeros."""
    sig_a, sig_b = _noise(5, 1.0), _noise(6, 1.0)
    path_a, path_b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _write_wav(path_a, sig_a)
    _write_wav(path_b, sig_b)
    cache_dir = str(tmp_path / "cache")
    ours = WindowCache(cache_dir, 16000)
    ours.build([path_a])
    ours.read_window(path_a, 0, 100)  # maps the one-file arena

    other = WindowCache(cache_dir, 16000)
    other.build([path_a, path_b])

    ours.build([path_a, path_b])
    np.testing.assert_allclose(ours.read_window(path_b, 0, 8000), sig_b[:8000], atol=1e-3)


def test_window_cache_refuses_another_sample_rate(tmp_path):
    path = str(tmp_path / "a.wav")
    _write_wav(path, _noise(7, 0.5))
    WindowCache(str(tmp_path / "cache"), 16000).build([path])
    with pytest.raises(ValueError, match="16000 Hz"):
        WindowCache(str(tmp_path / "cache"), 8000)


# ------------------------------------------------------------- the gather


def _arena_case():
    arena = np.random.RandomState(0).randn(1000).astype(np.float32)
    starts = np.asarray([0, 100, 950, 1000, 3], np.int64)
    avail = np.asarray([1000, 900, 50, 0, 5], np.int64)  # rows 2-4 need padding
    return arena, starts, avail


@pytest.mark.parametrize("window", [1, 128, 2000])
def test_gather_matches_numpy_and_jax(window, need_cc):
    arena, starts, avail = _arena_case()
    got = batch_gather_windows(arena, starts, avail, window)
    assert got.shape == (5, window) and got.dtype == np.float32
    np.testing.assert_array_equal(got, batch_gather_windows_plain(arena, starts, avail, window))
    np.testing.assert_array_equal(got, jax_gather(arena, starts, avail, window))


@pytest.mark.parametrize("start,n", [(-1, 4), (999, 2), (1001, 0), (0, -1), (2**62, 2**62)])
def test_gather_bounds_check(start, n, need_cc):
    arena, starts, avail = _arena_case()
    starts[1], avail[1] = start, n
    for gather in (batch_gather_windows, batch_gather_windows_plain):
        with pytest.raises(ValueError, match="out of arena bounds: row 1"):
            gather(arena, starts, avail, 128)


def test_gather_refuses_an_arena_it_cannot_point_at(need_cc):
    arena, starts, avail = _arena_case()
    with pytest.raises(ValueError, match="contiguous 1-d float32"):
        batch_gather_windows(arena.astype(np.float64), starts, avail, 8)
    with pytest.raises(ValueError, match="contiguous 1-d float32"):
        batch_gather_windows(arena[::2], starts // 2, avail // 2, 8)


def test_gather_build_failure_names_the_compiler(tmp_path, monkeypatch):
    """A failed build raises with the compiler's name; nothing falls back."""
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="false failed for audio_gather"):
        cuda_build.build("audio_gather")
    monkeypatch.setenv("CC", "no-such-compiler")
    with pytest.raises(RuntimeError, match="'no-such-compiler' was not found"):
        cuda_build.build("audio_gather")
    assert not os.listdir(tmp_path / "_build")


# -------------------------------------------------------------- the loader


@pytest.mark.parametrize("num_shards,shard_index", [(1, 0), (2, 0), (2, 1)])
def test_directory_loader_matches_jax(tree, num_shards, shard_index, need_cc):
    """Two epochs, the same batches in the same order; each shard its own
    cache directory."""
    loader, labels = create_data_loader(tree, 3, seed=4, shard_index=shard_index,
                                        num_shards=num_shards)
    jax_loader, jax_labels = jax_create_data_loader(tree, 3, seed=4, shard_index=shard_index,
                                                    num_shards=num_shards)
    assert labels == jax_labels == 3
    assert len(loader) == len(jax_loader) == 28 // num_shards // 3
    if num_shards > 1:
        assert loader.dataset.cache.cache_dir.endswith(f".window_cache_h{shard_index}")
    for _ in range(2):
        for got, want in zip(loader, jax_loader, strict=True):
            for k in ("label", "samples"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_shards_are_disjoint_and_equal(tree, need_cc):
    seen = []
    for shard in (0, 1):
        loader, _ = create_data_loader(tree, 1, seed=9, shard_index=shard, num_shards=2)
        seen.append([int(i) for idxs in loader._batch_indices() for i in idxs])
    assert len(seen[0]) == len(seen[1]) == 14
    assert not set(seen[0]) & set(seen[1])
    with pytest.raises(ValueError, match="shard 2 not in"):
        DataLoader(LibriSpeech(tree, use_cache=False), 2, shard_index=2, num_shards=2)


# ---------------------------------------------------------------- audio I/O


def test_chunk_reader_and_writer_wav_path(tmp_path, monkeypatch):
    monkeypatch.setattr(aio, "have_ffmpeg", lambda: False)
    sig = (0.25 * np.sin(np.arange(5000) * 0.01)).astype(np.float32)
    path = str(tmp_path / "x.wav")
    with ChunkWriter(path, 16000, encoding="ulaw") as writer:
        writer.write(aio.encode_u_law(sig[:3000]))
        writer.write(aio.encode_u_law(sig[3000:]))
    assert lookup_audio_duration(path) == 5000 / 16000
    with ChunkReader(path, 16000) as reader:
        chunks = [reader.read(2048) for _ in range(3)]
        assert reader.read(2048) is None
    assert [len(c) for c in chunks] == [2048, 2048, 904]
    np.testing.assert_allclose(np.concatenate(chunks), sig, atol=1e-4)
    # Resampled on read, as the JAX package resamples.
    got = ChunkReader(path, 8000, encoding="ulaw").read(1 << 40)
    want = JaxChunkReader(path, 8000, encoding="ulaw").read(1 << 40)
    assert len(got) == 2500
    np.testing.assert_array_equal(got, want)


def test_read_audio_input_without_ffmpeg(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(aio, "have_ffmpeg", lambda: False)
    with pytest.raises(RuntimeError, match="ffmpeg is not installed and only .wav"):
        read_audio_input(str(tmp_path / "speech.flac"), 16000, 4)
    with pytest.raises(RuntimeError, match="ffmpeg is not installed and only .wav"):
        ChunkWriter(str(tmp_path / "out.flac"), 16000)
    with pytest.raises(RuntimeError, match="not a wav file"):
        lookup_audio_duration(str(tmp_path / "speech.mp3"))
    path = str(tmp_path / "in.wav")
    _write_wav(path, _noise(8, 1.5))
    clip = read_audio_input(path, 16000, 2)
    assert clip.shape == (24000,) and clip.dtype == np.float32
    assert "shorter than the requested 2s" in capsys.readouterr().out


def _fake_ffmpeg_popen(script_for_fd):
    """Popen that runs ``python -c script`` with ffmpeg's pipe:<fd> passed
    on, so the pipe plumbing runs without ffmpeg."""
    real_popen = subprocess.Popen

    def popen(cmd, *args, pass_fds=(), **kw):
        fds = [int(a.split(":")[1]) for a in cmd if str(a).startswith("pipe:")]
        if not fds:
            return real_popen(cmd, *args, pass_fds=pass_fds, **kw)
        return real_popen([sys.executable, "-c", script_for_fd(fds[0])], pass_fds=pass_fds)

    return popen


def _raw(tmp_path, samples):
    raw = str(tmp_path / "raw.s16le")
    with open(raw, "wb") as f:
        f.write((np.asarray(samples) * 32767).astype("<i2").tobytes())
    return raw


def test_chunk_reader_ffmpeg_pipe_clean_stream(tmp_path, monkeypatch):
    sig = (np.sin(np.arange(5000) * 0.01) * 0.25).astype(np.float32)
    raw = _raw(tmp_path, sig)
    monkeypatch.setattr(aio, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(aio.subprocess, "Popen", _fake_ffmpeg_popen(
        lambda fd: f"import os; os.write({fd}, open({raw!r}, 'rb').read()); "
                   f"os.close({fd}); os._exit(0)"))
    reader = ChunkReader(str(tmp_path / "x.flac"), 16000)
    first = reader.read(1000)
    rest = reader.read(1 << 40)  # crosses the bounded-read loop; the end is not an error
    np.testing.assert_allclose(np.concatenate([first, rest]), sig, atol=1e-4)
    assert reader.read(100) is None
    reader.close()


def test_chunk_reader_raises_on_midstream_decoder_failure(tmp_path, monkeypatch):
    raw = _raw(tmp_path, np.zeros(1000))
    monkeypatch.setattr(aio, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(aio.subprocess, "Popen", _fake_ffmpeg_popen(
        lambda fd: f"import os; os.write({fd}, open({raw!r}, 'rb').read()); "
                   f"os.close({fd}); os._exit(3)"))
    reader = ChunkReader(str(tmp_path / "x.flac"), 16000)
    with pytest.raises(RuntimeError, match=r"exit 3\) after 2000 bytes"):
        reader.read(4000)  # 1000 samples arrive, then the decoder dies


def test_chunk_writer_ffmpeg_pipe(tmp_path, monkeypatch):
    """The writer's pipe carries the s16le bytes; a failed encode raises at
    close()."""
    sink = str(tmp_path / "sink.s16le")
    monkeypatch.setattr(aio, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(aio.subprocess, "Popen", _fake_ffmpeg_popen(
        lambda fd: f"import os\nout = open({sink!r}, 'wb')\n"
                   f"while True:\n    b = os.read({fd}, 65536)\n    if not b: break\n"
                   f"    out.write(b)\nout.close()\nos._exit(0)"))
    sig = np.linspace(-0.5, 0.5, 3001, dtype=np.float32)
    with ChunkWriter(str(tmp_path / "out.flac"), 16000) as writer:
        writer.write(sig)
    np.testing.assert_array_equal(np.fromfile(sink, "<i2"), (sig * 32767).astype("<i2"))

    monkeypatch.setattr(aio.subprocess, "Popen", _fake_ffmpeg_popen(
        lambda fd: f"import os\nwhile os.read({fd}, 65536):\n    pass\nos._exit(2)"))
    writer = ChunkWriter(str(tmp_path / "out2.flac"), 16000)
    writer.write(np.zeros(100, np.float32))
    with pytest.raises(RuntimeError, match="exit 2"):
        writer.close()
