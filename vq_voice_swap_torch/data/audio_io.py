"""Streaming audio I/O and µ-law companding (counterpart of
``vq_voice_swap_tpu/data/audio_io.py``).

Where ffmpeg is installed, ``ChunkReader`` and ``ChunkWriter`` run it as a
subprocess with an s16le mono pipe at the target rate, so any container it
knows (flac, mp3, ...) reads and writes. Without it, PCM .wav is handled by
the stdlib ``wave`` module with linear-interpolation resampling, and any
other container raises a clear error.
"""

import os
import shutil
import subprocess
import wave
from typing import Optional

import numpy as np

__all__ = [
    "ChunkReader",
    "ChunkWriter",
    "lookup_audio_duration",
    "encode_u_law",
    "decode_u_law",
    "encode_from_linear",
    "decode_to_linear",
    "have_ffmpeg",
    "read_wav_mono",
    "read_audio_input",
]


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def encode_u_law(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    return np.sign(x) * (np.log1p(mu * np.abs(x)) / np.log1p(mu))


def decode_u_law(x: np.ndarray, mu: float = 255.0) -> np.ndarray:
    return np.sign(x) * (1.0 / mu) * ((1.0 + mu) ** np.abs(x) - 1.0)


def encode_from_linear(x: np.ndarray, encoding: str) -> np.ndarray:
    if encoding == "linear":
        return x
    if encoding == "ulaw":
        return encode_u_law(x)
    raise ValueError(f"unknown audio encoding: {encoding}")


def decode_to_linear(x: np.ndarray, encoding: str) -> np.ndarray:
    if encoding == "linear":
        return x
    if encoding == "ulaw":
        return decode_u_law(x)
    raise ValueError(f"unknown audio encoding: {encoding}")


def _resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate or len(x) == 0:
        return x
    n_out = int(round(len(x) * dst_rate / src_rate))
    src_pos = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    return np.interp(src_pos, np.arange(len(x), dtype=np.float64), x).astype(
        x.dtype
    )


def read_wav_mono(path: str, sample_rate: int) -> np.ndarray:
    """Decode a whole PCM .wav file to float32 mono at sample_rate."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        src_rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 2**15
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128) / 128
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2**31
    else:
        raise ValueError(f"unsupported wav sample width: {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return _resample_linear(data, src_rate, sample_rate)


class ChunkReader:
    """Read float chunks in [-1, 1] from an audio file, in order: through
    an ffmpeg pipe (s16le mono at sample_rate) when ffmpeg exists, else a
    PCM .wav decoded natively."""

    def __init__(self, path: str, sample_rate: int, encoding: str = "linear"):
        self.path = path
        self.sample_rate = sample_rate
        self.encoding = encoding
        self._done = False
        self._proc = None
        self._reader = None
        self._buffer: Optional[np.ndarray] = None
        self._pos = 0
        self._read_total = 0

        if have_ffmpeg():
            read_fd, write_fd = os.pipe()
            try:
                self._proc = subprocess.Popen(
                    [
                        "ffmpeg", "-i", path,
                        "-f", "s16le", "-ar", str(sample_rate), "-ac", "1",
                        f"pipe:{write_fd}",
                    ],
                    pass_fds=(write_fd,),
                    stdin=subprocess.DEVNULL,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
                self._reader = os.fdopen(read_fd, "rb")
                read_fd = None
            finally:
                os.close(write_fd)
                if read_fd is not None:
                    os.close(read_fd)
        elif path.lower().endswith(".wav"):
            self._buffer = read_wav_mono(path, sample_rate)
        else:
            raise RuntimeError(
                f"cannot decode {path!r}: ffmpeg is not installed and only "
                ".wav files are supported natively"
            )

    def read(self, chunk_size: int) -> Optional[np.ndarray]:
        """Up to chunk_size samples; None once the file is exhausted."""
        if self._buffer is not None:
            if self._pos >= len(self._buffer) and self._done:
                return None
            chunk = self._buffer[self._pos:self._pos + chunk_size]
            self._pos += chunk_size
            if self._pos >= len(self._buffer):
                self._done = True
            if len(chunk) == 0:
                return None
            return encode_from_linear(chunk, self.encoding)

        if self._done:
            return None
        # Bounded reads: one read of a huge chunk_size (1 << 62 meaning
        # "everything") would overflow the reader's byte count.
        goal = chunk_size * 2
        pieces = []
        got = 0
        while got < goal:
            piece = self._reader.read(min(goal - got, 1 << 25))
            if not piece:
                break
            pieces.append(piece)
            got += len(piece)
        buf = b"".join(pieces)
        if len(buf) < goal:
            # The stream ended: at the end of the file, or because ffmpeg
            # failed (a missing file, an unknown codec, a corrupt stream).
            # A failure mid-stream usually shows as a last short chunk, so
            # the exit code is checked here and not only on an empty read:
            # taken as the end of the file, it would zero-pad every later
            # window of the file.
            self._done = True
            if self._proc is not None:
                code = self._proc.wait()
                if code != 0:
                    raise RuntimeError(
                        f"ffmpeg failed while decoding {self.path!r} "
                        f"(exit {code}) after "
                        f"{self._read_total + len(buf)} bytes: missing "
                        f"file, unsupported codec, or corrupt stream?"
                    )
        if not buf:
            return None
        if len(buf) % 2:  # the decoder stopped mid-sample: drop the torn byte
            buf = buf[:-1]
            if not buf:
                return None
        self._read_total += len(buf)
        linear = np.frombuffer(buf, dtype="<i2").astype(np.float32) / 2**15
        return encode_from_linear(linear, self.encoding)

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
        if self._proc is not None:
            self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ChunkWriter:
    """Write float chunks in [-1, 1] to an audio file: through ffmpeg (any
    container) when it exists, else as 16-bit mono PCM .wav."""

    def __init__(self, path: str, sample_rate: int, encoding: str = "linear"):
        self.path = path
        self.sample_rate = sample_rate
        self.encoding = encoding
        self._proc = None
        self._writer = None
        self._wav = None

        if have_ffmpeg():
            read_fd, write_fd = os.pipe()
            try:
                fmt = ["-ar", str(sample_rate), "-ac", "1", "-f", "s16le"]
                self._proc = subprocess.Popen(
                    [
                        "ffmpeg", "-y", *fmt,
                        "-probesize", "32", "-thread_queue_size", "60",
                        "-i", f"pipe:{read_fd}", path,
                    ],
                    pass_fds=(read_fd,),
                    stdin=subprocess.DEVNULL,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
                self._writer = os.fdopen(write_fd, "wb", buffering=1024)
                write_fd = None
            finally:
                os.close(read_fd)
                if write_fd is not None:
                    os.close(write_fd)
        elif path.lower().endswith(".wav"):
            self._wav = wave.open(path, "wb")
            self._wav.setnchannels(1)
            self._wav.setsampwidth(2)
            self._wav.setframerate(sample_rate)
        else:
            raise RuntimeError(
                f"cannot encode {path!r}: ffmpeg is not installed and only "
                ".wav output is supported natively"
            )

    def write(self, chunk: np.ndarray) -> None:
        chunk = np.clip(np.asarray(chunk, dtype=np.float32), -1, 1)
        chunk = decode_to_linear(chunk, self.encoding)
        data = (chunk * (2**15 - 1)).astype("<i2").tobytes()
        if self._wav is not None:
            self._wav.writeframes(data)
        else:
            self._writer.write(data)

    def close(self) -> None:
        if self._wav is not None:
            self._wav.close()
        if self._writer is not None:
            self._writer.close()
        if self._proc is not None:
            code = self._proc.wait()
            if code != 0:
                # ffmpeg's stderr is discarded: without this a failed
                # encode (a full disk, an unwritable path) would pass.
                raise RuntimeError(
                    f"ffmpeg failed to encode {self.path!r} (exit {code})"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def lookup_audio_duration(path: str) -> float:
    """Duration in seconds: from ffmpeg's report when it exists, else from
    the .wav header."""
    if not have_ffmpeg():
        if path.lower().endswith(".wav"):
            with wave.open(path, "rb") as w:
                return w.getnframes() / w.getframerate()
        raise RuntimeError(
            f"cannot probe {path!r}: ffmpeg not installed and not a wav file"
        )
    proc = subprocess.Popen(
        ["ffmpeg", "-i", path],
        stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
    )
    _, output = proc.communicate()
    for line in str(output, "utf-8").split("\n"):
        line = line.strip()
        if line.startswith("Duration:"):
            stamp = line.split(" ")[1].split(",")[0]
            try:
                hours, minutes, seconds = (float(x) for x in stamp.split(":"))
            except ValueError:  # "Duration: N/A" (a raw or corrupt container)
                break
            return seconds + 60 * (minutes + 60 * hours)
    raise ValueError(f"unexpected ffmpeg output for: {path}")


def read_audio_input(
    path: str, sample_rate: int, seconds: int, encoding: str = "linear"
) -> np.ndarray:
    """Decode up to ``seconds`` of an input clip for the conversion CLIs.

    Fails loudly (SystemExit) on an undecodable or empty input and warns
    when the clip is shorter than requested."""
    want = seconds * sample_rate
    with ChunkReader(path, sample_rate=sample_rate, encoding=encoding) as r:
        chunk = r.read(want)
    if chunk is None or len(chunk) == 0:
        raise SystemExit(
            f"could not decode any audio from {path!r} (missing file, "
            f"unsupported codec, or empty stream)"
        )
    if len(chunk) < want:
        print(
            f"warning: input is only {len(chunk) / sample_rate:.2f}s, "
            f"shorter than the requested {seconds}s"
        )
    return np.asarray(chunk, dtype=np.float32)
