"""WAV audio I/O through the stdlib ``wave`` module, plus µ-law companding
(the WAV subset of ``vq_voice_swap_tpu/data/audio_io.py``; other containers
need the ffmpeg path, which is not ported yet)."""

import wave

import numpy as np

__all__ = [
    "ChunkWriter",
    "encode_u_law",
    "decode_u_law",
    "encode_from_linear",
    "decode_to_linear",
    "read_wav_mono",
    "read_audio_input",
]


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


class ChunkWriter:
    """Write float chunks in [-1, 1] to a 16-bit mono PCM .wav file."""

    def __init__(self, path: str, sample_rate: int, encoding: str = "linear"):
        if not path.lower().endswith(".wav"):
            raise RuntimeError(
                f"cannot encode {path!r}: only .wav output is supported"
            )
        self.encoding = encoding
        self._wav = wave.open(path, "wb")
        self._wav.setnchannels(1)
        self._wav.setsampwidth(2)
        self._wav.setframerate(sample_rate)

    def write(self, chunk: np.ndarray) -> None:
        chunk = np.clip(np.asarray(chunk, dtype=np.float32), -1, 1)
        chunk = decode_to_linear(chunk, self.encoding)
        self._wav.writeframes((chunk * (2**15 - 1)).astype("<i2").tobytes())

    def close(self) -> None:
        self._wav.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_audio_input(
    path: str, sample_rate: int, seconds: int, encoding: str = "linear"
) -> np.ndarray:
    """Decode up to ``seconds`` of a .wav clip for the conversion CLI.

    Fails loudly (SystemExit) on an empty or unsupported input and warns
    when the clip is shorter than requested."""
    if not path.lower().endswith(".wav"):
        raise SystemExit(f"cannot decode {path!r}: only .wav input is supported")
    want = seconds * sample_rate
    chunk = read_wav_mono(path, sample_rate)[:want]
    if len(chunk) == 0:
        raise SystemExit(f"could not decode any audio from {path!r}")
    if len(chunk) < want:
        print(
            f"warning: input is only {len(chunk) / sample_rate:.2f}s, "
            f"shorter than the requested {seconds}s"
        )
    return np.asarray(encode_from_linear(chunk, encoding), dtype=np.float32)
