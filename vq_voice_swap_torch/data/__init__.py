from .audio_io import (
    ChunkWriter,
    decode_to_linear,
    decode_u_law,
    encode_from_linear,
    encode_u_law,
    read_audio_input,
    read_wav_mono,
)

__all__ = [
    "ChunkWriter",
    "decode_to_linear",
    "decode_u_law",
    "encode_from_linear",
    "encode_u_law",
    "read_audio_input",
    "read_wav_mono",
]
