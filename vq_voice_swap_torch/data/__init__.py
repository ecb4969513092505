from .audio_io import (
    ChunkWriter,
    decode_to_linear,
    decode_u_law,
    encode_from_linear,
    encode_u_law,
    read_audio_input,
    read_wav_mono,
)
from .datasets import ChirpDataset, ToneDataset
from .loader import DataLoader, create_data_loader

__all__ = [
    "ChunkWriter",
    "decode_to_linear",
    "decode_u_law",
    "encode_from_linear",
    "encode_u_law",
    "read_audio_input",
    "read_wav_mono",
    "ChirpDataset",
    "ToneDataset",
    "DataLoader",
    "create_data_loader",
]
