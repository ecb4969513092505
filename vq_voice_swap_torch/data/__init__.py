from .audio_io import (
    ChunkReader,
    ChunkWriter,
    decode_to_linear,
    decode_u_law,
    encode_from_linear,
    encode_u_law,
    have_ffmpeg,
    lookup_audio_duration,
    read_audio_input,
    read_wav_mono,
)
from .datasets import ChirpDataset, LibriSpeech, ToneDataset, build_file_index
from .loader import DataLoader, create_data_loader

__all__ = [
    "ChunkReader",
    "ChunkWriter",
    "decode_to_linear",
    "decode_u_law",
    "encode_from_linear",
    "encode_u_law",
    "have_ffmpeg",
    "lookup_audio_duration",
    "read_audio_input",
    "read_wav_mono",
    "LibriSpeech",
    "ChirpDataset",
    "ToneDataset",
    "build_file_index",
    "DataLoader",
    "create_data_loader",
]
