"""Data pipeline: corpus preprocessing, the WaveNet batcher and the
device prefetcher (counterpart of the JAX package's ``data``; its
Tacotron batcher is not ported yet)."""
from .corpus import (
    preprocess_corpus, build_moon, build_son, build_ljspeech,
    build_cmu_arctic, build_from_json_corpus, write_metadata,
    CORPUS_BUILDERS,
)
from .loader import WaveNetBatcher, WaveNetBatch, round_up
from .feeder import DevicePrefetcher

__all__ = [
    "preprocess_corpus", "build_moon", "build_son", "build_ljspeech",
    "build_cmu_arctic", "build_from_json_corpus", "write_metadata",
    "CORPUS_BUILDERS", "WaveNetBatcher", "WaveNetBatch", "round_up",
    "DevicePrefetcher",
]
