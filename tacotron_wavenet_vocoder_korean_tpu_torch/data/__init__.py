"""Data pipeline: corpus preprocessing, the Tacotron and WaveNet batchers
and the device prefetcher (counterpart of the JAX package's ``data``)."""
from .corpus import (
    preprocess_corpus, build_moon, build_son, build_ljspeech,
    build_cmu_arctic, build_from_json_corpus, write_metadata,
    CORPUS_BUILDERS,
)
from .loader import (
    TacotronBatch, TacotronBatcher, WaveNetBatcher, WaveNetBatch, round_up,
    scan_npz_dir)
from .feeder import DevicePrefetcher

__all__ = [
    "preprocess_corpus", "build_moon", "build_son", "build_ljspeech",
    "build_cmu_arctic", "build_from_json_corpus", "write_metadata",
    "CORPUS_BUILDERS", "TacotronBatch", "TacotronBatcher", "WaveNetBatcher",
    "WaveNetBatch", "round_up", "scan_npz_dir",
    "DevicePrefetcher",
]
