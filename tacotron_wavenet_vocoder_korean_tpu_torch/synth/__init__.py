"""Inference: Tacotron synthesizer, WaveNet generator, end-to-end pipeline."""
from .synthesizer import Synthesizer, attention_trim_index
from .generator import WaveNetGenerator
from .e2e import TTSPipeline

__all__ = ["Synthesizer", "attention_trim_index", "WaveNetGenerator",
           "TTSPipeline"]
