"""DSP: mel and linear spectrograms and their inverses, Griffin-Lim,
mu-law, wav IO, and the preprocessing helpers (``extract_features``,
rescaling, silence trimming); the counterpart of the JAX package's
``dsp``.  The functions ``stft``, ``griffin_lim`` and ``mulaw`` are not
re-exported here, unlike in the JAX package: those names stay the modules
``dsp.stft``, ``dsp.griffin_lim`` and ``dsp.mulaw``."""
from .stft import (
    istft, preemphasis, inv_preemphasis, amp_to_db, db_to_amp,
    normalize, denormalize, linear_spectrogram, mel_spectrogram,
    mel_to_linear, mel_basis, hann_window, extract_features,
)
from .griffin_lim import inv_linear_spectrogram, inv_mel_spectrogram
from .mulaw import (
    inv_mulaw, mulaw_quantize, inv_mulaw_quantize, mulaw_encode, mulaw_decode,
)
from .audio_io import (
    load_wav, save_wav, rescale, trim_silence, start_and_end_indices,
)

__all__ = [
    "istft", "preemphasis", "inv_preemphasis", "amp_to_db",
    "db_to_amp", "normalize", "denormalize", "linear_spectrogram",
    "mel_spectrogram", "mel_to_linear", "mel_basis", "hann_window",
    "extract_features", "inv_linear_spectrogram", "inv_mel_spectrogram",
    "inv_mulaw", "mulaw_quantize", "inv_mulaw_quantize", "mulaw_encode",
    "mulaw_decode", "load_wav", "save_wav", "rescale", "trim_silence",
    "start_and_end_indices",
]
