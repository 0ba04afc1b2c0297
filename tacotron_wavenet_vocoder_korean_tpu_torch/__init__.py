"""PyTorch/CUDA port of the WaveNet vocoder serving path (mel -> wav).

Counterpart of the JAX package ``tacotron_wavenet_vocoder_korean_tpu``,
which stays the reference.  This package imports torch, numpy and scipy,
never JAX nor the JAX package; the module names mirror the JAX package's.
"""
