"""PyTorch/CUDA port of the serving path: the Korean text frontend and
Tacotron (text -> mel), the WaveNet vocoder (mel -> wav).

Counterpart of the JAX package ``tacotron_wavenet_vocoder_korean_tpu``,
which stays the reference.  This package imports torch, numpy and scipy,
never JAX nor the JAX package; the module names mirror the JAX package's.
"""
