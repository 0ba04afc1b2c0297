"""The evaluation commands (counterparts of the JAX system's
``scripts/vocoder_eval.py``, ``scripts/quality_eval.py`` and
``scripts/wavenet_diagnose.py``), each run as ``python -m
tacotron_wavenet_vocoder_korean_tpu_torch.scripts.<name>``."""
