"""PyTorch port, the slice end to end: mel -> wav through
``WaveNetGenerator`` and the CLI on the CPU, against the JAX generation path
(batch_mels, Upsampler, scan sampler) driven by the same parameters."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu import dsp as jdsp
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.synth.generator import (
    WaveNetGenerator as JaxWaveNetGenerator, batch_mels, encode_seed_audio)
from tacotron_wavenet_vocoder_korean_tpu_torch import convert, generate
from tacotron_wavenet_vocoder_korean_tpu_torch.config import load_config
from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
    incremental_generate_cuda, kernel_limits_error, pack_params)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from torch_port_util import (
    RNG, TINY, TINY_GC, jax_params, nest, port_cfg, port_full_cfg, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WN_MOON = os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz")
MEL0 = os.path.join(REPO, "samples", "both_r2", "0.mel.npy")


def _jax_reference(cfg, jp, mels, gc_ids=None, wav=None):
    """The JAX generator's steps, deterministic: pad, upsample, (seed),
    scan-sample, trim, decode."""
    full = JC.Config(audio=JC.AudioConfig(
        hop_size=int(np.prod(cfg.upsample_factor))), wavenet=cfg)
    batch, frames = batch_mels(mels, -full.audio.max_abs_value)
    lc = JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                 jnp.asarray(batch))
    gc = None
    if gc_ids is not None:
        gc = jnp.asarray(np.asarray(jp["gc_embedding"])[gc_ids])
    seed = None
    if wav is not None:
        total = batch.shape[1] * full.audio.hop_size
        keep = min(cfg.receptive_field, total - 1)
        seed = encode_seed_audio(full, wav, len(mels))[:, -keep:]
    out = np.asarray(JW.incremental_generate(
        cfg, jp, lc, RNG, gc=gc, seed_audio=seed, deterministic=True))
    wavs = [out[i, :f * full.audio.hop_size] for i, f in enumerate(frames)]
    if cfg.input_type == "mulaw":
        wavs = [np.asarray(jdsp.inv_mulaw(jnp.asarray(w),
                                          cfg.quantization_channels))
                for w in wavs]
    return wavs


@pytest.mark.parametrize("case", ["raw", "mulaw_gc_wav_seed"])
def test_generator_matches_jax_generation_path(case):
    """Two ragged mels in one batched call: <= 1e-4 per sample, each wav
    trimmed to frames * hop."""
    cfg = TINY if case == "raw" else dataclasses.replace(
        TINY_GC, input_type="mulaw")
    jp = jax_params(cfg)
    rng = np.random.default_rng(3)
    mels = [rng.standard_normal((f, 80)).astype(np.float32) for f in (9, 6)]
    gen = WaveNetGenerator(port_full_cfg(cfg),
                           convert.params_from_jax(cfg, jp), device="cpu")
    if case == "raw":
        want = _jax_reference(cfg, jp, mels)
        got = gen.generate(mels, deterministic=True)
    else:
        wav = rng.uniform(-0.5, 0.5, 40).astype(np.float32)
        want = _jax_reference(cfg, jp, mels, gc_ids=[1, 1], wav=wav)
        got = gen.generate(mels, speaker_id=1, wav_seed=wav,
                           deterministic=True)
    assert [len(w) for w in got] == [90, 60]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    single = gen.generate(mels[1], deterministic=True)
    assert single.shape == (60,)
    with pytest.raises(ValueError):
        gen.generate([mels[0]] * 9)


def test_generate_leaves_the_callers_tf32_settings():
    """The generator holds its convolutions and matmuls to f32 only for the
    call: the process-wide TF32 flags read the same before and after."""
    gen = WaveNetGenerator(port_full_cfg(TINY), convert.params_from_jax(
        TINY, jax_params(TINY)), device="cpu")
    mel = np.random.default_rng(0).standard_normal((3, 80)).astype(np.float32)
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    before = [f.allow_tf32 for f in flags]
    try:
        for value in (True, False):
            for f in flags:
                f.allow_tf32 = value
            assert gen.generate(mel, deterministic=True).shape == (30,)
            assert [f.allow_tf32 for f in flags] == [value, value]
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v


def test_full_wn_moon_width_matches_jax_scan_sampler():
    """Seeded weights at the full width of the committed wn_moon config,
    64 deterministic samples of the committed mel 0: the kernel's plain
    twin against the JAX scan sampler, <= 1e-4."""
    cfg = load_config(WN_MOON)
    w = cfg.wavenet
    assert (len(w.dilations), w.residual_channels, w.skip_channels,
            w.upsample_factor) == (50, 32, 512, (5, 5, 12))
    tree = convert.seeded_tree(w, 0)
    jcfg = JC.WaveNetConfig(**dataclasses.asdict(w))
    jp = nest(tree)
    mel = np.load(MEL0)[None, :1].astype(np.float32)
    lc = np.asarray(JW.Upsampler(jcfg).apply({"params": jp["upsampler"]},
                                             jnp.asarray(mel)))[:, :64]
    want = np.asarray(JW.incremental_generate(
        jcfg, jp, jnp.asarray(lc), RNG, deterministic=True))
    packed = pack_params(w, convert.params_from_jax(w, tree))
    got = incremental_generate_cuda(w, packed, t(lc),
                                    deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-4


def test_cli_writes_wavs_on_cpu(tmp_path):
    """generate.py with an .npz of JAX-named params and a params.json:
    one wav per mel, frames * hop samples, sample rate from the config."""
    jp = jax_params(TINY)
    np.savez(tmp_path / "w.npz", **convert.flatten(jp))
    cfg = port_full_cfg(TINY)
    (tmp_path / "params.json").write_text(json.dumps({
        "audio": dataclasses.asdict(cfg.audio),
        "wavenet": dataclasses.asdict(cfg.wavenet)}))
    mels = []
    for i, f in enumerate((4, 7)):
        mels.append(str(tmp_path / f"{i}.mel.npy"))
        np.save(mels[-1], np.random.default_rng(i).standard_normal(
            (f, 80)).astype(np.float32))
    generate.main(["--weights", str(tmp_path / "w.npz"), "--config",
                   str(tmp_path / "params.json"), "--mel", mels[0],
                   "--mel", mels[1], "--out", str(tmp_path / "o.wav"),
                   "--device", "cpu"])
    for i, f in enumerate((4, 7)):
        sr, data = wavfile.read(tmp_path / f"o_{i}.wav")
        assert sr == cfg.audio.sample_rate and data.shape == (f * 10,)
    with pytest.raises(ValueError, match="temperature"):
        generate.main(["--init_seed", "0", "--config",
                       str(tmp_path / "params.json"), "--mel", mels[0],
                       "--device", "cpu", "--temperature", "0.5"])


@pytest.mark.parametrize("speaker", [1, -1])
def test_speaker_ids_index_as_the_jax_generator_does(speaker):
    """A valid id and -1 (numpy wraps it to the last speaker) pick the JAX
    generator's rows: the port's output equals the JAX generation path
    with the same ids, <= 1e-4; -1 equals num_speakers - 1."""
    jp = jax_params(TINY_GC)
    gen = WaveNetGenerator(port_full_cfg(TINY_GC),
                           convert.params_from_jax(TINY_GC, jp), device="cpu")
    mel = np.random.default_rng(4).standard_normal((5, 80)).astype(
        np.float32)
    got = gen.generate(mel, speaker_id=speaker, deterministic=True)
    want = _jax_reference(TINY_GC, jp, [mel], gc_ids=[speaker])[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if speaker < 0:
        last = gen.generate(mel, speaker_id=TINY_GC.num_speakers + speaker,
                            deterministic=True)
        np.testing.assert_array_equal(got, last)


def test_speaker_id_out_of_range_raises_index_error_as_in_jax():
    """An id equal to num_speakers raises IndexError in both generators,
    before any sampling."""
    jp = jax_params(TINY_GC)
    full = port_full_cfg(TINY_GC)
    gen = WaveNetGenerator(full, convert.params_from_jax(TINY_GC, jp),
                           device="cpu")
    ref = JaxWaveNetGenerator()
    ref.cfg = JC.Config(audio=JC.AudioConfig(hop_size=full.audio.hop_size),
                        wavenet=TINY_GC)
    ref.params, ref.gc_enable = jp, True
    mel = np.zeros((3, 80), np.float32)
    bad = TINY_GC.num_speakers
    with pytest.raises(IndexError):
        ref.generate(mel, speaker_id=bad)
    with pytest.raises(IndexError):
        gen.generate(mel, speaker_id=bad, deterministic=True)
    with pytest.raises(IndexError):
        gen.generate([mel, mel], speaker_id=[0, bad], deterministic=True)
    assert gen.generate(mel, speaker_id=0, deterministic=True).shape == (30,)


@pytest.mark.parametrize("case", ["tiny", "wn_moon", "wn_moon_quantized",
                                  "front", "skip", "mol", "classes",
                                  "ceiling", "skip_limit", "filter_width"])
def test_kernel_limits_error(case):
    """The CUDA kernel's limits, in one function: R = D = 8 (the test
    widths), the committed wn_moon config (MoL head, and switched to the
    256-way softmax head), 33 front taps, S = 516, 33 mixture components and
    512 classes are accepted; R = D = 256 at wn_moon's 50 layers is refused
    for its shared memory (in both weight types, even split over an 8-block
    cluster: R = D = 128 now takes one), and the two limits that remain
    name themselves: S <= 4096 and two taps per dilated layer."""
    moon = load_config(WN_MOON).wavenet
    quantized = dataclasses.replace(
        moon, input_type="mulaw-quantize", scalar_input=False,
        out_channels=moon.quantization_channels)
    cfg, refused = {
        "tiny": (port_cfg(TINY), None),
        "wn_moon": (moon, None),
        "wn_moon_quantized": (quantized, None),
        "front": (dataclasses.replace(moon, initial_filter_width=33), None),
        "skip": (dataclasses.replace(moon, skip_channels=516), None),
        "mol": (dataclasses.replace(moon, out_channels=99), None),
        "classes": (dataclasses.replace(quantized, quantization_channels=512,
                                        out_channels=512), None),
        "ceiling": (dataclasses.replace(moon, residual_channels=256,
                                        dilation_channels=256),
                    "bytes of shared memory"),
        "skip_limit": (dataclasses.replace(moon, dilations=(1, 2),
                                           skip_channels=4104),
                       "4096 skip channels"),
        "filter_width": (dataclasses.replace(quantized, filter_width=3),
                         "filter_width 2"),
    }[case]
    for weight_dtype in (torch.bfloat16, torch.float32):
        error = kernel_limits_error(cfg, weight_dtype)
        if refused is None:
            assert error is None
        else:
            assert error is not None and refused in error
