"""PyTorch port, the mulaw-quantize path (one-hot front, 256-way softmax
head with temperature): the kernel's plain twin against the JAX scan
sampler and the Pallas kernel (interpret mode), the seed encoding and
decoding against the JAX generator's, and ``WaveNetGenerator`` and the CLI
on the CPU.  f32 weights throughout (bf16 is tests/test_torch_bf16.py)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.io import wavfile

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.config import WaveNetConfig
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.ops import wavenet_pallas as JP
from tacotron_wavenet_vocoder_korean_tpu.synth import generator as JG
from tacotron_wavenet_vocoder_korean_tpu_torch import convert, generate
from tacotron_wavenet_vocoder_korean_tpu_torch.models.mixture import (
    U_MAX, U_MIN)
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from tacotron_wavenet_vocoder_korean_tpu_torch.synth import generator as PG
from torch_port_util import (
    RNG, TINY, jax_params, make_inputs, nest, port_cfg, port_full_cfg, t)

# The JAX tests' quantized stack (tests/test_wavenet.py _quantized_gen_cfg),
# and the same stack with the full 256 classes.
Q64 = WaveNetConfig(
    input_type="mulaw-quantize", scalar_input=False,
    dilations=(1, 2, 4, 1, 2, 4), residual_channels=8, dilation_channels=8,
    skip_channels=16, quantization_channels=64, out_channels=64,
    upsample_factor=(2, 5), sample_size=100, batch_size=1)
Q256 = dataclasses.replace(Q64, quantization_channels=256, out_channels=256)
CFGS = {"q64": Q64, "q256": Q256}


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    """(JAX config, JAX params, packed port layout, upsampled lc [2, 100])."""
    cfg = CFGS[request.param]
    jp = jax_params(cfg)
    packed = G.pack_params(port_cfg(cfg), convert.params_from_jax(
        port_cfg(cfg), jp))
    _, mel = make_inputs(B=2, frames=10, seed=3)
    lc = np.asarray(JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                            jnp.asarray(mel)))
    return cfg, jp, packed, lc


def _seed_onehot(cfg, n, seed=2):
    cls = np.random.RandomState(seed).randint(
        0, cfg.quantization_channels, (2, n))
    return np.asarray(jax.nn.one_hot(cls, cfg.quantization_channels))


@pytest.mark.parametrize("primed", [False, True], ids=["free", "primed"])
def test_twin_matches_scan_sampler_deterministic(primed, model):
    """Free-running (or primed with 33 one-hot classes) argmax sampling over
    100 steps: the same classes as the scan sampler, which starts from a
    zero one-hot vector where the twin's window holds -1."""
    cfg, jp, packed, lc = model
    seed = _seed_onehot(cfg, 33) if primed else None
    want = np.asarray(JW.incremental_generate(
        cfg, jp, jnp.asarray(lc), RNG, deterministic=True,
        seed_audio=None if seed is None else jnp.asarray(seed)))
    got = G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), deterministic=True,
        seed_audio=None if seed is None else t(seed)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("primed", [False, True], ids=["free", "primed"])
def test_twin_matches_pallas_kernel_interpret(primed, model):
    """The twin against the Pallas kernel's softmax head run as the JAX
    tests run it (interpret mode, f32 weights, deterministic, chunk 20):
    the same classes, free-running or primed with one-hot classes."""
    cfg, jp, packed, lc = model
    seed = _seed_onehot(cfg, 33, seed=4) if primed else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.pallas_incremental_generate(
            cfg, jp, jnp.asarray(lc), RNG, chunk=20, deterministic=True,
            weight_dtype=jnp.float32,
            seed_audio=None if seed is None else jnp.asarray(seed)))
    got = G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), deterministic=True,
        seed_audio=None if seed is None else t(seed)).numpy()
    assert got.shape == want.shape == (2, 100)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_teacher_forced_classes_follow_jax_logits(temperature, model):
    """Every step's input given (nothing compounds): the twin's class is the
    head's formula applied to the JAX per-step logits, log(softmax + 1e-20)
    / T, argmax (deterministic) or minus log(-log(u)) on given uniforms,
    the lowest class on ties."""
    cfg, jp, packed, lc = model
    Q = cfg.quantization_channels
    audio = _seed_onehot(cfg, lc.shape[1], seed=6)
    logits = np.asarray(JW.teacher_forced_incremental(
        cfg, jp, jnp.asarray(audio), jnp.asarray(lc)))       # [B, T, Q]
    scores = np.log(np.asarray(jax.nn.softmax(logits, -1)) + 1e-20) / temperature
    u = np.random.default_rng(7).uniform(size=(lc.shape[1], 2, Q)).astype(
        np.float32)
    gumbel = -np.log(-np.log(np.clip(u, U_MIN, U_MAX)))
    run = lambda **kw: G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), seed_audio=t(audio),
        temperature=temperature, **kw).numpy()
    np.testing.assert_array_equal(run(deterministic=True),
                                  scores.argmax(-1))
    np.testing.assert_array_equal(
        run(noise=t(u)), (scores + gumbel.transpose(1, 0, 2)).argmax(-1))


def _categorical_uniforms(rng, T, B, Q):
    """The uniforms behind the scan sampler's ``jax.random.categorical``
    draws over T steps: it splits a step key per step, and categorical's
    Gumbel noise is -log(-log(u)) of uniform(step, [B, Q], tiny, 1)."""
    out = []
    for _ in range(T):
        rng, step = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(
            step, (B, Q), minval=np.finfo(np.float32).tiny, maxval=1.0)))
    return np.stack(out)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_stochastic_twin_matches_scan_sampler_on_its_uniforms(temperature,
                                                              model):
    """The scan sampler's own uniforms, replayed into the twin as its noise
    tensor, 2 streams x 100 steps: the same classes.  The twin clips
    uniforms to [1e-5, 1-1e-5] (as the Pallas kernel does) and the scan
    sampler does not, so a stream may part only at a step holding such a
    uniform; those steps are counted, and a stream must match up to the
    first of them that changes its class."""
    cfg, jp, packed, lc = model
    rng = jax.random.PRNGKey(5)
    want = np.asarray(JW.incremental_generate(
        cfg, jp, jnp.asarray(lc), rng, temperature=temperature))
    u = _categorical_uniforms(rng, lc.shape[1], 2, cfg.quantization_channels)
    clipped = ((u < U_MIN) | (u > U_MAX)).any(-1).T             # [B, T]
    got = G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), noise=t(u),
        temperature=temperature).numpy()
    for b in range(2):
        diff = np.flatnonzero(got[b] != want[b])
        first = diff[0] if diff.size else None
        assert first is None or clipped[b, first], (
            f"stream {b} parts at step {first} with no clipped uniform "
            f"there ({int(clipped.sum())} clipped steps in all)")
    assert (got == want).mean() > 0.9, int(clipped.sum())
    assert len(np.unique(want)) > 10


def test_seeded_quantized_params_have_jax_shapes_and_sample():
    """Seeded mulaw-quantize weights have exactly the flax model's names and
    shapes (``causal_kernel`` [2, Q, R], ``post_2`` [S, Q]), at flax's
    scales, and give a non-constant class stream."""
    seeded = convert.seeded_tree(port_cfg(Q256), 0)
    assert {k: v.shape for k, v in seeded.items()} == {
        k: v.shape for k, v in convert.flatten(jax_params(Q256)).items()}
    assert seeded["causal_kernel"].shape == (2, 256, 8)
    assert not seeded["post_2/bias"].any()
    packed = G.pack_params(port_cfg(Q256), convert.params_from_jax(
        port_cfg(Q256), seeded))
    lc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 120, 80)).astype(np.float32))
    out = G.incremental_generate_cuda(port_cfg(Q256), packed, lc,
                                      deterministic=True)
    assert len(torch.unique(out)) > 5
    with pytest.raises(ValueError, match="out_channels"):
        G.pack_params(dataclasses.replace(port_cfg(Q256), out_channels=30),
                      convert.params_from_jax(port_cfg(Q256), seeded))


def _full_cfgs(cfg):
    jfull = JC.Config(audio=JC.AudioConfig(
        hop_size=int(np.prod(cfg.upsample_factor))), wavenet=cfg)
    return jfull, port_full_cfg(cfg)


def test_seed_encoding_and_decoding_match_jax_generator():
    """A raw seed wav -> one-hot mu-law classes, and class ids -> wav, as
    the JAX generator's ``encode_seed_audio`` / ``_decode_samples`` do."""
    jfull, pfull = _full_cfgs(Q256)
    wav = np.random.default_rng(1).uniform(-1, 1, 3000).astype(np.float32)
    wav[:5] = [-1.0, 0.0, 1.0, 1e-4, -1e-4]
    want = np.asarray(JG.encode_seed_audio(jfull, wav, 2))
    got = PG.encode_seed_audio(pfull, wav, 2).numpy()
    assert got.shape == want.shape == (2, 3000, 256)
    np.testing.assert_array_equal(got, want)
    jgen = JG.WaveNetGenerator()
    jgen.cfg = jfull
    gen = PG.WaveNetGenerator(pfull, convert.seeded_params(port_cfg(Q256), 0),
                              device="cpu")
    classes = np.arange(256, dtype=np.float32)
    np.testing.assert_allclose(gen._decode_samples(classes),
                               jgen._decode_samples(classes),
                               rtol=0, atol=1e-6)


def _jax_generation_path(cfg, jp, mels, wav):
    """The JAX generator's steps, deterministic: pad, upsample, seed, scan
    sample, trim, decode."""
    jfull, _ = _full_cfgs(cfg)
    hop = jfull.audio.hop_size
    batch, frames = JG.batch_mels(mels, -jfull.audio.max_abs_value)
    lc = JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                 jnp.asarray(batch))
    keep = min(cfg.receptive_field, batch.shape[1] * hop - 1)
    seed = JG.encode_seed_audio(jfull, wav, len(mels))[:, -keep:]
    out = np.asarray(JW.incremental_generate(
        cfg, jp, lc, RNG, seed_audio=seed, deterministic=True))
    jgen = JG.WaveNetGenerator()
    jgen.cfg = jfull
    return [jgen._decode_samples(out[i, :f * hop])
            for i, f in enumerate(frames)]


def test_generator_matches_jax_generation_path():
    """Two ragged mels in one batched call with a wav_seed, deterministic:
    the same wavs as the JAX generator's path (classes equal, decoded to
    <= 1e-6), each trimmed to frames * hop and in [-1, 1]."""
    jp = jax_params(Q64)
    rng = np.random.default_rng(3)
    mels = [rng.standard_normal((f, 80)).astype(np.float32) for f in (9, 6)]
    wav = rng.uniform(-0.5, 0.5, 40).astype(np.float32)
    want = _jax_generation_path(Q64, jp, mels, wav)
    gen = PG.WaveNetGenerator(port_full_cfg(Q64),
                              convert.params_from_jax(Q64, jp), device="cpu")
    got = gen.generate(mels, wav_seed=wav, deterministic=True)
    assert [len(w) for w in got] == [90, 60]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        assert np.abs(g).max() <= 1.0 and g.std() > 0


def test_generator_temperature_reaches_the_softmax_head():
    """Stochastic generation on the same seed: another temperature draws
    other classes; a temperature so low that the scaled scores outweigh any
    clipped Gumbel draw gives the argmax stream.  The MoL head refuses a
    temperature other than 1."""
    pfull = port_full_cfg(Q256)
    gen = PG.WaveNetGenerator(pfull, convert.seeded_params(port_cfg(Q256), 0),
                              device="cpu")
    mel = np.random.default_rng(0).standard_normal((6, 80)).astype(np.float32)
    hot = gen.generate(mel, seed=1, temperature=1.0)
    cool = gen.generate(mel, seed=1, temperature=0.7)
    assert hot.shape == cool.shape == (60,)
    assert np.isfinite(hot).all() and np.abs(hot).max() <= 1.0
    assert not np.array_equal(hot, cool)
    np.testing.assert_array_equal(gen.generate(mel, seed=1, temperature=1e-4),
                                  gen.generate(mel, deterministic=True))
    raw = PG.WaveNetGenerator(port_full_cfg(TINY),
                              convert.seeded_params(port_cfg(TINY), 0),
                              device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        raw.generate(mel, temperature=0.5)


def test_cli_vocodes_mulaw_quantize_on_cpu(tmp_path):
    """generate.py with seeded weights of a mulaw-quantize params.json,
    --temperature 0.7 and a --wav_seed: one wav per mel, frames * hop
    samples at the config's sample rate."""
    cfg = port_full_cfg(Q64)
    (tmp_path / "params.json").write_text(json.dumps({
        "audio": dataclasses.asdict(cfg.audio),
        "wavenet": dataclasses.asdict(cfg.wavenet)}))
    mels = []
    for i, f in enumerate((4, 7)):
        mels.append(str(tmp_path / f"{i}.mel.npy"))
        np.save(mels[-1], np.random.default_rng(i).standard_normal(
            (f, 80)).astype(np.float32))
    wavfile.write(tmp_path / "seed.wav", cfg.audio.sample_rate,
                  (np.sin(np.arange(50) / 3) * 9000).astype(np.int16))
    generate.main(["--init_seed", "0", "--config",
                   str(tmp_path / "params.json"), "--mel", mels[0], "--mel",
                   mels[1], "--out", str(tmp_path / "o.wav"), "--device",
                   "cpu", "--temperature", "0.7", "--wav_seed",
                   str(tmp_path / "seed.wav")])
    for i, f in enumerate((4, 7)):
        sr, data = wavfile.read(tmp_path / f"o_{i}.wav")
        assert sr == cfg.audio.sample_rate and data.shape == (f * 10,)
        assert data.std() > 0
