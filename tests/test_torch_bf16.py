"""PyTorch port, bf16 weights (the weight type the Pallas kernel serves with
by default): what ``pack_params`` casts, the twin's bf16 numeric contract
(activations rounded to bf16 before each product, f32 sums) held to the
JAX package's own drift bound against the f32 scan sampler and against
the Pallas kernel at bf16 (interpret mode), and the generator's choice of
weight type per device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tacotron_wavenet_vocoder_korean_tpu.config import WaveNetConfig
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.ops import wavenet_pallas as JP
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from tacotron_wavenet_vocoder_korean_tpu_torch.synth import generator as PG
from torch_port_util import (
    RNG, TINY, TINY_GC, jax_params, make_inputs, port_cfg, port_full_cfg, t)

BF16 = torch.bfloat16
# The JAX package's bound on bf16 drift against the f32 scan sampler
# (tests/test_wavenet.py:203-232): correlation, mean relative drift.
CORR_MIN, REL_MAX = 0.99, 0.15
# Softmax head, teacher-forced: the share of steps whose class must agree
# with f32.  bf16 moves each logit by ~0.4% relative; a step flips where
# its top two classes are closer than that (about 1% of the steps here).
CLASS_AGREE = 0.95

Q64 = WaveNetConfig(
    input_type="mulaw-quantize", scalar_input=False,
    dilations=(1, 2, 4, 1, 2, 4), residual_channels=8, dilation_channels=8,
    skip_channels=16, quantization_channels=64, out_channels=64,
    upsample_factor=(2, 5), sample_size=100, batch_size=1)
Q256 = dataclasses.replace(Q64, quantization_channels=256, out_channels=256)

# Port packed name -> the Pallas packing's names that hold the same numbers
# (w_tap feeds w_old and w_cur_blk; the residual kernels enter m_next and
# m_rest, whose first R columns are w_res).
PORT_TO_JAX = {
    "w_tap": ("w_old", "w_cur_blk"), "w_res_t": ("m_next", "m_rest"),
    "b_res": ("b_res",), "front_t": ("front",), "front_oh": ("front",),
    "w_skip": ("w_skip",), "skip_bias": ("skip_bias",), "post1": ("post1",),
    "b1": ("b1",), "post2_t": ("post2",), "b2": ("b2",),
    "w_lc_all": ("w_lc_all",), "lc_bias": ("lc_bias",),
    "w_gc_all": ("w_gc_all",),
}


def _drift(got, want):
    got, want = np.ravel(got), np.ravel(want)
    corr = np.corrcoef(got, want)[0, 1]
    rel = np.abs(got - want).mean() / (np.abs(want).mean() + 1e-8)
    return corr, rel


@pytest.mark.parametrize("B,seed", [(1, 0), (2, 4)], ids=["ref", "two"])
def test_bf16_twin_within_reference_drift_of_f32_and_pallas(B, seed):
    """MoL head, deterministic, free-running 160 steps on flax-initialised
    weights: the bf16 twin and the Pallas kernel at bf16 both within the
    reference's bound of the f32 scan sampler, and of each other (the
    Pallas kernel rounds its fused products, the port its factors, so they
    are not equal)."""
    audio, mel = make_inputs(B=B, frames=16, seed=seed)
    jp = JW.WaveNet(TINY).init(RNG, audio[:1], mel[:1])["params"]
    lc = JW.Upsampler(TINY).apply({"params": jp["upsampler"]}, mel)
    scan = np.asarray(JW.incremental_generate(TINY, jp, lc, RNG,
                                              deterministic=True))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JP.pallas_incremental_generate(
            TINY, jp, lc, RNG, chunk=32, deterministic=True,
            weight_dtype=jnp.bfloat16))
    packed = G.pack_params(port_cfg(TINY), convert.params_from_jax(
        port_cfg(TINY), jp), BF16)
    twin = G.incremental_generate_cuda(port_cfg(TINY), packed,
                                       t(np.asarray(lc)),
                                       deterministic=True).numpy()
    assert twin.shape == scan.shape == (B, 160)
    for a, b in ((twin, scan), (pallas, scan), (twin, pallas)):
        corr, rel = _drift(a, b)
        assert corr > CORR_MIN and rel < REL_MAX, (corr, rel)
    assert not np.array_equal(twin, scan)


@pytest.mark.parametrize("cfg", [Q64, Q256], ids=["q64", "q256"])
def test_bf16_softmax_head_teacher_forced_close_to_f32(cfg):
    """Softmax head, deterministic, every step's input given (a flip does
    not compound): the bf16 twin and the Pallas kernel at bf16 pick the f32
    scan sampler's class on at least 95% of 2 x 160 steps, and each
    other's as often."""
    jp = jax_params(cfg)
    Q = cfg.quantization_channels
    _, mel = make_inputs(B=2, frames=16, seed=3)
    lc = np.asarray(JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                            jnp.asarray(mel)))
    seed = np.asarray(jax.nn.one_hot(np.random.RandomState(6).randint(
        0, Q, (2, lc.shape[1])), Q))
    scan = np.asarray(JW.incremental_generate(
        cfg, jp, jnp.asarray(lc), RNG, deterministic=True,
        seed_audio=jnp.asarray(seed)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JP.pallas_incremental_generate(
            cfg, jp, jnp.asarray(lc), RNG, chunk=32, deterministic=True,
            weight_dtype=jnp.bfloat16, seed_audio=jnp.asarray(seed)))
    packed = G.pack_params(port_cfg(cfg), convert.params_from_jax(
        port_cfg(cfg), jp), BF16)
    twin = G.incremental_generate_cuda(port_cfg(cfg), packed, t(lc),
                                       deterministic=True,
                                       seed_audio=t(seed)).numpy()
    for a, b in ((twin, scan), (pallas, scan), (twin, pallas)):
        assert (a == b).mean() >= CLASS_AGREE, (a == b).mean()


@pytest.mark.parametrize("cfg", [TINY_GC, Q64], ids=["mol_gc", "softmax"])
def test_pack_params_casts_what_the_pallas_packing_casts(cfg):
    """At bf16 the port casts exactly the matrices the Pallas packing casts
    and keeps biases and the lc/speaker projection in f32; every number a
    port tensor shares with the Pallas packing is the same bf16 value."""
    jp = jax_params(cfg)
    port = G.pack_params(port_cfg(cfg), convert.params_from_jax(
        port_cfg(cfg), jp), BF16)
    jpack = JP.pack_params(cfg, jp, weight_dtype=jnp.bfloat16, fuse_block=1)
    jax_bf16 = {k for k, v in jpack.items() if v.dtype == jnp.bfloat16}
    assert jax_bf16 == {"w_old", "w_cur_blk", "m_next", "m_rest", "w_skip",
                        "front", "post1", "post2"}
    for k, v in port.items():
        if k == "dilations":
            continue
        names = PORT_TO_JAX[k]
        assert (v.dtype == BF16) == (names[0] in jax_bf16), k
        assert (v.dtype == BF16) == (k in G.WEIGHTS), k
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    bf = lambda x: x.float().numpy()
    R, D = cfg.residual_channels, cfg.dilation_channels
    np.testing.assert_array_equal(bf(port["w_skip"]), f32(jpack["w_skip"]))
    np.testing.assert_array_equal(bf(port["post1"]), f32(jpack["post1"]))
    np.testing.assert_array_equal(bf(port["post2_t"]).T, f32(jpack["post2"]))
    np.testing.assert_array_equal(bf(port["w_res_t"]).transpose(0, 2, 1),
                                  f32(jpack["m_rest"])[:, :, :R])
    front = bf(port["front_t"]).T if cfg.scalar_input else bf(
        port["front_oh"]).reshape(-1, R)
    np.testing.assert_array_equal(front, f32(jpack["front"]))
    # w_old [L, R, 2D] = [filter | gate] old taps; port rows 2j+f, old cols
    old = bf(port["w_tap"])[:, :, :R].reshape(-1, D, 2, R)
    np.testing.assert_array_equal(
        old.transpose(0, 3, 2, 1).reshape(-1, R, 2 * D), f32(jpack["w_old"]))


def test_bf16_twin_rounds_activations_not_only_weights():
    """The bf16 twin differs from the f32 twin run on the same bf16-rounded
    weights, and only a little: the activations are rounded too."""
    cfg = port_cfg(TINY)
    params = convert.seeded_params(cfg, 2)
    packed = G.pack_params(cfg, params, BF16)
    weights_only = {k: v.float() if k in G.WEIGHTS else v
                    for k, v in packed.items()}
    lc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 60, 80)).astype(np.float32))
    primed = 0.3 * torch.randn(60, 2, generator=torch.Generator().manual_seed(0))
    proj = G.precompute_lc_proj(packed, lc)
    run = lambda p: G.generate_plain(p, proj, deterministic=True,
                                     primed=primed, prime_len=60)
    a, b = run(packed), run(weights_only)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=0, atol=5e-3)


def test_generator_serves_bf16_on_cuda_and_f32_on_cpu():
    """The default weight type follows the device (bf16 on a GPU, f32 on the
    CPU, as the JAX generator picks the bf16 Pallas kernel on an
    accelerator and the f32 scan sampler on the CPU); an explicit type
    wins, and the CPU runs bf16 through the twin when asked."""
    assert PG.resolve_weight_dtype(torch.device("cuda")) == BF16
    assert PG.resolve_weight_dtype(torch.device("cuda", 0)) == BF16
    assert PG.resolve_weight_dtype(torch.device("cpu")) == torch.float32
    assert PG.resolve_weight_dtype(torch.device("cuda"),
                                   torch.float32) == torch.float32
    cfg = port_full_cfg(TINY)
    params = convert.seeded_params(cfg.wavenet, 0)
    gen = PG.WaveNetGenerator(cfg, params, device="cpu")
    assert gen.weight_dtype == torch.float32
    assert gen.packed["w_skip"].dtype == torch.float32
    gen16 = PG.WaveNetGenerator(cfg, params, device="cpu", weight_dtype=BF16)
    assert gen16.packed["w_skip"].dtype == BF16
    assert gen16.packed["skip_bias"].dtype == torch.float32
    mel = np.random.default_rng(0).standard_normal((4, 80)).astype(np.float32)
    a = gen.generate(mel, deterministic=True)
    b = gen16.generate(mel, deterministic=True)
    assert a.shape == b.shape == (40,) and not np.array_equal(a, b)
    with pytest.raises(ValueError, match="weight_dtype"):
        G.pack_params(cfg.wavenet, params, torch.float16)
