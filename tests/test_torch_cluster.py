"""PyTorch port: the generation kernel on a thread-block cluster: past one
block's shared memory, each stream's gate channels split over 2, 4 or 8
blocks (the cluster instance); at wn_moon's widths, each stream's skip
product and post1 moved off the chain's block onto its peers (the split).

On the CPU: the kernel's plain twin against the JAX package's Pallas
kernel (interpret mode, f32, deterministic) at R = D = 128, S = 512; the
cluster layout (``cluster_layout``) put back together against the padded
layout; the twin on D padded to a multiple of 8k against the twin on the
caller's D; ``kernel_plan`` (which widths keep one block, how many blocks
R = D = 128 at 50 layers takes, the new ceiling, when wn_moon's widths
take the split and when they fall back to one block); the variants'
names; the ablation builds' substitutions.

On the card (tests marked ``cuda``; they skip without a GPU): the cluster
instance against its twin at R = D = 128 in both weight types, the split
against its twin and the one-block instance at wn_moon's widths, the C
plan against ``kernel_plan``, and ``WaveNetGenerator`` serving R = D =
128.  The
card's machine has no JAX, and tests/conftest.py imports it, so there they
run without the conftest, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cluster.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu_torch import ablate_gen, convert
from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
    AudioConfig, Config, WaveNetConfig)
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)

SOFTMAX = dict(input_type="mulaw-quantize", scalar_input=False)
MOON = WaveNetConfig()                       # wn_moon's architecture
MOON_SOFTMAX = dataclasses.replace(MOON, out_channels=256, **SOFTMAX)
TWICE = dataclasses.replace(MOON, residual_channels=64, dilation_channels=64)
# 4x wn_moon's residual width at its 50 layers: over one block's shared
# memory, served by a cluster.
WIDE = dataclasses.replace(MOON, residual_channels=128, dilation_channels=128)
WIDE_SOFTMAX = dataclasses.replace(WIDE, out_channels=256, **SOFTMAX)
# Over the ceiling even split over 8 blocks (the per-block histories and
# residual biases, 2LR floats, no longer leave room for a weight slot).
OVER = dataclasses.replace(MOON, residual_channels=256, dilation_channels=256)
# The widths at 4 layers, small enough for the Pallas kernel's interpret
# mode and the twin on the CPU.
WIDE_4 = dataclasses.replace(WIDE, dilations=(1, 2, 4, 8),
                             upsample_factor=(2, 5))


def _dims(cfg):
    W = cfg.initial_filter_width if cfg.scalar_input else cfg.filter_width
    C = cfg.out_channels if cfg.scalar_input else cfg.quantization_channels
    return (len(cfg.dilations), cfg.residual_channels, cfg.dilation_channels,
            cfg.skip_channels, C, W)


def test_twin_matches_pallas_kernel_at_r128():
    """Deterministic, free-running 60 steps on 2 streams, f32, R = D = 128,
    S = 512, 4 layers, MoL of 10: the twin within 1e-4 of the Pallas kernel
    run as the JAX tests run it (interpret mode, chunk 32)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tacotron_wavenet_vocoder_korean_tpu.config import (
        WaveNetConfig as JaxWaveNetConfig)
    from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
    from tacotron_wavenet_vocoder_korean_tpu.ops import wavenet_pallas as JP
    from torch_port_util import RNG, jax_params, make_inputs, t

    cfg = JaxWaveNetConfig(**dataclasses.asdict(WIDE_4))
    jp = jax_params(cfg)
    packed = G.pack_params(WIDE_4, convert.params_from_jax(WIDE_4, jp))
    _, mel = make_inputs(B=2, frames=6, seed=4)
    lc = np.asarray(JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                            jnp.asarray(mel)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.pallas_incremental_generate(
            cfg, jp, jnp.asarray(lc), RNG, chunk=32, deterministic=True,
            weight_dtype=jnp.float32))
    got = G.incremental_generate_cuda(WIDE_4, packed, t(lc),
                                      deterministic=True).numpy()
    assert got.shape == want.shape == (2, 60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-3


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_cluster_layout_puts_back_to_the_padded_layout(blocks):
    """Each block's residual columns and skip rows, put back in their
    places, are the padded layout's bit for bit (R = D = 20, padded to 24
    and to a multiple of 8k); the other tensors equal the padded
    layout's."""
    cfg = dataclasses.replace(WIDE_4, residual_channels=20,
                              dilation_channels=20, skip_channels=36)
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 2))
    padded = G.kernel_layout(packed, blocks)
    split = G.cluster_layout(packed, blocks)
    L, R, D = padded["w_res_t"].shape
    S = padded["w_skip"].shape[1]
    Dl = D // blocks
    assert D % (8 * blocks) == 0 and D >= 20 and R == 24 and S == 40
    assert split["w_res_t"].shape == (L, blocks, R, Dl)
    assert split["w_skip"].shape == (blocks, L * Dl, S)
    assert split["w_res_t"].is_contiguous() and split["w_skip"].is_contiguous()
    res = split["w_res_t"].permute(0, 2, 1, 3).reshape(L, R, D)
    skip = (split["w_skip"].view(blocks, L, Dl, S).permute(1, 0, 2, 3)
            .reshape(L * D, S))
    assert torch.equal(res, padded["w_res_t"])
    assert torch.equal(skip, padded["w_skip"])
    for key in padded:
        if key not in ("w_res_t", "w_skip"):
            assert torch.equal(split[key], padded[key]), key
    # The caller's weights sit in the padded layout's corner, zeros around.
    assert torch.equal(padded["w_res_t"][:, :20, :20], packed["w_res_t"])
    assert int(padded["w_res_t"].count_nonzero()) == int(
        packed["w_res_t"].count_nonzero())


def _pad_lc(proj: torch.Tensor, D: int, Dp: int) -> torch.Tensor:
    """[B, T, L*2D] -> [B, T, L*2Dp]: the padded gate channels' lc is 0."""
    B, T, n = proj.shape
    out = proj.new_zeros(B, T, n // (2 * D), 2, Dp)
    out[..., :D] = proj.view(B, T, -1, 2, D)
    return out.view(B, T, -1)


def test_twin_on_d_padded_for_a_cluster_equals_twin():
    """R = D = 12 split over 4 blocks pads D to 32 (a multiple of 8k): the
    twin on that layout, teacher-forced 40 steps, against the twin on the
    caller's layout within 1e-6 (exact zeros, sums grouped otherwise)."""
    cfg = dataclasses.replace(WIDE_4, residual_channels=12,
                              dilation_channels=12, skip_channels=20)
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 3))
    padded = G.kernel_layout(packed, 4)
    assert padded["w_tap"].shape == (4, 2 * 32, 2 * 16)
    gen = torch.Generator().manual_seed(5)
    proj = G.precompute_lc_proj(packed, torch.randn(2, 40, 80, generator=gen))
    primed = 0.3 * torch.randn(40, 2, generator=gen)
    kw = dict(deterministic=True, primed=primed, prime_len=40)
    want = G.generate_plain(packed, proj, **kw)
    got = G.generate_plain(padded, _pad_lc(proj, 12, 32), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float(want.std()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plan(dtype):
    """wn_moon's and 2x its residual width keep one block, with
    ``kernel_smem``'s slots and bytes; R = D = 128 at 50 layers, both
    heads, does not fit one block and takes 4 blocks per stream in both
    weight types: in f32 the fewest whose layout fits (2 leave no room for
    a slot), in bf16 the fewest that fit and leave each chain lane one gate
    channel (D/k = 32; 2 blocks fit with one slot, but measured slower);
    R = D = 256 is refused, naming the bytes at 8 blocks, the 232,448 a
    block may use and the 8-block cluster."""
    wdt = getattr(torch, dtype)
    for cfg in (TWICE, dataclasses.replace(TWICE, out_channels=256,
                                           **SOFTMAX)):
        nbytes, slots = G.kernel_smem(*_dims(cfg), wdt)
        assert slots >= 1
        assert G.kernel_plan(*_dims(cfg), wdt) == (1, slots, nbytes)
    for cfg in (WIDE, WIDE_SOFTMAX):
        blocks, slots, nbytes = G.kernel_plan(*_dims(cfg), wdt)
        assert blocks == 4
        assert slots >= 1 and nbytes <= G.SMEM_LIMIT
        assert (nbytes, slots) == G._block_smem(*_dims(cfg), 4, wdt)
        assert G.kernel_smem(*_dims(cfg), wdt)[1] == 0
        assert (G._block_smem(*_dims(cfg), 2, wdt)[1] > 0) == (
            dtype == "bfloat16")
        assert G.kernel_limits_error(cfg, wdt) is None
    assert G.kernel_plan(*_dims(WIDE), wdt)[1:] == (
        (3, 222_648) if dtype == "bfloat16" else (1, 181_656))
    error = G.kernel_limits_error(OVER, wdt)
    blocks, slots, nbytes = G.kernel_plan(*_dims(OVER), wdt)
    assert (blocks, slots) == (8, 0) and nbytes > G.SMEM_LIMIT
    assert error is not None
    assert f"{nbytes:,} bytes of shared memory" in error
    assert "232,448" in error and "8 blocks" in error


# (widths, streams, clusters of k the card holds, the plan's blocks):
# wn_moon's widths take the split's size whenever the card holds B such
# clusters, else one block; other widths plan as before, whatever the card
# holds.
K = G.SPLIT_SIZE
_SPLIT_CASES = {
    "split": (MOON, 8, None, K),
    "split_softmax": (MOON_SOFTMAX, 1, None, K),
    "split_holds_b": (MOON, 8, {K: 8}, K),
    "falls_back": (MOON, 8, {K: 7}, 1),
    "falls_back_b1": (MOON, 1, {}, 1),
    "any_width": (dataclasses.replace(MOON, residual_channels=24,
                                      dilation_channels=24), 8, {}, 1),
    "d_not_32": (dataclasses.replace(MOON, dilation_channels=24), 1, None,
                 1),
    "wide": (WIDE, 8, {}, 4),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_kernel_plan_takes_the_split(case, dtype):
    """The plan for B streams given how many clusters of each size the card
    holds (``_SPLIT_CASES``): the split's bytes (``_split_smem``, over one
    block's and within the 232,448 a block may use) and the full ring's
    slots; one block with ``kernel_smem``'s slots and bytes; other widths
    as ``kernel_plan`` without a card."""
    wdt = getattr(torch, dtype)
    cfg, B, held, want = _SPLIT_CASES[case]
    clusters = None if held is None else (lambda k: held.get(k, 0))
    dims = _dims(cfg)
    blocks, slots, nbytes = G.kernel_plan(*dims, wdt, B, clusters)
    assert blocks == want
    if cfg.residual_channels != 32 or cfg.dilation_channels != 32:
        assert (blocks, slots, nbytes) == G.kernel_plan(*dims, wdt)
    elif blocks == 1:
        assert (nbytes, slots) == G.kernel_smem(*dims, wdt)
    else:
        assert slots == G.kernel_smem(*dims, wdt)[1] == (
            8 if dtype == "bfloat16" else 4)
        assert nbytes == G._split_smem(*dims[:1], *dims[3:], blocks, wdt)
        assert G.kernel_smem(*dims, wdt)[0] < nbytes <= G.SMEM_LIMIT


def test_split_sizes_fit_wn_moon():
    """Every size ``ablate_gen --split`` times takes wn_moon's widths in both
    weight types and every peer a chunk of S; a stream of S = 24 has only
    3 chunks of 8, so 5 blocks and more do not take it."""
    assert G.SPLIT_SIZE in ablate_gen.SPLIT_SWEEP
    for wdt in G.WEIGHT_DTYPES:
        for k in ablate_gen.SPLIT_SWEEP:
            assert G._split_smem(50, 512, 30, 32, k, wdt) > 0, (k, wdt)
        assert G._split_smem(50, 24, 30, 32, 4, wdt) > 0
        assert G._split_smem(50, 24, 30, 32, 5, wdt) == 0
        assert G._split_smem(50, 512, 30, 32, 1, wdt) == 0


@pytest.mark.parametrize("case", ["split", "split_softmax_f32", "one_block",
                                  "cluster", "two_layers"])
def test_split_variant_is_named_apart(case):
    """The split's launches count under their own variant, distinct from
    the one-block instance's and the cluster instance's at every head and
    weight type."""
    mol16 = G.pack_params(MOON, convert.seeded_params(MOON, 0),
                          torch.bfloat16)
    cases = {
        "split": (mol16, None, "mol-bfloat16-split"),
        "split_softmax_f32": (
            G.pack_params(MOON_SOFTMAX, convert.seeded_params(MOON_SOFTMAX,
                                                              0)),
            4, "softmax-float32-split"),
        "one_block": (mol16, 1, "mol-bfloat16"),
        "cluster": (G.pack_params(WIDE, convert.seeded_params(WIDE, 0)), None,
                    "mol-float32-cluster"),
        "two_layers": (G.pack_params(dataclasses.replace(WIDE,
                                                         dilations=(1, 2)),
                                     convert.seeded_params(WIDE, 0)), 2,
                       "mol-float32-cluster"),
    }
    packed, blocks, want = cases[case]
    assert G.kernel_variant(packed, blocks) == want
    names = {f"{h}-{d}{s}" for h in ("mol", "softmax")
             for d in ("float32", "bfloat16")
             for s in ("", "-split", "-cluster")}
    assert len(names) == 12 and want in names


@pytest.mark.parametrize("name", sorted({**ablate_gen.VARIANTS,
                                         **ablate_gen.CLUSTER_VARIANTS,
                                         **ablate_gen.SPLIT_VARIANTS}))
def test_ablation_sources_apply(name):
    """Every ablated build's substitutions match the kernel source once
    (``ablate_gen`` raises before anything is timed otherwise), and each
    variant but the unchanged ones differs from its source."""
    src = ablate_gen.variant_source(name)
    path, subs = {**ablate_gen.VARIANTS, **ablate_gen.CLUSTER_VARIANTS,
                  **ablate_gen.SPLIT_VARIANTS}[name]
    assert (src == open(path, encoding="utf-8").read()) == (not subs)


def test_cluster_variant_is_named_apart():
    """The cluster instance's launches count under their own variant."""
    cfg = dataclasses.replace(WIDE, dilations=(1, 2))
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 0),
                           torch.bfloat16)
    assert G.kernel_variant(packed) == "mol-bfloat16"      # 2 layers fit
    assert G.kernel_variant(packed, 2) == "mol-bfloat16-cluster"
    wide = G.pack_params(WIDE, convert.seeded_params(WIDE, 0))
    assert G.kernel_variant(wide) == "mol-float32-cluster"


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _inputs(cfg, dev, weight_dtype, B=2, T=128, seed=0):
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 1, dev),
                           weight_dtype)
    gen = torch.Generator(dev).manual_seed(seed)
    proj = G.precompute_lc_proj(
        packed, torch.randn(B, T, 80, generator=gen, device=dev))
    n = cfg.out_channels
    primed = (torch.randint(0, n, (T, B), generator=gen, device=dev).float()
              if not cfg.scalar_input else
              0.3 * torch.randn(T, B, generator=gen, device=dev))
    return packed, proj, primed


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mol", "softmax"])
def test_cuda_cluster_f32_matches_twin(name):
    """R = D = 128 at 50 layers, f32 (4 blocks per stream), 2 streams:
    teacher-forced 128 steps within 1e-4 (MoL) or 99.9% of the classes
    equal (softmax), free-running 64 steps within 1e-3 (the same
    classes); one launch, counted under the cluster variant."""
    dev = _cuda()
    cfg = WIDE if name == "mol" else WIDE_SOFTMAX
    packed, proj, primed = _inputs(cfg, dev, torch.float32)
    kw = dict(deterministic=True, primed=primed, prime_len=proj.shape[1])
    variant = f"{name}-float32-cluster"
    before = G.wavenet_generate.variant_launches[variant]
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.variant_launches[variant] == before + 1
    want = G.generate_plain(packed, proj, **kw)
    free = proj[:, :64].contiguous()
    got_free = G.wavenet_generate(packed, free, deterministic=True)
    want_free = G.generate_plain(packed, free, deterministic=True)
    if cfg.scalar_input:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(got_free, want_free, rtol=0, atol=1e-3)
        assert float(want_free.std()) > 0
    else:
        assert float((got == want).float().mean()) >= 0.999
        assert torch.equal(got_free, want_free)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [4, 8])
def test_cuda_cluster_sizes_agree(blocks):
    """f32 R = D = 128 forced to each cluster size its layout fits (4 and
    8 blocks): teacher-forced 64 steps within 1e-4 of the twin, one launch
    under the cluster variant."""
    dev = _cuda()
    packed, proj, primed = _inputs(WIDE, dev, torch.float32, T=64)
    kw = dict(deterministic=True, primed=primed, prime_len=64)
    before = G.wavenet_generate.variant_launches["mol-float32-cluster"]
    got = G._generate(packed, proj, blocks=blocks, **kw)
    assert G.wavenet_generate.variant_launches["mol-float32-cluster"] == \
        before + 1
    want = G.generate_plain(packed, proj, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="blocks per stream"):
        G._generate(packed, proj, blocks=2, **kw)    # no f32 slot at 2


@pytest.mark.cuda
def test_cuda_cluster_bf16_within_noise():
    """bf16, R = D = 128 (4 blocks per stream), teacher-forced 256 steps on
    4 streams, held as chip_smoke.py's compare_bf16 holds the widths: the
    mean error and the share of component flips (> 1e-2) at most twice
    the bf16 twin's own distance from the f32 kernel."""
    dev = _cuda()
    packed, proj, primed = _inputs(WIDE, dev, torch.bfloat16, B=4, T=256)
    kw = dict(deterministic=True, primed=primed, prime_len=256)
    k16 = G.wavenet_generate(packed, proj, **kw)
    t16 = G.generate_plain(packed, proj, **kw)
    packed32 = G.pack_params(WIDE, convert.seeded_params(WIDE, 1, dev))
    k32 = G.wavenet_generate(packed32, proj, **kw)
    assert bool(torch.isfinite(k16).all())
    e_kt, e_tf = (k16 - t16).abs(), (t16 - k32).abs()
    assert float(e_kt.mean()) <= 2 * float(e_tf.mean())
    flips = lambda e: float((e > 1e-2).float().mean())
    assert flips(e_kt) <= 2 * flips(e_tf)


@pytest.mark.cuda
def test_cuda_plan_matches_python():
    """The library's plan (blocks, slots, bytes per block) equals
    ``kernel_plan``'s, given the clusters of the split the card holds, at
    wn_moon's widths (both heads), 2x, R = D = 128 (both heads), over the
    ceiling and at every R = D from 8 to 256 in steps of 24 at 50 layers,
    both weight types, for 1, 8, 64 and 1,000 streams: wn_moon's widths
    take the split at B = 1 and 8 and one block at 64 and 1,000 (the card
    holds 15 clusters of the split)."""
    import ctypes

    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.build import (
        load_library)
    _cuda()
    fn = load_library("wavenet_gen").wavenet_gen_plan
    fn.restype = ctypes.c_int
    cfgs = [MOON, MOON_SOFTMAX, TWICE, WIDE, WIDE_SOFTMAX, OVER] + [
        dataclasses.replace(MOON, residual_channels=n, dilation_channels=n)
        for n in range(8, 257, 24)]
    for c in cfgs:
        L, R, D, S, C, W = _dims(c)
        for wdt in G.WEIGHT_DTYPES:
            bf16 = wdt == torch.bfloat16
            held = lambda k: G._card_clusters(L, S, C, W, k, bf16)
            for B in (1, 8, 64, 1000):
                blocks, slots = ctypes.c_int(), ctypes.c_int()
                nbytes = fn(L, R, D, S, C, W, int(bf16), B,
                            ctypes.byref(blocks), ctypes.byref(slots))
                want = G.kernel_plan(L, R, D, S, C, W, wdt, B, held)
                assert (blocks.value, slots.value, nbytes) == want, (
                    c.residual_channels, wdt, B)
                if c in (MOON, MOON_SOFTMAX):
                    assert want[0] == (K if B <= 8 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", ["bfloat16", "float32"])
def test_cuda_generator_serves_r128(weight_dtype):
    """``WaveNetGenerator`` on the card serves R = D = 128 at 50 layers:
    one launch of the cluster variant for a 4-frame mel, finite samples in
    [-1, 1]; R = D = 256 raises at construction with nothing allocated."""
    dev = _cuda()
    wdt = getattr(torch, weight_dtype)
    cfg = Config(audio=AudioConfig(hop_size=300), wavenet=WIDE)
    gen = WaveNetGenerator(cfg, convert.seeded_params(WIDE, 0),
                           device="cuda", weight_dtype=wdt)
    mel = np.random.default_rng(0).standard_normal((4, 80)).astype(
        np.float32)
    variant = f"mol-{weight_dtype}-cluster"
    before = G.wavenet_generate.variant_launches[variant]
    wav = gen.generate(mel)
    assert G.wavenet_generate.variant_launches[variant] == before + 1
    assert wav.shape == (4 * 300,) and np.isfinite(wav).all()
    assert np.abs(wav).max() <= 1.0
    params = convert.seeded_params(OVER, 0)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    with pytest.raises(ValueError, match="232,448 bytes"):
        WaveNetGenerator(Config(wavenet=OVER), params, device="cuda",
                         weight_dtype=wdt)
    assert torch.cuda.memory_allocated(dev) == allocated


def _split_inputs(cfg, dev, weight_dtype, B=2, T=128):
    packed, proj, primed = _inputs(cfg, dev, weight_dtype, B=B, T=T)
    return packed, proj, dict(deterministic=True, primed=primed,
                              prime_len=T)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mol", "softmax"])
def test_cuda_split_f32_matches_twin(name):
    """wn_moon's widths (R = D = 32, 50 layers, S = 512), f32, 2 streams,
    on the plan's split: teacher-forced 128 steps within 1e-4 of the twin
    (MoL, as the one-block f32 tests) or 99.9% of the classes equal
    (softmax), free-running 64 steps within 1e-4 (the same classes); one
    launch, counted under the split variant."""
    dev = _cuda()
    cfg = MOON if name == "mol" else MOON_SOFTMAX
    packed, proj, kw = _split_inputs(cfg, dev, torch.float32)
    variant = f"{name}-float32-split"
    assert G.kernel_variant(packed) == variant
    before = G.wavenet_generate.variant_launches[variant]
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.variant_launches[variant] == before + 1
    want = G.generate_plain(packed, proj, **kw)
    free = proj[:, :64].contiguous()
    got_free = G.wavenet_generate(packed, free, deterministic=True)
    want_free = G.generate_plain(packed, free, deterministic=True)
    if cfg.scalar_input:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(got_free, want_free, rtol=0, atol=1e-4)
        assert float(want_free.std()) > 0
    else:
        assert float((got == want).float().mean()) >= 0.999
        assert torch.equal(got_free, want_free)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [G.SPLIT_SIZE])
def test_cuda_split_sizes_agree(blocks):
    """wn_moon's widths, f32, forced to the split's size:
    teacher-forced 64 steps on 3 streams within 1e-4 of the twin, greedy
    and with noise drawn from Philox (then within 1e-4 of the one-block
    instance's from the same seed)."""
    dev = _cuda()
    packed, proj, kw = _split_inputs(MOON, dev, torch.float32, B=3, T=64)
    got = G._generate(packed, proj, blocks=blocks, **kw)
    want = G.generate_plain(packed, proj, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    draw = lambda k: G._generate(
        packed, proj, generator=torch.Generator(dev).manual_seed(3),
        primed=kw["primed"], prime_len=64, blocks=k)
    torch.testing.assert_close(draw(blocks), draw(1), rtol=0, atol=1e-4)


def _bf16_within_noise(name, blocks):
    """bf16 at wn_moon's widths on ``blocks`` blocks a stream (None: the
    plan's), teacher-forced 256 steps on 4 streams, held as chip_smoke.py's
    compare_bf16 holds the widths: MoL's mean error and share of flips (>
    1e-2) at most twice the bf16 twin's own distance from the f32 kernel
    on as many blocks; softmax classes differing at most twice as often as
    the twin's from the f32 kernel's."""
    dev = _cuda()
    cfg = MOON if name == "mol" else MOON_SOFTMAX
    packed, proj, kw = _split_inputs(cfg, dev, torch.bfloat16, B=4, T=256)
    variant = f"{name}-bfloat16{'' if blocks == 1 else '-split'}"
    before = G.wavenet_generate.variant_launches[variant]
    k16 = G._generate(packed, proj, blocks=blocks, **kw)
    assert G.wavenet_generate.variant_launches[variant] == before + 1
    t16 = G.generate_plain(packed, proj, **kw)
    packed32 = G.pack_params(cfg, convert.seeded_params(cfg, 1, dev))
    k32 = G._generate(packed32, proj, blocks=blocks, **kw)
    assert bool(torch.isfinite(k16).all())
    if cfg.scalar_input:
        e_kt, e_tf = (k16 - t16).abs(), (t16 - k32).abs()
        assert float(e_kt.mean()) <= 2 * float(e_tf.mean())
        flips = lambda e: float((e > 1e-2).float().mean())
        assert flips(e_kt) <= 2 * flips(e_tf)
    else:
        differ = lambda a, b: float((a != b).float().mean())
        assert differ(k16, t16) <= 2 * max(differ(t16, k32), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mol", "softmax"])
def test_cuda_split_bf16_within_noise(name):
    """The split in bf16, within the noise bounds (``_bf16_within_noise``)."""
    _bf16_within_noise(name, None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mol", "softmax"])
def test_cuda_one_block_bf16_within_noise(name):
    """The one-block instance at wn_moon's widths, the split's fallback, in
    bf16 within the same noise bounds (``_bf16_within_noise``)."""
    _bf16_within_noise(name, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mol", "softmax"])
def test_cuda_split_greedy_matches_one_block(name):
    """Greedy (deterministic), free-running 256 steps on 2 streams at
    wn_moon's widths, f32: the split and the one-block instance give the
    same classes (softmax) or samples within 1e-4 (MoL: post1's sums in
    another order)."""
    dev = _cuda()
    cfg = MOON if name == "mol" else MOON_SOFTMAX
    packed, proj, _ = _split_inputs(cfg, dev, torch.float32, T=256)
    split = G.wavenet_generate(packed, proj, deterministic=True)
    one = G._generate(packed, proj, deterministic=True, blocks=1)
    if cfg.scalar_input:
        torch.testing.assert_close(split, one, rtol=0, atol=1e-4)
        assert float(one.std()) > 0
    else:
        assert torch.equal(split, one)


@pytest.mark.cuda
def test_cuda_split_falls_back_to_one_block(monkeypatch):
    """When the card holds fewer clusters than B (the query patched to
    none), the plan launches the one-block instance: named so by
    ``kernel_variant`` and counted under its own variant, and equal to the split's samples within 1e-4 (f32,
    teacher-forced 128 steps, Philox noise from one seed)."""
    dev = _cuda()
    packed, proj, kw = _split_inputs(MOON, dev, torch.float32)
    kw = dict(kw, deterministic=False)
    seeded = lambda: torch.Generator(dev).manual_seed(11)
    split = G.wavenet_generate(packed, proj, generator=seeded(), **kw)
    assert G.kernel_variant(packed) == "mol-float32-split"
    monkeypatch.setattr(G, "_card_clusters", lambda *a: 0)
    assert G.kernel_variant(packed) == "mol-float32"
    counts = G.wavenet_generate.variant_launches
    before = counts["mol-float32"], counts["mol-float32-split"]
    one = G.wavenet_generate(packed, proj, generator=seeded(), **kw)
    assert (counts["mol-float32"], counts["mol-float32-split"]) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(split, one, rtol=0, atol=1e-4)
    assert float(one.std()) > 0
