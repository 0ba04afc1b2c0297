"""PyTorch port: the CUDA generation kernel against its plain twin on the
card (tests marked ``cuda``; they skip without a GPU), the Tacotron decode
and a Tacotron training step on the card against the same on the CPU
(also with each attention mechanism and simple speakers), WaveNet's
tensor-parallel step on two ranks sharing the card, and the twin at
wn_moon's widths (R = D = 32) against the JAX scan sampler where JAX is
installed.

The card's machine has no JAX, and tests/conftest.py imports it, so there
the card tests run without the conftest, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import dataclasses

import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
    BOTH_R2, AudioConfig, Config, WaveNetConfig)
from tacotron_wavenet_vocoder_korean_tpu_torch.models.attention import (
    ATTENTION_TYPES)
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
    Synthesizer)

# wn_moon's widths (R = D = 32, W = 32), cut to 6 layers and S = 64; and
# the same stack with the softmax head (W = 2, Q = 256).  Other widths:
# tests/test_torch_widths.py.
CARD = WaveNetConfig(dilations=(1, 2, 4, 1, 2, 4), skip_channels=64,
                     upsample_factor=(2, 5))
CARD_Q = dataclasses.replace(CARD, input_type="mulaw-quantize",
                             scalar_input=False, out_channels=256)


def _card_inputs(dev, B=3, T=300, seed=0, cfg=CARD,
                 weight_dtype=torch.float32):
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 1, dev),
                           weight_dtype)
    gen = torch.Generator(dev).manual_seed(seed)
    proj = G.precompute_lc_proj(
        packed, torch.randn(B, T, 80, generator=gen, device=dev))
    return packed, proj, gen


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deterministic", "noise", "primed"])
def test_cuda_kernel_matches_plain_twin(mode):
    """3 streams x 300 steps: <= 1e-4 (f32 sums in another order; no
    near-tie flip is expected at this size)."""
    dev = _cuda()
    packed, proj, gen = _card_inputs(dev)
    T, B = proj.shape[1], proj.shape[0]
    kw = {"deterministic": mode == "deterministic"}
    if mode != "deterministic":
        kw["noise"] = torch.rand(T, B, 11, generator=gen, device=dev)
    if mode == "primed":
        kw["primed"] = 0.3 * torch.randn(T, B, generator=gen, device=dev)
        kw["prime_len"] = 120
    before = G.wavenet_generate.launches
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.launches == before + 1
    want = G.generate_plain(packed, proj, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_philox_is_seeded_and_in_range():
    dev = _cuda()
    packed, proj, _ = _card_inputs(dev, B=2, T=400)
    run = lambda s: G.wavenet_generate(
        packed, proj, generator=torch.Generator(dev).manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0 and float(a.std()) > 0
    assert not torch.equal(a[0], a[1])           # streams draw apart


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs():
    dev = _cuda()
    packed, proj, _ = _card_inputs(dev, B=1, T=10)
    before = G.wavenet_generate.launches
    with pytest.raises(TypeError):
        G.wavenet_generate(packed, proj.double(), deterministic=True)
    with pytest.raises(ValueError):
        G.wavenet_generate(packed, proj[:, :, :-64], deterministic=True)
    with pytest.raises(ValueError):
        G.wavenet_generate(packed, proj[:, ::2], deterministic=True)
    assert G.wavenet_generate.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deterministic", "noise", "primed"])
def test_cuda_softmax_head_matches_plain_twin(mode):
    """Softmax head, f32 weights, 3 streams x 300 steps, free-running (or
    primed for 120 steps), temperature 0.7 with noise: the same classes
    (sums in another order move a score by ~1e-7; no near-tie flip is
    expected at this size)."""
    dev = _cuda()
    packed, proj, gen = _card_inputs(dev, cfg=CARD_Q)
    T, B = proj.shape[1], proj.shape[0]
    kw = {"deterministic": mode == "deterministic", "temperature": 0.7}
    if mode != "deterministic":
        kw["noise"] = torch.rand(T, B, 256, generator=gen, device=dev)
    if mode == "primed":
        kw["primed"] = torch.randint(0, 256, (T, B), generator=gen,
                                     device=dev).float()
        kw["prime_len"] = 120
    before = G.wavenet_generate.launches
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.launches == before + 1
    want = G.generate_plain(packed, proj, **kw)
    assert torch.equal(got, want), (got != want).float().mean()
    assert len(torch.unique(got)) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deterministic", "noise"])
@pytest.mark.parametrize("head", ["mol", "softmax"])
def test_cuda_bf16_kernel_matches_bf16_twin(head, mode):
    """bf16 weights, teacher-forced 300 steps (so a flip does not compound):
    MoL within 1e-3 per step, softmax classes 99% equal.  Both sides round
    every activation to bf16 and sum in f32; a sum taken in another order
    can land an activation on the other side of a bf16 rounding step, which
    moves the logits by ~1e-3 relative and may flip a near-tie."""
    dev = _cuda()
    cfg = CARD if head == "mol" else CARD_Q
    packed, proj, gen = _card_inputs(dev, cfg=cfg,
                                     weight_dtype=torch.bfloat16)
    T, B = proj.shape[1], proj.shape[0]
    n = 11 if head == "mol" else 256
    kw = {"deterministic": mode == "deterministic", "prime_len": T}
    if mode == "noise":
        kw["noise"] = torch.rand(T, B, n, generator=gen, device=dev)
    kw["primed"] = (0.3 * torch.randn(T, B, generator=gen, device=dev)
                    if head == "mol" else
                    torch.randint(0, 256, (T, B), generator=gen,
                                  device=dev).float())
    got = G.wavenet_generate(packed, proj, **kw)
    want = G.generate_plain(packed, proj, **kw)
    if head == "mol":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert (got == want).float().mean() >= 0.99


@pytest.mark.cuda
def test_cuda_softmax_philox_is_seeded_and_in_range():
    dev = _cuda()
    packed, proj, _ = _card_inputs(dev, B=2, T=400, cfg=CARD_Q)
    run = lambda s: G.wavenet_generate(
        packed, proj, generator=torch.Generator(dev).manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a.round()) and a.min() >= 0 and a.max() < 256
    assert not torch.equal(a[0], a[1])           # streams draw apart
    with pytest.raises(ValueError, match="temperature"):
        G.wavenet_generate(packed, proj, deterministic=True, temperature=0)


@pytest.mark.cuda
def test_cuda_generator_refuses_kernel_widths_before_moving_weights():
    """R = D = 256 at wn_moon's 50 layers on the card, whose layout exceeds
    a block's shared memory even with one weight slot and the gate
    channels split over an 8-block cluster: ValueError naming the bytes at
    construction, in both weight types, with nothing allocated on the
    card."""
    dev = _cuda()
    wide = WaveNetConfig(residual_channels=256, dilation_channels=256)
    params = convert.seeded_params(wide, 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    for weight_dtype in G.WEIGHT_DTYPES:
        with pytest.raises(ValueError, match="232,448 bytes"):
            WaveNetGenerator(Config(wavenet=wide), params, device="cuda",
                             weight_dtype=weight_dtype)
    assert torch.cuda.memory_allocated(dev) == before


@pytest.mark.cuda
def test_cuda_speaker_id_out_of_range_leaves_the_card_working():
    """An id equal to num_speakers raises IndexError on the host; the next
    generation on the same card succeeds."""
    _cuda()
    cfg = dataclasses.replace(CARD, num_speakers=2, gc_channels=4)
    gen = WaveNetGenerator(Config(audio=AudioConfig(hop_size=10),
                                  wavenet=cfg),
                           convert.seeded_params(cfg, 0), device="cuda")
    mel = np.random.default_rng(0).standard_normal((4, 80)).astype(
        np.float32)
    with pytest.raises(IndexError):
        gen.generate(mel, speaker_id=2)
    wav = gen.generate(mel, speaker_id=-1)
    torch.cuda.synchronize()
    assert wav.shape == (40,) and np.isfinite(wav).all()


# both_r2 widths, f32, no prenet dropout: a deterministic decode.
TACO_F32 = Config(tacotron=dataclasses.replace(
    BOTH_R2, compute_dtype="float32", dec_prenet_dropout_inference=False,
    max_iters=60))
TEXTS = ["존경하는 국민 여러분", "KIA 3대가 12시에 왔다"]


# The other mechanisms, and bah_mon_norm with simple speakers (deepvoice
# bah_mon_norm: the tests above and below).
OTHER_CONFIGS = tuple(n for n in ATTENTION_TYPES if n != "bah_mon_norm") + (
    "simple",)


def _taco_config(name: str, **kw) -> Config:
    """both_r2 widths, f32, dropout off, with ``name``'s mechanism; for
    ``simple``, bah_mon_norm with simple speakers."""
    t = dataclasses.replace(BOTH_R2, compute_dtype="float32",
                            dec_prenet_dropout_inference=False, **kw)
    t = (dataclasses.replace(t, model_type="simple") if name == "simple"
         else dataclasses.replace(t, attention_type=name))
    return Config(tacotron=t)


def _taco_batch():
    """B = 2, T_in 16, T_out 50."""
    rng = np.random.RandomState(0)
    return {"inputs": rng.randint(2, 70, (2, 16)),
            "input_lengths": np.array([16, 11]),
            "loss_coeff": np.ones(2, np.float32),
            "mel_targets": rng.randn(2, 50, 80),
            "linear_targets": rng.randn(2, 50, 1025),
            "speaker_id": np.array([0, 1])}


@pytest.mark.cuda
def test_cuda_tacotron_f32_decode_matches_cpu():
    """2 texts x 60 steps at the both_r2 widths, f32, TF32 left at torch's
    defaults (the Synthesizer holds it off): mel, linear and alignments
    within 1e-4 of the CPU's (sums in another order; the decoder contracts
    such differences)."""
    _cuda()
    params = convert.seeded_tacotron_params(TACO_F32.tacotron, 0)
    out = {d: Synthesizer(TACO_F32, params, device=d).synthesize(
        TEXTS, speaker_ids=[0, 1], attention_trim=False)
        for d in ("cuda", "cpu")}
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert card["mel"].shape == (300, 80)
        for key in ("mel", "linear", "alignment"):
            np.testing.assert_allclose(card[key], cpu[key], rtol=0,
                                       atol=1e-4, err_msg=key)


@pytest.mark.cuda
def test_cuda_tacotron_speaker_id_out_of_range_raises_on_the_host():
    """Speaker id 2 of 2 raises IndexError before any launch; the card
    decodes after it, and -1 is the last speaker."""
    _cuda()
    synth = Synthesizer(TACO_F32, convert.seeded_tacotron_params(
        TACO_F32.tacotron, 0), device="cuda")
    with pytest.raises(IndexError):
        synth.synthesize(TEXTS[:1], speaker_ids=[2], max_iters=4)
    a = synth.synthesize(TEXTS[:1], speaker_ids=[-1], max_iters=4,
                         attention_trim=False)[0]["mel"]
    b = synth.synthesize(TEXTS[:1], speaker_ids=[1], max_iters=4,
                         attention_trim=False)[0]["mel"]
    assert a.shape == (20, 80) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_tacotron_train_step_matches_cpu():
    """The gradient step of seeded both_r2 weights (f32, dropout off, B =
    2, T_in 16, T_out 50) on the card and on the CPU: the loss within 1e-5
    relative, the whole gradient within 1e-5 relative in the L2 norm (with
    cuDNN's convolutions the card's is hundreds of times farther, which
    is why the task runs without them: ``chip_smoke.py``), the new running
    variances within 1e-5 of each leaf's largest, the new running means
    within 1e-5 of the largest of them all (a mean is 0.01 times a batch
    mean that may cancel to ~1e-4, below the devices' rounding)."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device)
    _cuda()
    cfg = Config(tacotron=dataclasses.replace(
        BOTH_R2, compute_dtype="float32", dropout_prob=0.0))
    out = {}
    for d in ("cuda", "cpu"):
        task = TacotronTask(cfg, is_randomly_initialized=True, device=d)
        state = task.init_state(0)
        out[d] = task.grads(state.params, state.batch_stats,
                            batch_to_device(_taco_batch(), d, "float16"))
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(l_card["loss"]), float(l_cpu["loss"]),
                               rtol=1e-5)
    diff = sum(float(((g_card[k].cpu() - g) ** 2).sum())
               for k, g in g_cpu.items())
    norm = sum(float((g ** 2).sum()) for g in g_cpu.values())
    assert diff ** 0.5 <= 1e-5 * norm ** 0.5
    means = max(float(v.abs().max()) for k, v in s_cpu.items()
                if k.endswith("running_mean"))
    for k, v in s_cpu.items():
        scale = (means if k.endswith("running_mean")
                 else float(v.abs().max()))
        assert float((s_card[k].cpu() - v).abs().max()) <= 1e-5 * scale, k


@pytest.mark.cuda
def test_cuda_wavenet_tensor_parallel_step_matches_one_process():
    """The WaveNet mesh step at a TINY width (softmax head, weight norm,
    L2, the clip) as (n_data, n_model) = (1, 2) and (2, 1), two gloo
    ranks sharing ``cuda:0``, against the one-process step on the card on
    the same global batch of 4: the metrics within 1e-5 relative, the
    gathered gradient within 3e-6 of each leaf's largest (the CPU test's
    bound, tests/test_torch_mesh.py), the new params within 1e-5 of each
    leaf's largest, the skip kernels held as S / 2 columns under (1, 2)."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
        wavenet_task as PWT)
    from torch_mesh_workers import Ranks, wavenet_step
    dev = _cuda()
    w = dataclasses.replace(
        WaveNetConfig(dilations=(1, 2, 4, 1, 2, 4), residual_channels=8,
                      dilation_channels=8, skip_channels=16,
                      initial_filter_width=8, upsample_factor=(2, 5)),
        input_type="mulaw-quantize", scalar_input=False,
        quantization_channels=16, out_channels=16, weight_normalization=True,
        l2_regularization_strength=0.01, clip_gradients=True, batch_size=4,
        sample_size=100)
    cfg = Config(wavenet=w, audio=AudioConfig(hop_size=10))
    task = PWT.WaveNetTask(cfg, device=dev)
    state = task.init_state(0)
    rng = np.random.RandomState(3)
    batch = {"input_wav": rng.randint(0, 16, (4, 120, 1)).astype(np.float32),
             "local_condition": rng.randn(4, 12, 80).astype(np.float32)}
    b = PWT.batch_to_device(batch, dev)
    _, one = task.grads(state.params, b)
    new, metrics = task.train_step(state, b)
    tree = convert.to_jax_tree(state)
    want = convert.flatten(convert.to_jax_tree(new)["params"])
    for shape in ((1, 2), (2, 1)):
        out = Ranks(wavenet_step, 2, cfg, tree, batch, *shape,
                    "cuda").results()[0]
        assert out["backend"] == "gloo"
        for k, v in metrics.items():
            np.testing.assert_allclose(out["metrics"][k], float(v),
                                       rtol=1e-5, err_msg=f"{shape} {k}")
        for k, g in one.items():
            g = g.cpu().numpy()
            if np.abs(g).max() > 0:
                assert np.abs(out["grads"][k] - g).max() <= \
                    3e-6 * np.abs(g).max(), (shape, k)
        got = convert.flatten(out["tree"]["params"])
        for k, v in want.items():
            assert np.abs(got[k] - v).max() <= 1e-5 * np.abs(v).max(), k
        if shape == (1, 2):
            assert out["shapes"]["layer_0_skip_kernel_v"] == (8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OTHER_CONFIGS)
def test_cuda_attention_decode_matches_cpu(name):
    """Each mechanism (and simple speakers) at the both_r2 widths, f32, 2
    texts x 50 steps, card vs CPU: the alignments within 1e-4 of their
    largest |value|, mel and linear within 1e-4 of the mel's (or 1e-4;
    GMM's alignments are unnormalised), as chip_smoke.py holds them."""
    _cuda()
    cfg = _taco_config(name, max_iters=50)
    params = convert.seeded_tacotron_params(cfg.tacotron, 0)
    out = {d: Synthesizer(cfg, params, device=d).synthesize(
        TEXTS, speaker_ids=[0, 1], attention_trim=False)
        for d in ("cuda", "cpu")}
    for card, cpu in zip(out["cuda"], out["cpu"]):
        assert card["mel"].shape == (250, 80)
        for key in ("mel", "linear", "alignment"):
            ref = cpu["alignment" if key == "alignment" else "mel"]
            np.testing.assert_allclose(
                card[key], cpu[key], rtol=0,
                atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("name", OTHER_CONFIGS)
def test_cuda_attention_gradient_matches_cpu(name):
    """The gradient of seeded weights with each mechanism (and simple
    speakers) at the both_r2 widths, f32, dropout off, B = 2, T_out 50,
    card vs CPU: the loss within 1e-5 relative, the whole gradient within
    1e-5 relative in the L2 norm; gmm's within 2e-2: its gradient at
    this point is ill-conditioned in f32 (the port and JAX, both on a
    CPU, part by ~1e-3: tests/test_torch_attention_train.py)."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device)
    _cuda()
    cfg = _taco_config(name, dropout_prob=0.0)
    out = {}
    for d in ("cuda", "cpu"):
        task = TacotronTask(cfg, is_randomly_initialized=True, device=d)
        state = task.init_state(0)
        out[d] = task.grads(state.params, state.batch_stats,
                            batch_to_device(_taco_batch(), d, "float16"))
    (l_card, g_card, _), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(l_card["loss"]), float(l_cpu["loss"]),
                               rtol=1e-5)
    diff = sum(float(((g_card[k].cpu() - g) ** 2).sum())
               for k, g in g_cpu.items())
    norm = sum(float((g ** 2).sum()) for g in g_cpu.values())
    bound = 2e-2 if name == "gmm" else 1e-5
    assert diff ** 0.5 <= bound * norm ** 0.5


def test_twin_at_kernel_width_matches_jax_scan_sampler():
    """The twin at the widths the kernel takes, against the JAX scan
    sampler on the same seeded weights, deterministic, 200 samples:
    <= 1e-4."""
    jax = pytest.importorskip("jax")
    from tacotron_wavenet_vocoder_korean_tpu.config import (
        WaveNetConfig as JaxWaveNetConfig)
    from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW

    from torch_port_util import nest

    tree = convert.seeded_tree(CARD, 1)
    jp = nest(tree)
    jcfg = JaxWaveNetConfig(**dataclasses.asdict(CARD))
    lc = np.random.default_rng(2).standard_normal((2, 200, 80)).astype(
        np.float32)
    want = np.asarray(JW.incremental_generate(
        jcfg, jp, jax.numpy.asarray(lc), jax.random.PRNGKey(0),
        deterministic=True))
    packed = G.pack_params(CARD, convert.params_from_jax(CARD, tree))
    got = G.incremental_generate_cuda(CARD, packed, torch.from_numpy(lc),
                                      deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-4


def test_softmax_twin_at_kernel_width_matches_jax_scan_sampler():
    """The softmax head's twin at the widths the kernel takes (R = D = 32,
    Q = 256), against the JAX scan sampler on the same seeded weights,
    deterministic, 200 steps: the same classes."""
    jax = pytest.importorskip("jax")
    from tacotron_wavenet_vocoder_korean_tpu.config import (
        WaveNetConfig as JaxWaveNetConfig)
    from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW

    from torch_port_util import nest

    tree = convert.seeded_tree(CARD_Q, 1)
    jcfg = JaxWaveNetConfig(**dataclasses.asdict(CARD_Q))
    lc = np.random.default_rng(2).standard_normal((2, 200, 80)).astype(
        np.float32)
    want = np.asarray(JW.incremental_generate(
        jcfg, nest(tree), jax.numpy.asarray(lc), jax.random.PRNGKey(0),
        deterministic=True))
    packed = G.pack_params(CARD_Q, convert.params_from_jax(CARD_Q, tree))
    got = G.incremental_generate_cuda(CARD_Q, packed, torch.from_numpy(lc),
                                      deterministic=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1
