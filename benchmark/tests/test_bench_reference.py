"""The plain reference: the greedy gap's semantics, and the reference held
to the port at float32 on the CPU (the port's plain twin of the
generation kernel, its mixture loss), where the two must agree to
rounding."""
import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import wavenet as ref
from benchmark.tests import tiny


def head(logits, means):
    raw = torch.zeros(1, 30)
    raw[0, :len(logits)] = torch.tensor(logits)
    raw[0, 10:10 + len(means)] = torch.tensor(means)
    raw[0, len(logits):10] = -5.0
    return raw


def test_greedy_gap_is_zero_for_the_reference_choice():
    raw = head([1.0, 0.5], [0.3, -0.2])
    assert ref.greedy_gap(raw, torch.tensor([0.3])).item() == 0.0
    assert ref.greedy_pick(raw).item() == pytest.approx(0.3)


def test_greedy_gap_takes_a_near_tie_and_its_average():
    raw = head([1.0, 0.99], [0.8, 0.4])
    assert ref.greedy_gap(raw, torch.tensor([0.4])).item() == pytest.approx(
        0.01, abs=1e-6)
    assert ref.greedy_gap(raw, torch.tensor([0.6])).item() == pytest.approx(
        0.01, abs=1e-6)


def test_greedy_gap_is_large_for_a_sample_nothing_explains():
    raw = head([1.0, 0.2], [0.8, 0.4])
    assert ref.greedy_gap(raw, torch.tensor([0.3])).item() >= 0.5
    assert ref.greedy_gap(raw, torch.tensor([-0.5])).item() > 0.5


def test_means_are_clipped():
    raw = head([1.0, 0.5], [1.7, -0.2])
    assert ref.greedy_gap(raw, torch.tensor([1.0])).item() == 0.0


def test_reference_is_the_port_twin_at_float32():
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import from_dict
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    conf = tiny.tiny_config("wn_moon")
    w = conf["wavenet"]
    params = weights.wavenet_weights(w, 9, "cpu")
    gen = WaveNetGenerator(from_dict(conf), params, device="cpu",
                           weight_dtype=torch.float32)
    mel = np.random.default_rng(0).standard_normal((3, 80)).astype(
        np.float32)
    wav = torch.from_numpy(gen.generate(mel, deterministic=True))
    lc = ref.upsample(torch.from_numpy(mel)[None], params, w)
    x = torch.cat([torch.zeros(1), wav[:-1]])[None]
    raw = ref.forward(params, w, x, lc, causal=True)[0]
    assert ref.greedy_gap(raw, wav).max().item() < 1e-5
    assert torch.allclose(ref.greedy_pick(raw), wav, atol=1e-5)


def test_mixture_nll_is_the_port_loss():
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.mixture import (
        discretized_mix_logistic_loss)
    g = torch.Generator().manual_seed(0)
    raw = torch.randn(4, 200, 30, generator=g)
    raw[..., 20:] -= 3.0
    y = torch.rand(4, 200, 1, generator=g) * 2 - 1
    y[0, :5, 0] = torch.tensor([-1.0, 1.0, 0.9995, -0.9995, 0.0])
    ours = ref.mol_nll(raw, y[..., 0])
    port = discretized_mix_logistic_loss(raw, y, num_class=2 ** 16,
                                         reduce=False)
    assert torch.allclose(ours, port, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rnd, bits", [(ref.tf32, 10), (ref.fp8, 3)])
def test_rounding_keeps_its_mantissa(rnd, bits):
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    err = ((rnd(x) - x).abs() / x.abs().clamp_min(1e-3)).max().item()
    assert 0 < err <= 2.0 ** -bits
