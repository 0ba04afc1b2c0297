"""The work counts against ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference at a tiny width.

What the counter sees is the matrix products and convolutions, and so do
the counts: neither counts the elementwise work (tanh, sigmoid, the bias
adds, the residual sums, the ReLUs, the mixture head's arithmetic), which
is under 1% of a step at wn_moon's widths."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import weights, work
from benchmark.reference import wavenet as ref
from benchmark.tests import tiny


def tiny_w():
    return tiny.tiny_config("wn_moon")["wavenet"]


def counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("frames", [1, 3])
def test_mel_to_wav_count_matches_the_counter(frames):
    w = tiny_w()
    hop = 300
    p = weights.wavenet_weights(w, 0, "cpu")
    mel = torch.randn(1, frames, w["local_condition_channels"])
    x = torch.zeros(1, frames * hop)

    def fn():
        lc = ref.upsample(mel, p, w)
        ref.forward(p, w, x, lc, causal=True)
    assert counted(fn) == work.mel_to_wav_flops(w, [frames], hop)


def test_upsampler_count_matches_the_counter():
    w = tiny_w()
    p = weights.wavenet_weights(w, 0, "cpu")
    mel = torch.randn(2, 5, w["local_condition_channels"])
    assert counted(lambda: ref.upsample(mel, p, w)) == 2 * work.upsample_flops(
        w, 5)


def test_per_sample_count_at_wn_moon():
    """3.22 MFLOP a sample at wn_moon's widths (the predicted figure)."""
    w = tiny.harness.load_config("wn_moon")["wavenet"]
    assert work.wavenet_sample_flops(w) == 2048 + 50 * 53248 + 2 * (
        512 * 512 + 512 * 30)


def test_train_step_is_three_forwards_of_the_batch():
    w = tiny_w()
    hop = 300
    per = work.wavenet_sample_flops(w) + work.upsample_flops(w, 1) / hop
    assert work.train_step_flops(w, 2, 1200, hop) == pytest.approx(
        3 * 2 * 1200 * per)


def test_roofline_names_its_bound():
    t, bound = work.least_time(989e12, 1.0, "bfloat16")
    assert (t, bound) == (1.0, "operations")
    t, bound = work.least_time(1.0, 3.35e12, "float32")
    assert (t, bound) == (1.0, "bytes")


def test_weight_count_matches_the_made_weights():
    w = tiny_w()
    p = weights.wavenet_weights(w, 0, "cpu")
    assert work.wavenet_weight_count(w) == sum(v.numel() for v in p.values())
