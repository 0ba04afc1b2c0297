"""PyTorch port: the trained serving classes loaded from the committed
checkpoints by the port's own reader, against the JAX package's loaders
(``WaveNetGenerator.load``, ``Synthesizer.load``) on the same run dirs.

The JAX loaders build a template train state to restore into with an eager
flax init, one compiled program per op (about 90 s on a CPU); Orbax reads
only the template's shapes and dtypes.  The tests let both tasks build it
from their own ``abstract_state`` (``jax.eval_shape``) instead, so every
array still comes from the JAX package's restore.  Tolerances are stated
per test.
"""
import dataclasses
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.models.tacotron import (
    Tacotron as JTacotron)
from tacotron_wavenet_vocoder_korean_tpu.synth.generator import (
    WaveNetGenerator as JaxWaveNetGenerator)
from tacotron_wavenet_vocoder_korean_tpu.synth.synthesizer import (
    Synthesizer as JaxSynthesizer)
from tacotron_wavenet_vocoder_korean_tpu.train.tacotron_task import (
    TacotronTask)
from tacotron_wavenet_vocoder_korean_tpu.train.wavenet_task import (
    WaveNetTask)
from tacotron_wavenet_vocoder_korean_tpu_torch import convert, generate
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.models.tacotron import Tacotron
from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
    incremental_generate_cuda)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
    Synthesizer)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointReader)
from torch_port_util import RNG, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARBALL = {name: os.path.join(REPO, "artifacts", f"{name}.ckpt.tar.gz")
           for name in ("wn_moon", "both_r2")}
STEP = {"wn_moon": 260250, "both_r2": 106000}
E2E = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon")
TEXT0 = "존경하는 국민 여러분, 안녕하십니까."


@pytest.fixture(scope="session")
def run_dirs(tmp_path_factory):
    """Both tarballs, unpacked once: name -> run dir."""
    out = {}
    for name, path in TARBALL.items():
        d = tmp_path_factory.mktemp(name)
        with tarfile.open(path) as tar:
            tar.extractall(d, filter="data")
        out[name] = str(d)
    return out


def _load_with_skeleton(task_cls, load):
    """Run a JAX loader with ``task_cls.init_state`` returning host zeros
    shaped as the task's ``abstract_state``."""
    def init_state(self, rng, batch):
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            self.abstract_state(rng, batch))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(task_cls, "init_state", init_state)
        return load()


# ---------------------------------------------------------------------------
# (d) WaveNetGenerator from the wn_moon checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_wn_moon(run_dirs):
    return _load_with_skeleton(
        WaveNetTask, lambda: JaxWaveNetGenerator().load(run_dirs["wn_moon"]))


def test_generator_from_the_tarball_equals_the_jax_generator(jax_wn_moon):
    """The same folded EMA params as JAX WaveNetGenerator.load, exactly;
    256 teacher-forced samples of the committed mel and wav: the plain
    twin against the JAX scan sampler, <= 1e-4 (the tolerance of
    tests/test_torch_generator.py)."""
    gen = WaveNetGenerator.from_checkpoint(TARBALL["wn_moon"], device="cpu")
    assert gen.step == jax_wn_moon.step == STEP["wn_moon"]
    port_cfg = dataclasses.asdict(gen.cfg.wavenet)
    assert port_cfg == {k: getattr(jax_wn_moon.cfg.wavenet, k)
                        for k in port_cfg}
    want = convert.flatten(jax.tree.map(np.asarray, jax_wn_moon.params))
    assert set(want) == set(gen.params)
    for k, v in want.items():
        assert np.array_equal(gen.params[k].numpy(), v), k
    jcfg = jax_wn_moon.cfg.wavenet
    hop = jax_wn_moon.cfg.audio.hop_size
    T, first = 256, 60
    mel = np.load(os.path.join(E2E, "0.mel.npy"))[None, first:first + 1]
    wav = load_wav(os.path.join(E2E, "0.wavenet.wav"), 24000)
    seed = wav[first * hop:first * hop + T][None, :, None]
    lc = np.asarray(JW.Upsampler(jcfg).apply(
        {"params": jax_wn_moon.params["upsampler"]},
        jnp.asarray(mel)))[:, :T]
    want = np.asarray(JW.incremental_generate(
        jcfg, jax_wn_moon.params, jnp.asarray(lc), RNG,
        seed_audio=jnp.asarray(seed), deterministic=True))
    got = incremental_generate_cuda(gen.cfg.wavenet, gen.packed, t(lc),
                                    seed_audio=t(seed),
                                    deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-3


def test_generator_no_ema_serves_params_and_the_cli_loads_a_tarball(
        run_dirs, tmp_path):
    raw = WaveNetGenerator.from_checkpoint(run_dirs["wn_moon"], device="cpu",
                                           use_ema=False)
    want = CheckpointReader(run_dirs["wn_moon"]).restore(items=("params",))
    assert np.array_equal(raw.params["post_1/kernel"].numpy(),
                          want["params"]["post_1"]["kernel"])
    mel = tmp_path / "m.npy"
    np.save(mel, np.load(os.path.join(E2E, "0.mel.npy"))[60:62])
    out = tmp_path / "o.wav"
    generate.main(["--load_path", TARBALL["wn_moon"], "--no_ema", "--mel",
                   str(mel), "--out", str(out), "--device", "cpu"])
    got = load_wav(str(out), 24000)
    assert got.shape == (600,) and np.isfinite(got).all()


def test_trained_loaders_refuse_to_run_on_cpu_silently(monkeypatch):
    """With no GPU and no device asked for, both loaders raise before
    reading the checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(CheckpointReader, "__init__", None)
    for cls in (WaveNetGenerator, Synthesizer):
        with pytest.raises(RuntimeError, match="no CUDA"):
            cls.from_checkpoint(TARBALL["wn_moon"])


# ---------------------------------------------------------------------------
# (e) Synthesizer from the both_r2 checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_both_r2(run_dirs):
    return _load_with_skeleton(TacotronTask, lambda: JaxSynthesizer().load(
        run_dirs["both_r2"], fused_rnn=True, inference_dropout=False))


def _decodes(jsyn, psyn, dtype, max_iters=20):
    """The same text through the JAX and the port's Tacotron, both with
    ``compute_dtype`` set to ``dtype``, deterministic."""
    inputs, lengths = psyn._prepare_inputs([TEXT0])
    spk = np.zeros(1, np.int32)
    jcfg = dataclasses.replace(jsyn.cfg.tacotron, compute_dtype=dtype,
                               max_iters=max_iters)
    model = JTacotron(cfg=jcfg, audio=JC.AudioConfig())
    want = jax.jit(lambda v, x, n, s: model.apply(
        v, x, n, speaker_id=s, train=False, free_run=True))(
        jsyn.variables, jnp.asarray(inputs), jnp.asarray(lengths),
        jnp.asarray(spk))
    pcfg = dataclasses.replace(psyn.cfg.tacotron, compute_dtype=dtype,
                               max_iters=max_iters)
    port = Tacotron(pcfg, psyn.cfg.audio, psyn.codec.vocab_size)
    port.load_state_dict(psyn.model.state_dict())
    with torch.no_grad():
        got = port.eval()(t(inputs).long(), t(lengths).long(),
                          t(spk).long())
    return ({k: np.asarray(v, np.float32) for k, v in want.items()},
            {k: v.float().numpy() for k, v in got.items()})


def test_synthesizer_from_the_checkpoint_equals_the_jax_synthesizer(
        run_dirs, jax_both_r2):
    """Text 0 of samples/README.md, 20 steps.  f32: <= 1e-3 (the bound of
    test_full_width_free_run_matches_jax).  bf16: mean |port - JAX| at
    most twice JAX's own mean |bf16 - f32|."""
    psyn = Synthesizer.from_checkpoint(run_dirs["both_r2"], device="cpu",
                                       inference_dropout=False)
    assert psyn.step == jax_both_r2.step == STEP["both_r2"]
    assert not psyn.cfg.tacotron.dec_prenet_dropout_inference
    assert psyn.cfg.tacotron.compute_dtype == "bfloat16"
    j32, p32 = _decodes(jax_both_r2, psyn, "float32")
    for k in j32:
        assert p32[k].shape == j32[k].shape
        np.testing.assert_allclose(p32[k], j32[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    j16, p16 = _decodes(jax_both_r2, psyn, "bfloat16")
    for k in j16:
        d_jax = np.abs(j16[k] - j32[k]).mean()
        assert d_jax > 0, k
        assert np.abs(p16[k] - j16[k]).mean() <= 2.0 * d_jax, k


def test_synthesizer_from_the_checkpoint_keeps_the_jax_checks(run_dirs):
    with pytest.raises(ValueError, match="speakers"):
        Synthesizer.from_checkpoint(run_dirs["both_r2"], device="cpu",
                                    num_speakers=3)
    psyn = Synthesizer.from_checkpoint(TARBALL["both_r2"], device="cpu")
    assert psyn.cfg.tacotron.dec_prenet_dropout_inference
    out = psyn.synthesize([TEXT0], speaker_ids=[0], max_iters=4,
                          attention_trim=False)
    assert out[0]["mel"].shape == (20, 80) and np.isfinite(
        out[0]["mel"]).all()
