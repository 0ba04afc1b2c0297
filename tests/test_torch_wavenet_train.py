"""PyTorch port: WaveNet training against the JAX package (CPU).

The training graph (``models/wavenet.py`` ``WaveNet``, ``wavenet_loss``),
the MoL loss (``models/mixture.py``), the optimizers and EMA
(``train/optim.py``) and the task (``train/wavenet_task.py``) against
``WaveNet.apply`` / ``jax.value_and_grad``, optax and JAX's
``WaveNetTask``, with numpy-seeded inputs.  Tolerances are stated per
test.

The MoL loss is ill-conditioned in float32 wherever a bin's mass is taken
from ``cdf_delta = sigmoid(a) - sigmoid(b)`` with ``a - b`` =
``2 / 65535 / scale``: at the scales of fresh weights (``scale`` ~ 1) two
numbers near 0.5 cancel to ~1e-5, and their gradients, which cancel again,
keep ~3 digits.  XLA's and PyTorch's ``exp`` and ``sigmoid`` differ in the
last bit on many inputs, so the gradient of the loss in its input cannot
agree to 1e-5 of the largest between the two in float32.  So the
MoL head's gradients are held in parts: the graph's gradient under JAX's
own cotangent to 1e-5; the loss's gradient in its input (on JAX's output)
with both sides in float64 to 1e-8, and in float32 at most F64_RATIO times
as far from that float64 gradient as JAX's float32 one; and the whole
float32 gradient at most F64_RATIO times as far from JAX's graph gradient
under the float64 cotangent as JAX's own.  F64_RATIO compares two float32
noise levels; their ratio is not a constant.  Everything the ill
conditioning does not reach is held to 1e-5: the forward output, the loss,
the softmax head's gradients, the loss's edge branches, and the optimizers.
"""
import dataclasses
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.models import mixture as JX
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.train import wavenet_task as JT
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.stft import mel_spectrogram
from tacotron_wavenet_vocoder_korean_tpu_torch.models import mixture as PX
from tacotron_wavenet_vocoder_korean_tpu_torch.models import wavenet as PW
from tacotron_wavenet_vocoder_korean_tpu_torch.train import optim
from tacotron_wavenet_vocoder_korean_tpu_torch.train import wavenet_task as PT
from torch_port_util import TINY, TINY_GC, make_inputs, plain, port_cfg, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WN_MOON = os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz")
WAV = os.path.join(REPO, "samples", "wn_moon_260k", "003.0000.wn.wav")
Q = 16
CASES = {
    "raw": TINY,
    "quantized": dataclasses.replace(TINY, input_type="mulaw-quantize",
                                     scalar_input=False,
                                     quantization_channels=Q),
    "weight_norm": dataclasses.replace(TINY, weight_normalization=True),
    "gc": TINY_GC,
    "l2": dataclasses.replace(TINY, l2_regularization_strength=0.01),
}
TOL = 1e-5            # relative to the largest value of the compared array
F64_RATIO = 3.0       # MoL f32 gradients: distance from float64 (above)
F64_TOL = 1e-8        # the loss's gradient, both sides in float64
BF16_RATIO = 2.0      # bf16: distance from JAX's bf16, against its f32's


def _batch(cfg, seed=0):
    audio, mel = make_inputs(B=2, frames=12, seed=seed)
    if not cfg.scalar_input:
        audio = np.round((audio + 1) / 2 * (Q - 1)).astype(np.float32)
    sid = np.array([0, 1], np.int32) if cfg.num_speakers > 1 else None
    return audio, mel, sid


def _jax_init(cfg, audio, mel, sid, seed=0):
    return jax.tree.map(np.asarray, JW.WaveNet(cfg).init(
        jax.random.PRNGKey(seed), jnp.asarray(audio), jnp.asarray(mel),
        None if sid is None else jnp.asarray(sid))["params"])


def _jax_loss(cfg, params, audio, mel, sid, dtype=np.float32):
    """JAX's WaveNetTask.loss_fn on params and inputs cast to ``dtype``
    (float64 inside ``jax.enable_x64``)."""
    def loss(p):
        out = JW.WaveNet(cfg).apply(
            {"params": p}, jnp.asarray(audio, dtype), jnp.asarray(mel, dtype),
            None if sid is None else jnp.asarray(sid))
        flat = jax.tree_util.tree_flatten_with_path(p)[0]
        pairs = [(jax.tree_util.keystr(k), v) for k, v in flat]
        return JW.wavenet_loss(cfg, out, pairs)["loss"]
    with jax.enable_x64(dtype == np.float64):
        p = jax.tree.map(lambda v: jnp.asarray(v, dtype), params)
        value, grads = jax.jit(jax.value_and_grad(loss))(p)
        return float(value), {k: np.asarray(v, np.float64)
                              for k, v in convert.flatten(grads).items()}


def _port_loss(cfg, params, audio, mel, sid, dtype=torch.float32):
    cast = lambda x: torch.from_numpy(np.asarray(x)).to(dtype)
    leaves = {k: cast(v).requires_grad_(True) for k, v in params.items()}
    out = PW.WaveNet(port_cfg(cfg))(leaves, cast(audio), cast(mel),
                                    None if sid is None else
                                    torch.from_numpy(sid).long())
    loss = PW.wavenet_loss(port_cfg(cfg), out, leaves)["loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss), {k: (np.zeros(v.shape) if g is None
                             else g.numpy().astype(np.float64))
                         for (k, v), g in zip(params.items(), grads)}


def _leaf_err(a, b):
    """max over leaves of max |a - b| / max |b| (a leaf of zeros in b must
    be zeros in a)."""
    err = 0.0
    for k in b:
        scale = np.abs(b[k]).max()
        d = np.abs(a[k] - b[k]).max()
        err = max(err, d / scale if scale else (0.0 if d == 0 else np.inf))
    return err


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_loss_and_grads_match_jax(name):
    """f32 at TINY.  Forward output and target <= 1e-5 of the largest; loss
    relative error <= 1e-5; the gradient of the graph under JAX's own
    cotangent (the same random vector into raw_output on both sides) per
    leaf <= 1e-5 of that leaf's largest.  The gradient of the loss: the
    softmax head per leaf <= 1e-5 of the largest; the MoL head (ill
    conditioned) in parts, as the module docstring says (distances are the
    largest leaf error against the leaf's largest value)."""
    cfg = CASES[name]
    audio, mel, sid = _batch(cfg)
    jp = _jax_init(cfg, audio, mel, sid)
    params = convert.flatten(jp)
    assert set(params) == set(convert.train_param_shapes(
        port_cfg(cfg), gc_enable=sid is not None))

    def raw(p):
        return JW.WaveNet(cfg).apply(
            {"params": p}, jnp.asarray(audio), jnp.asarray(mel),
            None if sid is None else jnp.asarray(sid))["raw_output"]
    want = np.asarray(jax.jit(raw)(jp))
    cot = np.random.RandomState(1).standard_normal(want.shape).astype(
        np.float32)
    want_g = convert.flatten(jax.tree.map(np.asarray, jax.jit(
        lambda p, c: jax.vjp(raw, p)[1](c)[0])(jp, jnp.asarray(cot))))
    leaves = {k: t(v).requires_grad_(True) for k, v in params.items()}
    out = PW.WaveNet(port_cfg(cfg))(leaves, t(audio), t(mel), None
                                    if sid is None else
                                    torch.from_numpy(sid).long())
    got = out["raw_output"].detach().numpy()
    assert got.shape == want.shape == (2, 120 - cfg.receptive_field,
                                       cfg.out_channels if cfg.scalar_input
                                       else Q)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    rf = cfg.receptive_field
    np.testing.assert_array_equal(out["target"].numpy(), audio[:, rf:]
                                  if cfg.scalar_input else audio[:, rf:, 0])
    got_g = torch.autograd.grad(out["raw_output"], list(leaves.values()),
                                grad_outputs=t(cot), allow_unused=True)
    got_g = {k: np.zeros(v.shape) if g is None else g.numpy()
             for (k, v), g in zip(params.items(), got_g)}
    for k, w in want_g.items():
        assert np.abs(got_g[k] - w).max() <= TOL * np.abs(w).max(), k

    j32, g32 = _jax_loss(cfg, jp, audio, mel, sid)
    p32, gp = _port_loss(cfg, params, audio, mel, sid)
    assert abs(p32 - j32) <= TOL * abs(j32)
    if not cfg.scalar_input:
        for k, w in g32.items():
            assert np.abs(gp[k] - w).max() <= TOL * np.abs(w).max(), k
        return
    target = audio[:, rf:]
    mol = lambda r, y: jnp.mean(JX.discretized_mix_logistic_loss(
        r, y, num_class=2 ** 16, reduce=False))
    ct32 = np.asarray(jax.jit(jax.grad(mol))(want, target))
    with jax.enable_x64(True):
        ct64 = np.asarray(jax.jit(jax.grad(mol))(
            want.astype(np.float64), target.astype(np.float64)))
    for dtype in (torch.float64, torch.float32):
        r = torch.from_numpy(want).to(dtype).requires_grad_(True)
        (ct,) = torch.autograd.grad(PW.wavenet_loss(port_cfg(cfg), {
            "raw_output": r, "target": torch.from_numpy(target).to(dtype)}
            )["loss"], r)
        err = np.abs(ct.numpy() - ct64).max()
        if dtype == torch.float64:
            assert err <= F64_TOL * np.abs(ct64).max()
        else:
            assert err <= F64_RATIO * np.abs(ct32 - ct64).max()
    ref = {k: g32[k] - v for k, v in convert.flatten(jax.tree.map(
        np.asarray, jax.jit(lambda p, c: jax.vjp(raw, p)[1](c)[0])(
            jp, jnp.asarray(ct32 - ct64, jnp.float32)))).items()}
    assert _leaf_err(gp, ref) <= F64_RATIO * _leaf_err(g32, ref)


def test_bf16_loss_and_grads_within_jax_bf16_noise():
    """compute_dtype bfloat16 at TINY: |loss port - JAX bf16| and the
    largest leaf distance of the gradients from JAX's bf16 ones at most
    twice JAX's own bf16 - f32 distance."""
    cfg = dataclasses.replace(TINY, compute_dtype="bfloat16")
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    audio, mel, sid = _batch(cfg)
    jp = _jax_init(cfg, audio, mel, sid)
    j16, g16 = _jax_loss(cfg, jp, audio, mel, sid)
    j32, g32 = _jax_loss(c32, jp, audio, mel, sid)
    p16, gp = _port_loss(cfg, convert.flatten(jp), audio, mel, sid)
    assert abs(j16 - j32) > 0
    assert abs(p16 - j16) <= BF16_RATIO * abs(j16 - j32)
    assert _leaf_err(gp, g16) <= BF16_RATIO * _leaf_err(g32, g16)


def _mol_inputs():
    """y_hat [N, 30] and targets [N, 1] that reach every branch: targets of
    exactly -1 and +1 (edge CDFs), means far from their targets at small
    scales (a bin's mass below 1e-5: the log-pdf fallback), log-scales
    exactly at and below the clamp, and ordinary positions."""
    rng = np.random.RandomState(0)
    n, nr = 64, 10
    y_hat = rng.standard_normal((n, 3 * nr)).astype(np.float32)
    y = rng.uniform(-0.9, 0.9, (n, 1)).astype(np.float32)
    y[:8] = -1.0
    y[8:16] = 1.0
    y_hat[16:32, nr:2 * nr] = y[16:32] + 0.5           # far means
    y_hat[16:32, 2 * nr:] = -4.0                       # small scales
    y_hat[32:40, 2 * nr:] = PX.LOG_SCALE_MIN           # at the clamp
    y_hat[40:48, 2 * nr:] = PX.LOG_SCALE_MIN - 3.0     # below it
    y_hat[32:48, nr:2 * nr] = y[32:48]                 # exact means
    y_hat[36:40, nr:2 * nr] += 0.25                    # and far ones
    y_hat[44:48, nr:2 * nr] += 0.25
    return y_hat, y


def test_mol_loss_branches_match_jax_without_nan():
    """Per position: the edge branches (targets of exactly -1 and +1), the
    log-pdf fallback and the clamped scales equal JAX to 1e-5 relative
    (1e-6 absolute near 0) in value, and in gradient (relative to each
    position's largest, 1e-6 absolute); no gradient is NaN anywhere; at a log-scale exactly at the clamp the
    gradient is split as JAX splits it, below it is zero.  The ordinary
    positions (ill conditioned, module docstring) are held to twice JAX's
    own float32 - float64 distance."""
    y_hat, y = _mol_inputs()
    @jax.jit
    def value_and_grad(a, b):
        nll, vjp = jax.vjp(lambda a: JX.discretized_mix_logistic_loss(
            a, b, reduce=False), a)
        return nll, vjp(jnp.ones_like(nll))[0]
    want, jg = map(np.asarray, value_and_grad(jnp.asarray(y_hat),
                                              jnp.asarray(y)))
    with jax.enable_x64(True):
        w64, g64 = map(np.asarray, value_and_grad(
            jnp.asarray(y_hat, np.float64), jnp.asarray(y, np.float64)))
    x = t(y_hat).requires_grad_(True)
    got = PX.discretized_mix_logistic_loss(x, t(y), reduce=False)
    (pg,) = torch.autograd.grad(got.sum(), x)
    got, pg = got.detach().numpy(), pg.numpy()
    assert np.isfinite(pg).all() and np.isfinite(got).all()

    exact = np.r_[0:48]
    # atol: the NLL of a position at the clamp whose target sits on every
    # mean is log(1) = 0, computed as a log-sum-exp of zeros.
    np.testing.assert_allclose(got[exact], want[exact], rtol=TOL, atol=1e-6)
    # atol: at a target on every mean the true gradient is 0 and both
    # sides leave rounding noise of ~1e-8.
    scale = np.abs(jg).max(axis=1, keepdims=True)
    assert (np.abs(pg - jg)[exact] <= TOL * scale[exact] + 1e-6).all()
    nr = 10
    assert np.abs(pg[36:40, 2 * nr:]).min() > 0       # at the clamp: half
    assert (pg[40:48, 2 * nr:] == 0).all() and (jg[40:48, 2 * nr:] == 0).all()

    rest = np.r_[48:64]
    assert (np.abs(got[rest] - w64[rest]).max()
            <= F64_RATIO * np.abs(want[rest] - w64[rest]).max() + 1e-6)
    assert (np.abs(pg[rest] - g64[rest]).max()
            <= F64_RATIO * np.abs(jg[rest] - g64[rest]).max())
    np.testing.assert_allclose(float(PX.discretized_mix_logistic_loss(
        t(y_hat), t(y))), float(want.sum()), rtol=TOL)


def test_log_sum_exp_and_softplus_match_jax():
    x = np.random.RandomState(2).standard_normal((5, 7)).astype(
        np.float32) * 30
    np.testing.assert_allclose(PX.log_sum_exp(t(x)).numpy(),
                               np.asarray(JX.log_sum_exp(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(PX.softplus(t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def _opt_cfgs(optimizer, clip):
    over = {"optimizer": optimizer, "clip_gradients": clip,
            "decay_steps": 10, "momentum": 0.8, "learning_rate": 0.1}
    return (JC.overlay(JC.Config(), wavenet=over),
            PC.overlay(PC.Config(), wavenet=over))


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd", "rmsprop"])
def test_optimizer_matches_optax_over_3_steps(optimizer, clip):
    """make_optimizer's chain against JAX's (optax) on nested names, three
    steps with gradients whose global norm is above 1 in steps 1 and 3 and
    below it in step 2: params <= 1e-5 after every step, the state's tree
    leaf for leaf (counts equal, moments <= 1e-5 relative)."""
    jcfg, pcfg = _opt_cfgs(optimizer, clip)
    rng = np.random.RandomState(3)
    params = {"post_1/kernel": rng.standard_normal((4, 3)),
              "post_1/bias": rng.standard_normal(3),
              "layer_0_res_kernel": rng.standard_normal((2, 2, 3))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    jtx, ptx = JT.make_optimizer(jcfg), PT.make_optimizer(pcfg)
    jp = jax.tree.map(jnp.asarray, convert.to_jax_tree(params))
    js = jtx.init(jp)
    pp = {k: t(v) for k, v in params.items()}
    ps = ptx.init(pp)
    for i, scale in enumerate((3.0, 0.1, 2.0)):
        g = {k: (rng.standard_normal(v.shape) * scale / 3).astype(np.float32)
             for k, v in params.items()}
        ju, js = jtx.update(jax.tree.map(jnp.asarray, convert.to_jax_tree(g)),
                            js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = ptx.update({k: t(v) for k, v in g.items()}, ps, pp)
        pp = optim.apply_updates(pp, pu)
        want = convert.flatten(jax.tree.map(np.asarray, jp))
        for k, w in want.items():
            np.testing.assert_allclose(pp[k].numpy(), w, rtol=0, atol=TOL,
                                       err_msg=f"step {i}: {k}")
        jflat = dict(_leaves(plain(js)))
        pflat = dict(_leaves(convert.to_jax_tree(ps)))
        assert set(jflat) == set(pflat)
        for k, w in jflat.items():
            if w.dtype == np.int32:
                assert pflat[k].dtype == np.int32 and pflat[k] == w, k
            else:
                assert np.abs(pflat[k] - w).max() <= TOL * np.abs(w).max(), k


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, np.asarray(tree)


def test_schedule_and_clip_match_optax():
    """exponential_decay at steps 0, 1, 1000 and 260,250 (wn_moon's):
    <= 1 ulp of float32 from optax; clip_by_global_norm leaves gradients
    below the norm as they are."""
    js = optax.exponential_decay(1e-3, 300000, 0.5)
    ps = optim.exponential_decay(1e-3, 300000, 0.5)
    for step in (0, 1, 1000, 260250):
        want = np.float32(js(jnp.asarray(step, jnp.int32)))
        got = np.float32(ps(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= np.spacing(want), step
    g = {"a": t(np.full(4, 0.1))}
    out, _ = optim.clip_by_global_norm(1.0).update(g, (), None)
    assert torch.equal(out["a"], g["a"])


def test_train_step_ema_metrics_and_eval_match_jax():
    """One step of the port's task against JAX's WaveNetTask.train_step at
    TINY with the softmax head (well conditioned), ema_decay 0.9 and L2,
    from step 1000 with Adam's moments and counts set as a resumed run has
    them (mu ~ 1e-3, nu ~ 1e-4, count 1000): metrics {loss, l2_loss,
    learning_rate, grad_norm}, new params, EMA and moments <= 1e-5 relative;
    step and counts + 1; eval_step on the new EMA <= 1e-5."""
    cfg = dataclasses.replace(CASES["quantized"], ema_decay=0.9,
                              l2_regularization_strength=0.01)
    jcfg = JC.Config(wavenet=cfg, audio=JC.AudioConfig(hop_size=10))
    pcfg = PC.Config(wavenet=port_cfg(cfg), audio=PC.AudioConfig(hop_size=10))
    audio, mel, _ = _batch(cfg)
    batch = {"input_wav": audio, "local_condition": mel,
             "speaker_id": np.zeros(2, np.int32)}
    jtask = JT.WaveNetTask(jcfg)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    rng = np.random.RandomState(4)
    moment = lambda scale, sq: jax.tree.map(lambda p: jnp.asarray(
        (rng.standard_normal(p.shape) * scale) ** (2 if sq else 1),
        jnp.float32), jstate.params)
    count = jnp.asarray(1000, jnp.int32)
    adam, sched = jstate.opt_state
    jstate = jstate._replace(step=count, opt_state=(
        adam._replace(count=count, mu=moment(1e-3, False),
                      nu=moment(1e-2, True)), sched._replace(count=count)))
    ptask = PT.WaveNetTask(pcfg, device="cpu")
    pstate = convert.from_jax_tree(ptask.init_state(0), plain(jstate))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jm = jax.jit(jtask.train_step)(jstate, jb)
    pb = PT.batch_to_device(batch, torch.device("cpu"))
    pnew, pm = ptask.train_step(pstate, pb)
    assert set(pm) == set(jm) == {"loss", "l2_loss", "learning_rate",
                                  "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=TOL,
                                   err_msg=k)
    want, got = plain(jnew), convert.to_jax_tree(pnew)
    assert int(got["step"]) == 1001
    for part in ("params", "ema_params"):
        a, b = convert.flatten(want[part]), convert.flatten(got[part])
        assert _leaf_err(b, a) <= TOL, part
    assert int(got["opt_state"][0]["count"]) == 1001
    assert int(got["opt_state"][1]["count"]) == 1001
    for part in ("mu", "nu"):
        a = convert.flatten(want["opt_state"][0][part])
        b = convert.flatten(got["opt_state"][0][part])
        assert _leaf_err(b, a) <= TOL, part
    je, pe = jax.jit(jtask.eval_step)(jnew, jb), ptask.eval_step(pnew, pb)
    np.testing.assert_allclose(float(pe["loss"]), float(je["loss"]), rtol=TOL)


def test_seeded_train_tree_has_flax_layout_and_scales():
    """Names and shapes of JAX's init for every case; zero biases; weight
    norm's _g equal to JAX's init (a constant); every other leaf inside
    flax's truncation (2 scales: glorot for the stack and the speaker
    table, lecun for the post and upsampler kernels) with its std within
    25% of JAX's draw's."""
    for name, cfg in CASES.items():
        audio, mel, sid = _batch(cfg)
        jp = convert.flatten(_jax_init(cfg, audio, mel, sid))
        got = convert.seeded_train_tree(port_cfg(cfg), 0,
                                         gc_enable=sid is not None)
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in jp.items()}, name
        for k, v in got.items():
            if k.endswith("bias"):
                assert not v.any(), k
            elif k.endswith("_g"):
                np.testing.assert_allclose(v, jp[k], rtol=1e-6, err_msg=k)
            else:
                shape = v.shape
                if k.startswith(("post_", "upsampler/")):
                    scale = 1 / np.sqrt(np.prod(shape[:-1]))
                else:
                    rf = np.prod(shape[:-2]) if len(shape) > 2 else 1
                    scale = np.sqrt(2 / (shape[-2] * rf + shape[-1] * rf))
                assert np.abs(v).max() <= 2 * scale / 0.87962566103423978, k
                if v.size >= 64:
                    assert abs(v.std() / jp[k].std() - 1) < 0.25, (name, k)


def test_task_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PT.WaveNetTask(PC.Config())


@pytest.fixture(scope="module")
def wn_moon(tmp_path_factory):
    d = tmp_path_factory.mktemp("wn_moon")
    with tarfile.open(WN_MOON) as tar:
        tar.extractall(d, filter="data")
    return str(d)


def test_full_width_step_resumed_from_wn_moon_matches_jax(wn_moon):
    """wn_moon's config and restored state (step 260,250, opt_state
    included), B = 1, T = 6,000 (20 frames, 853 outputs past the receptive
    field) cut from a committed wav with the port's mel: one step of the
    port against JAX's jitted train_step.  Loss relative error <= 1e-5;
    learning rate equal; grad_norm <= 1e-4 relative; each leaf's update
    (new - old params) within 1e-2 of that leaf's largest update; Adam's
    first moment within 1e-2 and its second within 1e-3 of each leaf's
    largest (they carry the gradient at weights 0.1 and 0.001); EMA <= 1e-5
    relative; step and both counts 260,251."""
    jcfg, pcfg = JC.load_config(wn_moon), PC.load_config(wn_moon)
    hop, T = pcfg.audio.hop_size, 6000
    wav = load_wav(WAV, pcfg.audio.sample_rate)
    mel = mel_spectrogram(t(wav), pcfg.audio).T.numpy()
    start = 40
    batch = {"input_wav": wav[start * hop:start * hop + T][None, :, None],
             "local_condition": mel[start:start + T // hop][None],
             "speaker_id": np.zeros(1, np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtask = JT.WaveNetTask(jcfg)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jtask.abstract_state(jax.random.PRNGKey(0), jb))
    jstate = JaxCheckpointManager(wn_moon).restore(template)
    assert int(jstate.step) == 260250
    jnew, jm = jax.jit(jtask.train_step)(jstate, jb)

    ptask = PT.WaveNetTask(pcfg, device="cpu")
    pstate = convert.from_jax_tree(ptask.init_state(0), plain(jstate))
    pnew, pm = ptask.train_step(pstate, PT.batch_to_device(
        batch, torch.device("cpu")))
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= TOL * abs(
        float(jm["loss"]))
    assert float(pm["learning_rate"]) == float(jm["learning_rate"])
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want, got = plain(jnew), convert.to_jax_tree(pnew)
    old = convert.flatten(plain(jstate.params))
    wp, gp = convert.flatten(want["params"]), convert.flatten(got["params"])
    for k in old:
        du, dg = wp[k] - old[k], gp[k] - old[k]
        assert np.abs(dg - du).max() <= 1e-2 * np.abs(du).max(), k
    for part, tol in (("mu", 1e-2), ("nu", 1e-3)):
        a = convert.flatten(want["opt_state"][0][part])
        b = convert.flatten(got["opt_state"][0][part])
        for k in a:
            assert np.abs(b[k] - a[k]).max() <= tol * np.abs(a[k]).max(), k
    a, b = convert.flatten(want["ema_params"]), convert.flatten(
        got["ema_params"])
    assert _leaf_err(b, a) <= TOL
    assert int(got["step"]) == 260251
    assert int(got["opt_state"][0]["count"]) == 260251
    assert int(got["opt_state"][1]["count"]) == 260251
