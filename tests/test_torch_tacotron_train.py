"""PyTorch port: Tacotron training against the JAX package (CPU).

Batch norm in training mode, the teacher-forced forward, scheduled
sampling, the loss, its gradient, the schedules, three optimizer steps,
the evaluation step, the checkpoint's JAX layout both ways and the
batcher's draws.  TINY widths with ``dropout_prob=0``: flax's ``Dropout``
returns its input at rate 0, so both sides are deterministic.  The same
numpy-seeded weights, statistics, Adam moments and batches go to both.
Tolerances are stated per test, the observed errors beside them.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.data import loader as JL
from tacotron_wavenet_vocoder_korean_tpu.models import modules as JM
from tacotron_wavenet_vocoder_korean_tpu.models import tacotron as JTM
from tacotron_wavenet_vocoder_korean_tpu.train import tacotron_task as JTT
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.data import loader as PL
from tacotron_wavenet_vocoder_korean_tpu_torch.models import modules as PM
from tacotron_wavenet_vocoder_korean_tpu_torch.models import tacotron as PTM
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    tacotron_task as PTT)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointManager, CheckpointReader, restore_into_state)
from test_torch_tacotron import TINY, _random_variables, jax_cfg
from torch_port_util import plain

CFG = dataclasses.replace(TINY, dropout_prob=0.0)
SINGLE = dataclasses.replace(CFG, num_speakers=1, model_type="single")
AUDIO = PC.AudioConfig()
FWD_TOL = 1e-5       # teacher-forced forward, f32
LOSS_TOL = 1e-6
# Of each leaf's largest |gradient|.  Stated above the 1e-5 the other
# leaves meet: a training-mode batch norm's backward divides the
# convolutions' rounding by the batch's deviation (observed 2.4e-5 on the
# post-net's conv1d_bank_2, <= 7e-6 elsewhere).
GRAD_TOL = 5e-5
GRAD_NORM_TOL = 1e-5  # |port - JAX| / |JAX| over all leaves together
STEP_LOSS_TOL = 1e-5
STEP_PARAM_TOL = 1e-5   # of each leaf's largest |value|, after 3 steps


def full_cfg(t: PC.TacotronConfig, **train) -> PC.Config:
    return PC.Config(tacotron=t, train=PC.TrainConfig(**train))


def jax_full_cfg(cfg: PC.Config) -> JC.Config:
    return JC.from_dict(PC.to_dict(cfg))


def make_batch(B=2, T_in=16, T_out=40, seed=0, speakers=True):
    rng = np.random.RandomState(seed)
    x = rng.randint(2, 70, (B, T_in)).astype(np.int32)
    lengths = np.array([T_in, T_in - 5][:B], np.int32)
    x[1, lengths[1]:] = 0
    return {"inputs": x, "input_lengths": lengths,
            "loss_coeff": rng.uniform(0.5, 1.5, B).astype(np.float32),
            "mel_targets": rng.randn(B, T_out, 80).astype(np.float32),
            "linear_targets": rng.randn(B, T_out, 1025).astype(np.float32),
            "speaker_id": (np.array([0, 1][:B], np.int32) if speakers
                           else np.zeros(B, np.int32))}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def pbatch(b):
    return PTT.batch_to_device(b, "cpu")


def port_model(cfg, variables):
    model = PTM.Tacotron(cfg, AUDIO)
    model.load_state_dict(convert.tacotron_params_from_jax(
        cfg, variables["params"], variables["batch_stats"]))
    return model


def close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


def leaf_errors(port: dict, jax_tree, cfg) -> dict:
    """max |port - JAX| / max |JAX| per leaf, JAX's tree mapped to the
    port's names."""
    model = convert.tacotron_skeleton(cfg)
    want = convert.state_from_jax(model, JM.fuse_gru_params(plain(jax_tree)),
                                  None, convert.tacotron_scopes(model))
    assert set(want) == set(port)
    return {k: float(np.abs(port[k].detach().numpy() - want[k].numpy()).max()
                     / max(float(np.abs(want[k].numpy()).max()), 1e-30))
            for k in want}


# ---------------------------------------------------------------------------
# Batch norm in training mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_training_statistics_match_flax(dtype):
    """0.99 old + 0.01 batch for both running statistics, from the
    batch's mean and biased variance over B x T in float32 (torch's
    BatchNorm1d would update with the unbiased variance): <= 1e-6
    (observed 1.2e-7 in f32, 0 in bf16).  The normalised output: 2e-6 of
    its largest |value| (observed 1.1e-6 in f32, where the two convs'
    rounding is divided by the batch's deviation; 0 in bf16)."""
    rng = np.random.default_rng(0)
    x = (1.5 + rng.standard_normal((3, 17, 10))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    pdt = torch.bfloat16 if dtype == "bfloat16" else None
    mod = JM.BatchNormConv1d(8, 3, "relu", dtype=jdt)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), v["params"])
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.2, v["batch_stats"])
    want, mut = mod.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), True, mutable=["batch_stats"])
    net = PM.BatchNormConv1d(10, 8, 3, "relu", pdt)
    net.load_state_dict(convert.state_from_jax(net, params, stats))
    updates = {}
    got = net(torch.from_numpy(x).transpose(1, 2), True, updates)
    want = np.asarray(want, np.float32)
    close(got.transpose(1, 2), want, 2e-6 * np.abs(want).max(), "output")
    mean, var = updates[net]
    close(mean, mut["batch_stats"]["bn"]["mean"], 1e-6, "running mean")
    close(var, mut["batch_stats"]["bn"]["var"], 1e-6, "running var")
    close(net.bn.running_var, stats["bn"]["var"], 0, "buffers untouched")


# ---------------------------------------------------------------------------
# Teacher-forced forward in training mode
# ---------------------------------------------------------------------------

def _jax_train_forward(cfg, variables, b, rngs=None, **kw):
    model = JTM.Tacotron(cfg=jax_cfg(cfg), audio=JC.AudioConfig())
    fn = jax.jit(lambda v, b, rngs: model.apply(
        v, b["inputs"], b["input_lengths"], speaker_id=b["speaker_id"],
        mel_targets=b["mel_targets"], mutable=["batch_stats"], rngs=rngs,
        **kw))
    out, mut = fn(jax.tree.map(jnp.asarray, variables), jbatch(b), rngs)
    return out, mut["batch_stats"]


def _port_train_forward(cfg, variables, b, **kw):
    model = port_model(cfg, variables)
    updates = {}
    t = pbatch(b)
    out = model(t["inputs"], t["input_lengths"], t["speaker_id"],
                mel_targets=t["mel_targets"], bn_updates=updates, **kw)
    return out, model.running_stats(updates), model


@pytest.mark.parametrize("cfg", [CFG, SINGLE], ids=["deepvoice2", "single"])
def test_teacher_forced_forward_matches_jax(cfg):
    """train=True, T_out = 40 (8 steps): mel, linear and alignments
    <= 1e-5 (observed ~1e-6), the new running statistics too."""
    variables = _random_variables(cfg, True, 3)
    b = make_batch(speakers=cfg.num_speakers > 1)
    want, want_stats = _jax_train_forward(cfg, variables, b, train=True)
    got, stats, model = _port_train_forward(cfg, variables, b, train=True)
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        assert got[k].shape == want[k].shape
        close(got[k], want[k], FWD_TOL, k)
    flat = convert.flatten(want_stats)
    scopes = convert.tacotron_scopes(model)
    assert len(stats) == len(flat)
    for k, v in stats.items():
        close(v, flat[convert._jax_key(k, scopes)[1]], FWD_TOL, k)


def test_teacher_forcing_is_causal():
    """The port's twin of JAX's test: perturbing block 1's last target
    frame leaves blocks 0 and 1 unchanged and reaches block 2 on."""
    variables = _random_variables(CFG, True, 4)
    b = make_batch(T_out=20)
    r = CFG.reduction_factor
    model = port_model(CFG, variables)
    t = pbatch(b)
    run = lambda mel: model(t["inputs"], t["input_lengths"], t["speaker_id"],
                            mel_targets=mel)["mel_outputs"].detach().numpy()
    base = run(t["mel_targets"])
    perturbed = t["mel_targets"].clone()
    perturbed[:, r + r - 1] += 10.0
    got = run(perturbed)
    np.testing.assert_allclose(got[:, :2 * r], base[:, :2 * r], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(got[:, 2 * r:] - base[:, 2 * r:]).max() > 1e-3


@pytest.mark.parametrize("p", [1.0, 0.0])
def test_scheduled_sampling_extremes_match_jax(p):
    """At p = 1 every step takes the teacher's frame, at p = 0 the model's
    own: JAX's bernoulli draw is then deterministic, and the port's
    ``use_teacher`` all True / all False gives the same outputs
    (<= 1e-5)."""
    variables = _random_variables(CFG, True, 5)
    b = make_batch()
    want, _ = _jax_train_forward(
        CFG, variables, b, train=True, teacher_force_prob=jnp.float32(p),
        rngs={"ss": jax.random.PRNGKey(3)})
    T_dec = b["mel_targets"].shape[1] // CFG.reduction_factor
    got, _, _ = _port_train_forward(
        CFG, variables, b, train=True,
        use_teacher=torch.full((T_dec, 2), bool(p)))
    for k in want:
        close(got[k], want[k], FWD_TOL, k)


def test_scheduled_sampling_mixed_draws_match_a_hand_built_reference():
    """Injected mixed draws against the decoder loop built by hand from
    the port's DecoderStep: at each step, per example, the teacher's frame
    (block t-1's last target frame, <GO> at 0) or the last emitted one."""
    variables = _random_variables(CFG, True, 6)
    b = make_batch()
    model = port_model(CFG, variables).eval()
    t = pbatch(b)
    r, T_dec = CFG.reduction_factor, b["mel_targets"].shape[1] // 5
    draws = torch.from_numpy(np.random.default_rng(7).uniform(
        size=(T_dec, 2)) < 0.5)
    assert 0 < int(draws.sum()) < draws.numel()
    with torch.no_grad():
        got = model(t["inputs"], t["input_lengths"], t["speaker_id"],
                    mel_targets=t["mel_targets"], use_teacher=draws)
        enc = model.encode(t["inputs"], t["input_lengths"], t["speaker_id"])
        dec = model.decoder
        carry = dec.initial_carry(enc)
        frames = []
        for s in range(T_dec):
            teacher = (torch.zeros(2, 80) if s == 0
                       else t["mel_targets"][:, s * r - 1])
            fed = torch.stack([teacher[i] if draws[s, i] else
                               carry.prev_frame[i] for i in range(2)])
            carry = carry._replace(prev_frame=fed)
            carry, f, _ = dec.step(carry, enc.keys, enc.values.float(),
                                   enc.mask,
                                   dec.step.attention.loop_constants(enc.keys))
            frames.append(f)
        mel = torch.stack(frames, 1).reshape(2, T_dec * r, 80)
    close(got["mel_outputs"], mel.numpy(), 1e-6, "mel")


# ---------------------------------------------------------------------------
# Loss, gradient, schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prioritize", [False, True])
def test_tacotron_loss_matches_jax(prioritize):
    """The four losses, per-example coefficients, the 165-5,000 Hz band:
    <= 1e-6 (observed ~1e-7)."""
    cfg = dataclasses.replace(CFG, prioritize_loss=prioritize)
    rng = np.random.default_rng(8)
    b = make_batch()
    out = {"mel_outputs": rng.standard_normal((2, 40, 80)),
           "linear_outputs": rng.standard_normal((2, 40, 1025))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    want = JTM.tacotron_loss({k: jnp.asarray(v) for k, v in out.items()},
                             jnp.asarray(b["mel_targets"]),
                             jnp.asarray(b["linear_targets"]),
                             jnp.asarray(b["loss_coeff"]), jax_cfg(cfg),
                             JC.AudioConfig())
    got = PTM.tacotron_loss({k: torch.from_numpy(v) for k, v in out.items()},
                            torch.from_numpy(b["mel_targets"]),
                            torch.from_numpy(b["linear_targets"]),
                            torch.from_numpy(b["loss_coeff"]), cfg, AUDIO)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], LOSS_TOL, k)


def test_loss_gradient_matches_jax():
    """d loss / d params (cotangent 1 on the loss, training mode): every
    leaf within GRAD_TOL of its largest |gradient|, the whole gradient
    within 1e-5 relative in the L2 norm (observed ~1e-6).  A bias in
    front of a training-mode batch norm with no activation between
    (the last projection's conv bias) has a gradient of exactly 0 in
    exact arithmetic; both sides give rounding noise there, held to 1e-7
    of the largest |gradient| of all leaves (observed ~1e-9)."""
    cfg = full_cfg(CFG)
    variables = _random_variables(CFG, True, 9)
    b = make_batch()
    jtask = JTT.TacotronTask(jax_full_cfg(cfg))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(params, stats, jbatch(b),
                                      jax.random.PRNGKey(0))
    task = PTT.TacotronTask(cfg, device="cpu")
    state = task.state_from_tensors(convert.tacotron_params_from_jax(
        CFG, variables["params"], variables["batch_stats"]))
    losses, grads, _ = task.grads(state.params, state.batch_stats, pbatch(b))
    close(losses["loss"], jloss, 1e-5, "loss")
    model = task.model
    want = convert.state_from_jax(model, JM.fuse_gru_params(plain(jgrads)),
                                  None, convert.tacotron_scopes(model))
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    zero = {k for k in want if k.endswith("proj_2.conv.bias")}
    assert len(zero) == 2
    diff = sum(float(((grads[k] - w) ** 2).sum()) for k, w in want.items())
    norm = sum(float((w ** 2).sum()) for w in want.values())
    assert diff ** 0.5 <= GRAD_NORM_TOL * norm ** 0.5
    for k, w in want.items():
        w = w.numpy()
        err = float(np.abs(grads[k].numpy() - w).max())
        if k in zero:
            assert float(np.abs(w).max()) < 1e-6 * top, k
            assert err <= 1e-7 * top, (k, err)
        else:
            assert err <= GRAD_TOL * float(np.abs(w).max()), (k, err)


@pytest.mark.parametrize("mode,randomly", [(0, True), (0, False), (1, True)],
                         ids=["noam-4000", "noam-40000", "decay"])
def test_learning_rate_schedule_matches_jax(mode, randomly):
    """Both modes at both warmups, relative 1e-6 (observed exact or one
    float32 ulp)."""
    cfg = dataclasses.replace(PC.BOTH_R2, decay_learning_rate_mode=mode)
    steps = np.array([0, 1, 99, 3999, 4000, 39999, 40000, 105999, 106000,
                      10 ** 6], np.int32)
    want = np.asarray(JTM.learning_rate_schedule(jax_cfg(cfg), randomly)(
        jnp.asarray(steps)))
    got = PTM.learning_rate_schedule(cfg, randomly)(
        torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_learning_rate_at_both_r2_step_106000():
    """The value both_r2's metrics.jsonl logged at step 106,000 (the
    schedule read at state.step = 105,999, warmup 4,000): 1.9425714e-4."""
    lr = PTM.learning_rate_schedule(PC.BOTH_R2, True)(
        torch.tensor(105999, dtype=torch.int32))
    np.testing.assert_allclose(float(lr), 1.9425714e-4, rtol=1e-7)


def test_scheduled_sampling_prob_matches_jax():
    cfg = dataclasses.replace(CFG, scheduled_sampling=True, ss_final_prob=0.7,
                              ss_start_step=100, ss_ramp_steps=200)
    steps = np.array([0, 100, 150, 200, 300, 301, 10 ** 5], np.int32)
    want = np.asarray(JTM.scheduled_sampling_prob(jax_cfg(cfg),
                                                  jnp.asarray(steps)))
    got = PTM.scheduled_sampling_prob(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == 1.0 and abs(got[-1] - 0.7) < 1e-7


# ---------------------------------------------------------------------------
# Train and eval steps
# ---------------------------------------------------------------------------

def _states(t_cfg, seed=10, start=1000):
    """The same resumed state on both sides: random weights and
    statistics, Adam moments at count ``start`` (fresh moments would turn
    rounding noise into full updates)."""
    cfg = full_cfg(t_cfg)
    jtask = JTT.TacotronTask(jax_full_cfg(cfg), is_randomly_initialized=True)
    variables = _random_variables(t_cfg, True, seed)
    params = jax.tree.map(jnp.asarray, variables["params"])
    rng = np.random.default_rng(seed + 1)
    mu = jax.tree.map(lambda a: jnp.asarray(
        1e-3 * rng.standard_normal(a.shape), jnp.float32), params)
    nu = jax.tree.map(lambda a: jnp.asarray(
        1e-6 * rng.uniform(0.5, 1.5, a.shape), jnp.float32), params)
    clip, (adam, sched) = jtask.tx.init(params)
    count = jnp.asarray(start, jnp.int32)
    jstate = JTT.TrainState(
        count, params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
        (clip, (adam._replace(count=count, mu=mu, nu=nu),
                sched._replace(count=count))))
    task = PTT.TacotronTask(cfg, is_randomly_initialized=True, device="cpu")
    template = task.init_state(0)
    pstate = convert.from_jax_tree(
        template, task.from_jax_tree(template, plain(jstate)))
    return jtask, jstate, task, pstate


def test_three_train_steps_match_jax():
    """Three steps on three batches from a resumed state: the losses,
    grad_norm and learning_rate within 1e-5 relative (observed ~1e-7);
    then the params, batch_stats and Adam's moments within 1e-5 of each
    leaf's largest (observed <= ~1e-6), the counts equal."""
    jtask, jstate, task, pstate = _states(CFG)
    jstep = jax.jit(jtask.train_step)
    for i in range(3):
        b = make_batch(seed=20 + i)
        jstate, jm = jstep(jstate, jbatch(b), jax.random.PRNGKey(0))
        pstate, pm = task.train_step(pstate, pbatch(b))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=STEP_LOSS_TOL, err_msg=k)
    assert int(pstate.step) == int(jstate.step) == 1003
    errs = leaf_errors(pstate.params, jstate.params, CFG)
    adam = jstate.opt_state[1][0]
    errs.update({f"mu:{k}": v for k, v in leaf_errors(
        pstate.opt_state[1][0]["mu"], adam.mu, CFG).items()})
    errs.update({f"nu:{k}": v for k, v in leaf_errors(
        pstate.opt_state[1][0]["nu"], adam.nu, CFG).items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_PARAM_TOL, (worst, errs[worst])
    assert int(pstate.opt_state[1][0]["count"]) == int(adam.count)
    assert int(pstate.opt_state[1][1]["count"]) == 1003
    flat = convert.flatten(plain(jstate.batch_stats))
    model = task.model
    for k, v in pstate.batch_stats.items():
        close(v, flat[convert._jax_key(k, convert.tacotron_scopes(model))[1]],
              1e-6, k)


@pytest.mark.parametrize("name", ["simple", "loc_sen"])
def test_two_train_steps_match_jax_other_configs(name):
    """Two steps from a resumed state with simple speakers (bah_mon_norm)
    and with loc_sen (deepvoice speakers), at the widths of
    tests/test_torch_attention.py: the metrics within 1e-5 relative, then
    the params and Adam's moments within 1e-5 of each leaf's largest, the
    batch_stats within 1e-6."""
    from test_torch_attention import config
    t_cfg = dataclasses.replace(config(name), dropout_prob=0.0)
    jtask, jstate, task, pstate = _states(t_cfg, seed=12)
    jstep = jax.jit(jtask.train_step)
    for i in range(2):
        b = make_batch(seed=40 + i)
        jstate, jm = jstep(jstate, jbatch(b), jax.random.PRNGKey(0))
        pstate, pm = task.train_step(pstate, pbatch(b))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=STEP_LOSS_TOL, err_msg=k)
    assert int(pstate.step) == int(jstate.step) == 1002
    adam = jstate.opt_state[1][0]
    errs = leaf_errors(pstate.params, jstate.params, t_cfg)
    for moment in ("mu", "nu"):
        errs.update({f"{moment}:{k}": v for k, v in leaf_errors(
            pstate.opt_state[1][0][moment], getattr(adam, moment),
            t_cfg).items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STEP_PARAM_TOL, (worst, errs[worst])
    flat = convert.flatten(plain(jstate.batch_stats))
    scopes = convert.tacotron_scopes(task.model)
    for k, v in pstate.batch_stats.items():
        close(v, flat[convert._jax_key(k, scopes)[1]], 1e-6, k)


def test_scheduled_sampling_train_step_reports_its_prob():
    """With scheduled sampling the step reports p(step) and draws from the
    generator; p = 1 before ss_start_step gives the plain step's loss."""
    t_cfg = dataclasses.replace(CFG, scheduled_sampling=True,
                                ss_start_step=5000)
    _, _, task, state = _states(t_cfg)
    _, _, plain_task, plain_state = _states(CFG)
    b = pbatch(make_batch())
    _, m = task.train_step(state, b,
                           generator=torch.Generator().manual_seed(0))
    _, want = plain_task.train_step(plain_state, b)
    assert float(m["teacher_force_prob"]) == 1.0
    assert float(m["loss"]) == float(want["loss"])
    with pytest.raises(ValueError, match="generator"):
        task.train_step(state, b)


def test_eval_step_matches_jax():
    """Free-running against the targets with the running statistics:
    the losses within 1e-5 (observed ~1e-6), the outputs within 1e-4."""
    jtask, jstate, task, pstate = _states(CFG)
    b = make_batch(seed=30)
    want = jtask.jit_eval_step()(jstate, jbatch(b))
    got = task.eval_step(pstate, pbatch(b))
    assert set(got) == set(want)
    for k in ("loss", "mel_loss", "linear_loss", "loss_without_coeff"):
        close(got[k], want[k], 1e-5, k)
    for k in ("mel_outputs", "linear_outputs", "alignments"):
        close(got[k], want[k], 1e-4, k)


# ---------------------------------------------------------------------------
# Checkpoints in JAX's layout, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "GRUCell"])
def test_checkpoint_round_trip_with_jax(tmp_path, fused):
    """The port's state written by its CheckpointManager restores into the
    JAX task's abstract_state (flax GRUCells when ``fused_rnn: false``),
    leaf for leaf; a JAX-written state restores into the port (GRUCell
    trees fused) through restore_into_state, equal (tolerance 0: copies,
    transposes and exact splits)."""
    t_cfg = dataclasses.replace(CFG, fused_rnn=fused)
    jtask, jstate, task, pstate = _states(CFG)
    task = PTT.TacotronTask(full_cfg(t_cfg), is_randomly_initialized=True,
                            device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(
        1000, task.to_jax_tree(pstate))
    jtask = JTT.TacotronTask(jax_full_cfg(full_cfg(t_cfg)))
    abstract = jtask.abstract_state(jax.random.PRNGKey(0),
                                    jbatch(make_batch()))
    mgr = JaxCheckpointManager(str(tmp_path / "port"))
    restored = mgr.restore(jax.tree.map(
        lambda x: np.empty(x.shape, x.dtype), abstract))
    mgr.close()
    want = task.to_jax_tree(pstate)
    got = plain(restored)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], str(k))
    if not fused:
        names = str(list(flat_got))
        assert "GRUCell_0" in names and "w_ih" not in names

    mgr = JaxCheckpointManager(str(tmp_path / "jax"))
    mgr.save(1000, restored)
    mgr.close()
    back, start = restore_into_state(task.init_state(1), str(tmp_path / "jax"),
                                     None, task.from_jax_tree)
    assert start == 1000
    for a, b in ((back.params, pstate.params),
                 (back.batch_stats, pstate.batch_stats),
                 (back.opt_state[1][0]["mu"], pstate.opt_state[1][0]["mu"]),
                 (back.opt_state[1][0]["nu"], pstate.opt_state[1][0]["nu"])):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_both_r2_train_state_restores_into_the_port():
    """The committed both_r2 tarball's whole train state (678 leaves:
    params, batch_stats, Adam's clip / moments / counts, step) restores
    into the port's TacotronTask at step 106,000; its params and
    batch_stats equal the serving path's, Adam's counts are the step."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "both_r2.ckpt.tar.gz")
    cfg = PC.load_config(path)
    task = PTT.TacotronTask(cfg, is_randomly_initialized=True, device="cpu")
    state, start = restore_into_state(task.init_state(0), path, None,
                                      task.from_jax_tree)
    assert start == 106000 and int(state.step) == 106000
    assert state.opt_state[0] == ()
    assert int(state.opt_state[1][0]["count"]) == 106000
    assert int(state.opt_state[1][1]["count"]) == 106000
    with CheckpointReader(path) as reader:
        tree = reader.restore(items=("params", "batch_stats"))
    want = convert.tacotron_params_from_jax(cfg.tacotron, tree["params"],
                                            tree["batch_stats"])
    for k, v in {**state.params, **state.batch_stats}.items():
        assert torch.equal(v, want[k]), k
    n = sum(v.numel() for v in state.params.values())
    assert n == 7_063_715
    assert all(bool((v >= 0).all()) for v in state.opt_state[1][0]["nu"]
               .values())


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------

def write_corpus(root, name, n, seed, frames=(12, 140), tokens=(6, 40)):
    """``n`` synthetic npz examples in ``root/name``: tokens ending in EOS,
    mel / linear of random lengths, a loss_coeff."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        f = int(rng.integers(*frames))
        k = int(rng.integers(*tokens))
        tok = np.append(rng.integers(2, 70, k - 1), 1).astype(np.int32)
        np.savez(os.path.join(d, f"{name}.{i:04d}.npz"), tokens=tok,
                 mel=rng.standard_normal((f, 80)).astype(np.float32),
                 linear=rng.standard_normal((f, 1025)).astype(np.float32),
                 loss_coeff=np.float32(rng.uniform(0.5, 1.5)))
    return d


BATCHER = dict(initial_phase_step=3, main_data_greedy_factor=1.0,
               main_data=("spk_a",), min_iters=3, min_tokens=8,
               max_iters=25, batch_size=3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("taco_corpus"))
    return [write_corpus(root, "spk_a", 14, 0),
            write_corpus(root, "son_b", 9, 1)]


def _batcher_cfg(**train):
    return full_cfg(dataclasses.replace(CFG, **BATCHER),
                    num_test_per_speaker=2, **train)


def test_scan_npz_dir_matches_jax(corpus):
    """Frame and token filter, the son blacklist (``.0000.``, ``.0001.``)."""
    cfg = _batcher_cfg()
    for d in corpus:
        for flt in (True, False):
            got = PL.scan_npz_dir(d, cfg, flt)
            assert got == JL.scan_npz_dir(d, jax_full_cfg(cfg), flt)
    kept = PL.scan_npz_dir(corpus[1], cfg)
    assert not any(".0000." in p or ".0001." in p for p in kept)
    assert len(kept) < len(PL.scan_npz_dir(corpus[1], cfg, False))


def _as_numpy(b):
    if isinstance(b, dict):
        return {k: np.asarray(v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in b.items()}
    return {k: getattr(b, k) for k in PTT.BATCH_KEYS}


@pytest.mark.parametrize("store", [False, True], ids=["host", "store"])
def test_tacotron_batcher_matches_jax(corpus, store):
    """12 training batches across the curriculum's switch (step 3) to the
    greedy ratios, equal to JAX's draw for draw (the store's float16
    targets too), padded to the token and frame buckets; the test stream's
    fixed batch equal to JAX's."""
    cfg = _batcher_cfg()
    jcfg = jax_full_cfg(cfg)
    port = iter(PL.TacotronBatcher(corpus, cfg, device_store=store,
                                   device="cpu"))
    ref = iter(JL.TacotronBatcher(corpus, jcfg, device_store=store))
    for _ in range(12):
        got, want = _as_numpy(next(port)), _as_numpy(next(ref))
        for k in PTT.BATCH_KEYS:
            np.testing.assert_array_equal(got[k], want[k], k)
        assert got["inputs"].shape[1] % 16 == 0
        assert got["mel_targets"].shape[1] % 50 == 0
        assert got["mel_targets"].shape[1] > max(
            np.abs(got["mel_targets"]).sum(-1).nonzero()[1])
        if store:
            assert got["mel_targets"].dtype == np.float16
    got = _as_numpy(next(iter(PL.TacotronBatcher(corpus, cfg, "test"))))
    want = _as_numpy(next(iter(JL.TacotronBatcher(corpus, jcfg, "test"))))
    for k in PTT.BATCH_KEYS:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_tacotron_store_matches_the_host_path(corpus):
    """The store serves the host path's batches (targets rounded to
    float16), and refuses the test stream."""
    cfg = _batcher_cfg()
    host = iter(PL.TacotronBatcher(corpus, cfg))
    st = PL.TacotronBatcher(corpus, cfg, device_store=True, device="cpu")
    assert st.store_bytes > 0
    store = iter(st)
    for _ in range(6):
        h = PTT.batch_to_device(next(host), "cpu", "float16")
        s = next(store)
        assert set(s) == set(h)
        for k in h:
            assert s[k].dtype == h[k].dtype and torch.equal(s[k], h[k]), k
    with pytest.raises(ValueError):
        PL.TacotronBatcher(corpus, cfg, "test", device_store=True)


def test_batch_to_device_rounds_targets_as_jax(corpus):
    b = next(iter(PL.TacotronBatcher(corpus, _batcher_cfg())))
    got = PTT.batch_to_device(b, "cpu", "float16")
    want = JTT.batch_to_dict(b, "float16")
    for k in PTT.BATCH_KEYS:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(
                                          got[k].numpy().dtype), k)
    assert got["mel_targets"].dtype == torch.float16
    assert PTT.batch_to_device(b, "cpu")["mel_targets"].dtype == torch.float32
