"""PyTorch port: training through each attention mechanism and the
``simple`` speaker mode against the JAX package (CPU).

The teacher-forced loss and its gradient, for each of the nine
mechanisms with ``deepvoice`` speakers and for ``simple`` speakers, at the
widths of tests/test_torch_attention.py with ``dropout_prob=0`` (both
sides deterministic), and gmm's at the both_r2 width, where its f32
gradient is ill-conditioned.  The same numpy-seeded weights, statistics
and batch go to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tacotron_wavenet_vocoder_korean_tpu.models import modules as JM
from tacotron_wavenet_vocoder_korean_tpu.train import tacotron_task as JTT
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    tacotron_task as PTT)
from test_torch_attention import CONFIGS, config
from test_torch_tacotron import _random_variables
from test_torch_tacotron_train import (GRAD_NORM_TOL, full_cfg, jax_full_cfg,
                                       jbatch, make_batch, pbatch)
from torch_port_util import plain

# Of each leaf's largest |gradient|: the mechanism's leaves, and every
# other leaf.  A training-mode batch norm's backward divides the
# convolutions' rounding by the batch's deviation, and that reaches every
# leaf upstream of the post-net (observed up to 1.1e-4, on gmm's
# post-net batch norm, whose input frames reach ~50; 6.4e-5 on bah_mon's;
# the mechanism's leaves <= 9.7e-6).  The whole gradient is held to
# GRAD_NORM_TOL (1e-5) in the L2 norm, observed <= 4.5e-6.
MECH_GRAD_TOL = 3e-5
LEAF_GRAD_TOL = 3e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_gradient_matches_jax(name):
    """d loss / d params in training mode, T_out = 30 (6 decoder steps):
    the loss within 1e-5 (observed <= 1.9e-6), the whole gradient within
    GRAD_NORM_TOL relative in the L2 norm, each leaf as stated above; the
    two conv biases that feed a training-mode batch norm directly (a
    gradient of 0 in exact arithmetic) within 1e-7 of the largest
    |gradient| of all leaves."""
    t_cfg = dataclasses.replace(config(name), dropout_prob=0.0)
    cfg = full_cfg(t_cfg)
    variables = _random_variables(t_cfg, True, 9)
    b = make_batch(T_out=30)
    jtask = JTT.TacotronTask(jax_full_cfg(cfg))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]),
            jax.tree.map(jnp.asarray, variables["batch_stats"]), jbatch(b),
            jax.random.PRNGKey(0))
    task = PTT.TacotronTask(cfg, device="cpu")
    state = task.state_from_tensors(convert.tacotron_params_from_jax(
        t_cfg, variables["params"], variables["batch_stats"]))
    losses, grads, _ = task.grads(state.params, state.batch_stats, pbatch(b))
    np.testing.assert_allclose(float(losses["loss"]), float(jloss), rtol=0,
                               atol=1e-5)
    model = task.model
    want = convert.state_from_jax(model, JM.fuse_gru_params(plain(jgrads)),
                                  None, convert.tacotron_scopes(model))
    assert set(want) == set(grads)
    assert any(k.startswith("decoder.step.attention.") for k in want)
    top = max(float(w.abs().max()) for w in want.values())
    diff = sum(float(((grads[k] - w) ** 2).sum()) for k, w in want.items())
    norm = sum(float((w ** 2).sum()) for w in want.values())
    assert diff ** 0.5 <= GRAD_NORM_TOL * norm ** 0.5
    for k, w in want.items():
        err = float((grads[k] - w).abs().max())
        if k.endswith("proj_2.conv.bias"):
            assert err <= 1e-7 * top, (k, err)
            continue
        tol = (MECH_GRAD_TOL if k.startswith("decoder.step.attention.")
               else LEAF_GRAD_TOL)
        assert err <= tol * float(w.abs().max()), (k, err)


def test_gmm_gradient_at_the_both_r2_width():
    """gmm at the both_r2 widths, seeded weights (flax's init), f32,
    dropout off, B = 2, T_out 50: the loss within 1e-5 relative of JAX's
    (observed 1.9e-7), the whole gradient within 1e-2 in the L2 norm
    (observed 9.0e-4; 2.1e-3 on another batch).  The unnormalised
    alignments give a loss of ~100 there (chip_smoke.py's attention
    phase (c); the other mechanisms' ~1.7) and the f32 gradient is
    ill-conditioned: the port's own CPU gradient
    moves by ~6e-3 when oneDNN's convolutions are switched off, and the
    card's is ~6e-3 from the CPU's (tests/test_torch_cuda.py and
    chip_smoke.py bound that at 2e-2)."""
    t_cfg = dataclasses.replace(PC.BOTH_R2, attention_type="gmm",
                                compute_dtype="float32", dropout_prob=0.0)
    cfg = full_cfg(t_cfg)
    params, stats = convert.seeded_tacotron_tree(t_cfg, 0)
    b = make_batch(T_out=50)
    jtask = JTT.TacotronTask(jax_full_cfg(cfg))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, convert._nest(params)),
            jax.tree.map(jnp.asarray, convert._nest(stats)), jbatch(b),
            jax.random.PRNGKey(0))
    task = PTT.TacotronTask(cfg, device="cpu")
    state = task.state_from_tensors(convert.tacotron_params_from_jax(
        t_cfg, params, stats))
    losses, grads, _ = task.grads(state.params, state.batch_stats, pbatch(b))
    np.testing.assert_allclose(float(losses["loss"]), float(jloss),
                               rtol=1e-5)
    model = task.model
    want = convert.state_from_jax(model, JM.fuse_gru_params(plain(jgrads)),
                                  None, convert.tacotron_scopes(model))
    diff = sum(float(((grads[k] - w).double() ** 2).sum())
               for k, w in want.items())
    norm = sum(float((w.double() ** 2).sum()) for w in want.values())
    assert diff ** 0.5 <= 1e-2 * norm ** 0.5
