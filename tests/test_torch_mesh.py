"""PyTorch port: the mesh (``parallel/``), WaveNet's tensor-parallel step,
Tacotron's data-parallel step and the batchers' rows, against the JAX
package (CPU).

Ranks are spawned processes on gloo (``torch_mesh_workers.Ranks``, each
with its own join timeout); the JAX side runs on the conftest's virtual
CPU devices meanwhile.  Where a test needs only a rank's coordinates (the
placements, the batchers, the draws) it builds a ``Mesh`` without
process groups.  The same numpy-seeded weights, moments and batches go to
both packages; tolerances are stated per test.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.parallel import (
    make_mesh as jax_make_mesh, shard_batch, tree_shardings)
from tacotron_wavenet_vocoder_korean_tpu.train import wavenet_task as JWT
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
    TacotronBatcher, WaveNetBatcher)
from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
    Mesh, mesh_ranks, tree_placements)
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    tacotron_task as PTT)
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    wavenet_task as PWT)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointReader)
from test_torch_tacotron_train import (
    CFG as TACO_CFG, STEP_LOSS_TOL, STEP_PARAM_TOL, _states, leaf_errors,
    make_batch, write_corpus)
from test_torch_wavenet_train import CASES, TOL, _leaf_err
from torch_mesh_workers import Ranks, tacotron_step, wavenet_step
from torch_port_util import plain, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WN_MOON = os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz")
# The port's TP (and DP) gradient against its own one-process gradient, of
# each leaf's largest |value|: only the order of the sums differs.  1e-6
# holds but for the upsampler's kernels, whose gradient sums every position
# and channel of the stack's input gradient with cancellation (observed
# 1.53e-6 on upsample_1 at (1, 2), the other leaves <= 4e-7).
TP_GRAD_TOL = 3e-6


def fake_mesh(n_data, n_model, rank=0) -> Mesh:
    """A rank's place in a mesh, without process groups."""
    return Mesh(n_data * n_model, rank, n_data, n_model, "gloo",
                torch.device("cpu"), None, None)


def keystr_leaves(tree, path=""):
    """(``jax.tree_util.keystr`` of the path, leaf) of a tree of dicts,
    tuples and named tuples, a ``P`` counted as a leaf."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import P
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keystr_leaves(tree[k], f"{path}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from keystr_leaves(v, f"{path}.{f}")
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            yield from keystr_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# The mesh's order and the placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_order_is_jax_device_order(shape):
    devices = jax_make_mesh(*shape).devices
    ids = np.vectorize(lambda d: d.id)(devices)
    assert np.array_equal(mesh_ranks(*shape), ids)
    for r in range(8):
        assert fake_mesh(*shape, rank=r).coords == tuple(
            int(i) for i in np.argwhere(ids == r)[0])


def _jax_wavenet_state(cfg, B=1, T=None):
    jcfg = JC.Config(wavenet=cfg, audio=JC.AudioConfig(hop_size=int(
        np.prod(cfg.upsample_factor))))
    hop = jcfg.audio.hop_size
    T = T or 4 * hop
    batch = {"input_wav": np.zeros((B, T, 1), np.float32),
             "local_condition": np.zeros((B, T // hop, 80), np.float32),
             "speaker_id": np.zeros((B,), np.int32)}
    task = JWT.WaveNetTask(jcfg)
    return jcfg, task, task.abstract_state(jax.random.PRNGKey(0), batch)


def _wn_moon_cfg():
    with CheckpointReader(WN_MOON) as r:
        return JC.from_dict(PC.to_dict(r.config())).wavenet


@pytest.mark.parametrize("which", ["tiny", "tiny_wn", "wn_moon",
                                   "wn_moon_wn"])
def test_tree_placements_match_jax(which):
    """``tree_placements`` over JAX's whole train state (params, EMA, Adam
    moments, counts; ``jax.eval_shape``) equals ``tree_shardings(
    make_mesh(4, 2), state, WAVENET_TP_RULES)`` leaf by leaf, with and
    without weight norm; and the port's task places its own state's
    parameters, EMA and moments as JAX places them."""
    base = CASES["raw"] if which.startswith("tiny") else _wn_moon_cfg()
    cfg = dataclasses.replace(base, weight_normalization=which.endswith(
        "_wn"), clip_gradients=True)
    _, _, abstract = _jax_wavenet_state(cfg)
    jax_specs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                 jax.tree_util.tree_flatten_with_path(tree_shardings(
                     jax_make_mesh(4, 2), abstract,
                     JWT.WAVENET_TP_RULES))[0]}
    mesh = fake_mesh(4, 2)
    got = dict(keystr_leaves(tree_placements(mesh, abstract,
                                             PWT.WAVENET_TP_RULES)))
    assert {k: tuple(v) for k, v in got.items()} == jax_specs
    assert any(jax_specs.values())

    task = PWT.WaveNetTask(PC.Config(wavenet=port_cfg(cfg), audio=PC.AudioConfig(
        hop_size=int(np.prod(cfg.upsample_factor)))), device="cpu", mesh=mesh)
    pl = task.placements
    trees = {".params": pl.params, ".ema_params": pl.ema_params,
             ".opt_state[1][0].mu": pl.opt_state[1][0]["mu"],
             ".opt_state[1][0].nu": pl.opt_state[1][0]["nu"]}
    for prefix, tree in trees.items():
        for name, spec in tree.items():
            key = prefix + "".join(f"['{k}']" for k in name.split("/"))
            assert tuple(spec) == jax_specs[key], key
    assert task.sharded == {k for k, v in pl.params.items() if any(v)}


def test_backend_rule():
    from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
        choose_backend)
    assert choose_backend(torch.device("cpu"), 1) == "gloo"
    assert choose_backend(torch.device("cpu"), 4) == "gloo"


# ---------------------------------------------------------------------------
# WaveNet: tensor parallel (and data parallel) step against JAX's mesh step
# ---------------------------------------------------------------------------

WN_CFG = dataclasses.replace(CASES["quantized"], weight_normalization=True,
                             l2_regularization_strength=0.01,
                             clip_gradients=True, ema_decay=0.9)
WN_B = 4


def _wavenet_setup():
    """JAX's state at step 1000 with Adam's moments as a resumed run has
    them (as tests/test_torch_wavenet_train.py sets them), and a global
    batch of 4."""
    jcfg = JC.Config(wavenet=WN_CFG, audio=JC.AudioConfig(hop_size=10))
    rng = np.random.RandomState(3)
    batch = {"input_wav": rng.randint(0, WN_CFG.quantization_channels,
                                      (WN_B, 120, 1)).astype(np.float32),
             "local_condition": rng.randn(WN_B, 12, 80).astype(np.float32),
             "speaker_id": np.zeros(WN_B, np.int32)}
    jtask = JWT.WaveNetTask(jcfg)
    jstate = jtask.init_state(jax.random.PRNGKey(0), batch)
    mrng = np.random.RandomState(4)
    moment = lambda scale, sq: jax.tree.map(lambda p: jnp.asarray(
        (mrng.standard_normal(p.shape) * scale) ** (2 if sq else 1),
        jnp.float32), jstate.params)
    count = jnp.asarray(1000, jnp.int32)
    clip, (adam, sched) = jstate.opt_state
    jstate = jstate._replace(step=count, opt_state=(clip, (
        adam._replace(count=count, mu=moment(1e-3, False),
                      nu=moment(1e-2, True)), sched._replace(count=count))))
    return jtask, jstate, batch


def test_wavenet_tensor_parallel_step_matches_jax_mesh_step():
    """One step on (n_data, n_model) = (1, 2) over 2 ranks and (2, 2) over
    4, at TINY with the softmax head, weight norm, L2 and the clip:
    against JAX's ``jit_train_step(make_mesh(n_data, n_model))`` on the
    same global batch, loss, l2_loss, learning rate and grad_norm within
    1e-5 relative, the new params, EMA and Adam moments within 1e-5 of
    each leaf's largest (the bounds of the one-step test in
    tests/test_torch_wavenet_train.py); the gathered gradient within 1e-6
    of each leaf's largest of the port's one-process gradient; the skip
    kernels and biases held as S / 2 columns and post_1 as S / 2 rows
    after the step."""
    jtask, jstate, batch = _wavenet_setup()
    tree = plain(jstate)
    pcfg = PC.Config(wavenet=port_cfg(WN_CFG),
                     audio=PC.AudioConfig(hop_size=10))
    shapes = {(1, 2): 2, (2, 2): 4}
    ranks = {s: Ranks(wavenet_step, w, pcfg, tree, batch, *s)
             for s, w in shapes.items()}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {}
    for (n_data, n_model) in shapes:
        mesh = jax_make_mesh(n_data, n_model)
        state = jtask.shard_state(mesh, jax.tree.map(jnp.copy, jstate))
        new, m = jtask.jit_train_step(mesh)(state, shard_batch(mesh, jb))
        want[n_data, n_model] = (plain(new), {k: float(v)
                                             for k, v in m.items()})
    ptask = PWT.WaveNetTask(pcfg, device="cpu")
    pstate = convert.from_jax_tree(ptask.init_state(0), tree)
    _, one = ptask.grads(pstate.params,
                         PWT.batch_to_device(batch, torch.device("cpu")))

    S = WN_CFG.skip_channels
    for shape, r in ranks.items():
        outs = r.results()
        jnew, jm = want[shape]
        for out in outs:
            assert set(out["metrics"]) == set(jm)
            for k in jm:
                np.testing.assert_allclose(out["metrics"][k], jm[k],
                                           rtol=TOL, err_msg=f"{shape} {k}")
        got = outs[-1]["tree"]
        for part in ("params", "ema_params"):
            assert _leaf_err(convert.flatten(got[part]),
                             convert.flatten(jnew[part])) <= TOL, part
        for part in ("mu", "nu"):
            assert _leaf_err(
                convert.flatten(got["opt_state"][1][0][part]),
                convert.flatten(jnew["opt_state"][1][0][part])) <= TOL, part
        assert int(got["step"]) == 1001
        grad_err = {k: float(np.abs(outs[-1]["grads"][k] - g.numpy()).max()
                             / np.abs(g.numpy()).max())
                    for k, g in one.items() if g.abs().max() > 0}
        worst = max(grad_err, key=grad_err.get)
        assert grad_err[worst] <= TP_GRAD_TOL, (shape, worst, grad_err[worst])
        sh = outs[0]["shapes"]
        assert sh["layer_0_skip_kernel_v"] == (WN_CFG.dilation_channels,
                                               S // 2)
        assert sh["layer_0_skip_bias"] == (S // 2,)
        assert sh["post_1_kernel_v"] == (S // 2, S)
        assert sh["post_1_kernel_g"] == sh["post_2_kernel_v"][:1] == (S,)


# ---------------------------------------------------------------------------
# Tacotron: data parallel step, batch norm over the whole batch
# ---------------------------------------------------------------------------

def _taco_batch():
    """A global batch of 4: two of test_torch_tacotron_train's batches."""
    a, b = make_batch(seed=20), make_batch(seed=21)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def test_tacotron_data_parallel_step_matches_jax_and_needs_global_bn():
    """One step over 2 ranks from a resumed state (dropout 0, batch norm in
    training mode) against JAX's step on the same global batch (its own
    tests show its mesh step equals it): the metrics within 1e-5
    relative, the params and Adam's moments within 1e-5 of each leaf's
    largest, the batch_stats within 1e-6 (the bounds of
    tests/test_torch_tacotron_train.py).  The same step with each rank's
    batch norm over its own rows parts from JAX by more than 10x those
    bounds."""
    jtask, jstate, task, _ = _states(TACO_CFG)
    batch = _taco_batch()
    cfg = PC.Config(tacotron=TACO_CFG)
    tree = plain(jstate)
    good = Ranks(tacotron_step, 2, cfg, tree, batch)
    bad = Ranks(tacotron_step, 2, cfg, tree, batch, True)
    jnew, jm = jax.jit(jtask.train_step)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    adam = jnew.opt_state[1][0]
    scopes = convert.tacotron_scopes(task.model)
    stats = convert.flatten(plain(jnew.batch_stats))

    def errors(out):
        t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
        metric = max(abs(out["metrics"][k] - float(jm[k]))
                     / abs(float(jm[k])) for k in jm if float(jm[k]))
        param = max(max(leaf_errors(t(out[part]), getattr(adam, part)
                                    if part != "params" else jnew.params,
                                    TACO_CFG).values())
                    for part in ("params", "mu", "nu"))
        stat = max(float(np.abs(v - stats[convert._jax_key(k, scopes)[1]])
                         .max()) for k, v in out["batch_stats"].items())
        return metric, param, stat

    for out in good.results():
        assert set(out["metrics"]) == {k for k in jm}
        metric, param, stat = errors(out)
        assert metric <= STEP_LOSS_TOL, metric
        assert param <= STEP_PARAM_TOL, param
        assert stat <= 1e-6, stat
    for out in bad.results():
        metric, param, stat = errors(out)
        assert metric > 10 * STEP_LOSS_TOL, metric
        assert param > 10 * STEP_PARAM_TOL, param
        assert stat > 10 * 1e-6, stat


@pytest.mark.parametrize("n_data", [2, 4])
def test_tacotron_draws_are_rows_of_the_global_draws(n_data):
    """With dropout and scheduled sampling each rank's masks are its rows
    of the masks one process draws for the global batch from the same
    generator seed."""
    t_cfg = dataclasses.replace(TACO_CFG, dropout_prob=0.5,
                                scheduled_sampling=True, ss_start_step=0)
    cfg = PC.Config(tacotron=t_cfg)
    batch = PTT.batch_to_device(_taco_batch(), "cpu")
    step = torch.tensor(5000, dtype=torch.int32)
    one = PTT.TacotronTask(cfg, device="cpu").draw(
        batch, torch.Generator().manual_seed(7), step)
    n = 4 // n_data
    for d in range(n_data):
        task = PTT.TacotronTask(cfg, mesh=fake_mesh(n_data, 1, rank=d))
        local = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
        got = task.draw(local, torch.Generator().manual_seed(7), step)
        rows = slice(d * n, (d + 1) * n)
        assert set(got) == set(one) == {"encoder_prenet_masks",
                                        "prenet_masks", "use_teacher"}
        for a, b in zip(got["encoder_prenet_masks"],
                        one["encoder_prenet_masks"]):
            assert torch.equal(a, b[rows])
        for a, b in zip(got["prenet_masks"], one["prenet_masks"]):
            assert torch.equal(a, b[:, rows])
        assert torch.equal(got["use_teacher"], one["use_teacher"][:, rows])


# ---------------------------------------------------------------------------
# Batchers: a rank's batch is its rows of the one-process batch
# ---------------------------------------------------------------------------

def _wavenet_corpus(root, n=8, hop=10, seed=0):
    d = os.path.join(root, "wn")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        f = int(rng.integers(30, 60))
        np.savez(os.path.join(d, f"clip.{i:04d}.npz"),
                 audio=rng.uniform(-1, 1, f * hop).astype(np.float32),
                 mel=rng.standard_normal((f, 80)).astype(np.float32),
                 time_steps=np.int64(f * hop))
    return d


def _as_numpy(b):
    if isinstance(b, dict):
        return {k: v.cpu().numpy() for k, v in b.items()}
    return {k: np.asarray(v) for k, v in vars(b).items()}


@pytest.mark.parametrize("store", [False, True], ids=["host", "store"])
def test_batchers_serve_each_rank_its_rows(tmp_path, store):
    """WaveNetBatcher (B = 4) and TacotronBatcher (B = 4, two speaker
    dirs) on a (2, 1) mesh: rank d's batch equals rows [2d, 2d + 2) of
    the one-process batch, over several batches (the Tacotron batch
    padded to the global batch's bucket); B % n_data != 0 raises."""
    wn_dir = _wavenet_corpus(str(tmp_path))
    cfg = PC.Config(wavenet=dataclasses.replace(port_cfg(CASES["raw"]),
                                                batch_size=4),
                    audio=PC.AudioConfig(hop_size=10),
                    train=PC.TrainConfig(num_test_per_speaker=1))
    dirs = [write_corpus(str(tmp_path), name, 8, seed, frames=(16, 45),
                         tokens=(8, 16))
            for seed, name in enumerate(("spk_a", "spk_b"))]
    tcfg = PC.Config(tacotron=dataclasses.replace(
        TACO_CFG, batch_size=4, min_iters=2, min_tokens=4),
        train=PC.TrainConfig(num_test_per_speaker=1))
    make = {
        "wavenet": lambda mesh: WaveNetBatcher(
            [wn_dir], cfg, seed=5, batches_per_group=2, device_store=store,
            device="cpu", mesh=mesh),
        "tacotron": lambda mesh: TacotronBatcher(
            dirs, tcfg, seed=5, batches_per_group=2, device_store=store,
            device="cpu", mesh=mesh),
    }
    for name, build in make.items():
        whole = iter(build(None))
        ranks = [iter(build(fake_mesh(2, 1, rank=d))) for d in range(2)]
        for _ in range(5):
            want = _as_numpy(next(whole))
            for d, it in enumerate(ranks):
                got = _as_numpy(next(it))
                assert set(got) == set(want), name
                for k, v in want.items():
                    np.testing.assert_array_equal(got[k], v[2 * d:2 * d + 2],
                                                  err_msg=f"{name} {k}")
        with pytest.raises(ValueError, match="does not split"):
            build(fake_mesh(3, 1))
