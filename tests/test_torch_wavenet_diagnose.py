"""PyTorch port: ``scripts/wavenet_diagnose.py`` (CPU).

The port's command on ``--device cpu`` against the JAX system's
``scripts/wavenet_diagnose.py`` (loaded with importlib, ``main()`` under a
patched ``sys.argv``) on one TINY WaveNet run dir and the moon dir of a
small corpus of committed clips preprocessed by the port.  Both draw the
same held-out crops (the batchers are held draw for draw in
tests/test_torch_data.py); each crop's mixture draw takes its uniforms
from one seeded numpy sampler on both sides (the port's ``mol_uniforms``
and JAX's sampler replaced).  Correlation and MAE are held within 1e-4
(both print 4 decimals; observed: equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu.models import mixture as JM
from tacotron_wavenet_vocoder_korean_tpu_torch.scripts import (
    wavenet_diagnose as PD)
from torch_eval_util import (STEP, last_json, load_jax_script, make_corpus,
                             run_jax, same_keys, wavenet_run)

JD = load_jax_script("wavenet_diagnose")
TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("diagnose"))
    moon, _ = make_corpus(root)
    return {"moon": moon, "run": wavenet_run(f"{root}/wn")}


def numpy_uniforms(shape, nr_mix: int, seed: int):
    rng = np.random.default_rng(seed)
    lo, hi = 1e-5, 1.0 - 1e-5
    return (rng.uniform(lo, hi, tuple(shape) + (nr_mix,)).astype(np.float32),
            rng.uniform(lo, hi, tuple(shape)).astype(np.float32))


def jax_sampler(rng, y, log_scale_min=JM.LOG_SCALE_MIN):
    """JAX's ``sample_from_discretized_mix_logistic`` with the uniforms of
    ``numpy_uniforms`` seeded by the key's counter (``PRNGKey(i + 1)``)."""
    nr_mix = y.shape[-1] // 3
    u_sel, u = numpy_uniforms(y.shape[:-1], nr_mix, int(np.asarray(rng)[-1]))
    sel_idx = jnp.argmax(y[..., :nr_mix] - jnp.log(-jnp.log(u_sel)), axis=-1)
    sel = jax.nn.one_hot(sel_idx, nr_mix, dtype=y.dtype)
    means = jnp.sum(y[..., nr_mix:2 * nr_mix] * sel, axis=-1)
    log_scales = jnp.maximum(
        jnp.sum(y[..., 2 * nr_mix:3 * nr_mix] * sel, axis=-1), log_scale_min)
    x = means + jnp.exp(log_scales) * (jnp.log(u) - jnp.log(1.0 - u))
    return jnp.clip(x, -1.0, 1.0)


@pytest.mark.parametrize("n_crops,seed", [(4, 7), (3, 11)])
def test_wavenet_diagnose_matches_jax(setup, n_crops, seed, monkeypatch,
                                      capsys):
    monkeypatch.setattr(JM, "sample_from_discretized_mix_logistic",
                        jax_sampler)
    monkeypatch.setattr(PD, "mol_uniforms", lambda shape, nr, s: tuple(
        torch.from_numpy(u) for u in numpy_uniforms(shape, nr, s)))
    args = ["--wavenet", setup["run"], "--data", setup["moon"], "--n_crops",
            str(n_crops), "--seed", str(seed)]
    want = run_jax(JD, args, monkeypatch, capsys)
    got = PD.main([*args, "--device", "cpu"])
    assert last_json(capsys) == got
    same_keys(got, want)
    assert set(got) == PD.RESULT_KEYS
    assert (got["step"], got["n_crops"]) == (want["step"], want["n_crops"])
    assert got["step"] == STEP and len(got["per_crop_corr"]) == n_crops
    for k in ("one_step_ahead_corr", "one_step_ahead_mae"):
        assert abs(got[k] - want[k]) <= TOL + 1e-9, (k, got[k], want[k])
    np.testing.assert_allclose(got["per_crop_corr"], want["per_crop_corr"],
                               rtol=0, atol=TOL + 1e-9)
    assert got["healthy"] == want["healthy"]


def test_mol_uniforms_come_from_a_seeded_cpu_generator():
    """Crop i's uniforms: one CPU draw of nr_mix + 1 per position from a
    generator seeded i + 1, whatever device the command runs on."""
    u_sel, u = PD.mol_uniforms((1, 9), 10, 3)
    assert u_sel.shape == (1, 9, 10) and u.shape == (1, 9)
    assert u_sel.device.type == u.device.type == "cpu"
    whole = torch.rand((1, 9, 11), generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.cat([u_sel, u[..., None]], -1), whole)
    again = PD.mol_uniforms((1, 9), 10, 3)
    assert torch.equal(again[0], u_sel) and torch.equal(again[1], u)
    assert not torch.equal(PD.mol_uniforms((1, 9), 10, 4)[1], u)
