"""PyTorch port: Tacotron free-run inference against the JAX package.

Every ported module (fused GRU cell and GRU, prenet, highway, batch-normed
conv, CBHG, monotonic attention; the other mechanisms are in
tests/test_torch_attention.py), the converter, the whole deterministic
decode (TINY and the full ``both_r2`` width), bf16, manual alignments and
the synthesizer's mel half are fed the same numpy-seeded inputs and
weights on both sides.  Tolerances are stated per test; the observed
errors (float32, on a CPU) are noted beside them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.models import attention as JA
from tacotron_wavenet_vocoder_korean_tpu.models import modules as JM
from tacotron_wavenet_vocoder_korean_tpu.models.tacotron import Tacotron as JTacotron
from tacotron_wavenet_vocoder_korean_tpu.synth import synthesizer as JSyn
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.models import attention as PA
from tacotron_wavenet_vocoder_korean_tpu_torch.models import modules as PM
from tacotron_wavenet_vocoder_korean_tpu_torch.models.tacotron import Tacotron
from tacotron_wavenet_vocoder_korean_tpu_torch.synth import synthesizer as PSyn

REPO_TARBALL = "artifacts/both_r2.ckpt.tar.gz"
F32_MODULE_TOL = 1e-5

# tests/test_tacotron.py's tiny widths, with two deepvoice speakers and the
# fused GRUs the checkpoints serve.
TINY = PC.TacotronConfig(
    enc_bank_size=4, enc_bank_channel_size=32, enc_rnn_size=32,
    enc_prenet_sizes=(64, 32), enc_proj_sizes=(32, 32),
    attention_size=32, attention_state_size=32,
    dec_rnn_size=32, dec_prenet_sizes=(64, 32),
    post_bank_size=2, post_bank_channel_size=32, post_rnn_size=32,
    post_proj_sizes=(64, 80), embedding_size=32, max_iters=30,
    num_speakers=2, model_type="deepvoice", fused_rnn=True)
AUDIO = PC.AudioConfig()


def jax_cfg(cfg: PC.TacotronConfig) -> JC.TacotronConfig:
    return JC.TacotronConfig(**dataclasses.asdict(cfg))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def perturb(tree, rng, scale=0.1):
    """Every leaf moved off its init value (biases and scales too), so a
    dropped or misplaced term shows."""
    return jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            np.shape(a)).astype(np.float32), tree)


def random_stats(stats, rng):
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                   if np.all(np.asarray(a) == 0)
                   else np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                   ).astype(np.float32), stats)


def load(module, params, stats=None, scopes=None):
    module.load_state_dict(convert.state_from_jax(module, params, stats,
                                                  scopes))
    return module.eval()


def close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Modules, float32: <= 1e-5 (observed <= ~1e-6)
# ---------------------------------------------------------------------------

def test_fused_gru_cell_matches_jax():
    rng = np.random.default_rng(0)
    h, x = rng.standard_normal((3, 16)), rng.standard_normal((3, 24))
    h, x = h.astype(np.float32), x.astype(np.float32)
    params = JM.FusedGRUCell(features=16).init(
        jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))["params"]
    params = perturb(params, rng)
    want, _ = JM.FusedGRUCell(features=16).apply({"params": params},
                                                 jnp.asarray(h), jnp.asarray(x))
    cell = load(PM.FusedGRUCell(24, 16), params)
    close(cell(t(h), t(x)), want, F32_MODULE_TOL)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("with_state", [False, True], ids=["h0=0", "h0"])
def test_gru_matches_jax(reverse, with_state):
    """Ragged seq_lengths: the forward direction runs through padding
    unmasked, the reverse flips within each row's length."""
    rng = np.random.default_rng(1)
    B, T, D, H = 3, 9, 12, 16
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([9, 5, 2], np.int32)
    h0 = (rng.standard_normal((B, H)).astype(np.float32)
          if with_state else None)
    mod = JM.GRU(H, reverse=reverse, fused=True)
    args = dict(seq_lengths=jnp.asarray(lengths),
                initial_state=None if h0 is None else jnp.asarray(h0))
    params = perturb(mod.init(jax.random.PRNGKey(2), jnp.asarray(x),
                              **args)["params"], rng)
    want = mod.apply({"params": params}, jnp.asarray(x), **args)
    gru = load(PM.GRU(D, H, reverse=reverse), params)
    got = gru(t(x), t(lengths).long(), None if h0 is None else t(h0))
    close(got, want, F32_MODULE_TOL)


def test_flip_sequences_is_flax_flip():
    from flax.linen.recurrent import flip_sequences
    x = np.arange(2 * 6 * 1, dtype=np.float32).reshape(2, 6, 1)
    lengths = np.array([4, 6])
    want = flip_sequences(jnp.asarray(x), jnp.asarray(lengths),
                          num_batch_dims=1, time_major=False)
    np.testing.assert_array_equal(
        PM.flip_sequences(t(x), t(lengths)).numpy(), np.asarray(want))


def test_prenet_deterministic_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 20)).astype(np.float32)
    mod = JM.Prenet((32, 16))
    params = perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              True)["params"], rng)
    want = mod.apply({"params": params}, jnp.asarray(x), True)
    close(load(PM.Prenet(20, (32, 16)), params)(t(x)), want, F32_MODULE_TOL)


def test_prenet_dropout_with_shared_masks_matches_jax():
    """Keep-masks taken from one JAX apply with a dropout rng (a unit is
    kept where the dropout layer's output is not 0; where the relu gave 0,
    the mask cannot matter) and fed to the port: equal outputs."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 20)).astype(np.float32)
    mod = JM.Prenet((32, 16), dropout_rate=0.5)
    params = perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              True)["params"], rng)
    want, state = mod.apply(
        {"params": params}, jnp.asarray(x), False,
        rngs={"dropout": jax.random.PRNGKey(7)}, capture_intermediates=True,
        mutable=["intermediates"])
    inter = state["intermediates"]
    masks = [t(np.asarray(inter[f"dropout_{i}"]["__call__"][0]) != 0)
             for i in (1, 2)]
    assert 0.2 < float(masks[0].float().mean()) < 0.6   # dropout was live
    net = load(PM.Prenet(20, (32, 16), dropout_rate=0.5), params)
    close(net(t(x), net.scales_from_masks(masks)), want, F32_MODULE_TOL)


def test_highway_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    mod = JM.HighwayLayer()
    params = perturb(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                     rng)
    want = mod.apply({"params": params}, jnp.asarray(x))
    close(load(PM.HighwayLayer(24), params)(t(x)), want, F32_MODULE_TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("activation", [None, "relu"])
def test_batchnorm_conv1d_matches_jax(k, activation):
    """Even k pads (k-1)//2 left and k//2 right, as flax's SAME does."""
    rng = np.random.default_rng(6 + k)
    x = rng.standard_normal((2, 11, 10)).astype(np.float32)
    mod = JM.BatchNormConv1d(8, k, activation)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = perturb(v["params"], rng)
    stats = random_stats(v["batch_stats"], rng)
    want = mod.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), False)
    net = load(PM.BatchNormConv1d(10, 8, k, activation), params, stats)
    close(net(t(x).transpose(1, 2)).transpose(1, 2), want, F32_MODULE_TOL)


@pytest.mark.parametrize("width,speaker", [(16, True), (20, False)],
                         ids=["encoder-like", "post-like"])
def test_cbhg_matches_jax(width, speaker):
    """Encoder-like: before_highway and a split rnn_init_state, ragged
    lengths.  Post-like: input width != rnn_size, so highway_in_proj."""
    rng = np.random.default_rng(11)
    B, T, H = 2, 13, 16
    x = rng.standard_normal((B, T, width)).astype(np.float32)
    lengths = np.array([13, 8], np.int32) if speaker else None
    bh = rng.standard_normal((B, width)).astype(np.float32) if speaker else None
    init = (rng.standard_normal((B, 2 * H)).astype(np.float32)
            if speaker else None)
    kw = dict(bank_size=4, bank_channel_size=8, maxpool_width=2,
              highway_depth=2, rnn_size=H, proj_sizes=(24, width),
              proj_width=3)
    mod = JM.CBHG(**kw, fused_rnn=True)
    j = lambda a: None if a is None else jnp.asarray(a)
    args = (jnp.asarray(x), j(lengths), j(bh), j(init))
    call = lambda x, lengths, bh, init: dict(
        inputs=x, input_lengths=lengths, train=False, before_highway=bh,
        rnn_init_state=init)
    v = jax.jit(lambda *a: mod.init(jax.random.PRNGKey(0), **call(*a)))(*args)
    params = perturb(v["params"], rng)
    stats = random_stats(v["batch_stats"], rng)
    want = jax.jit(lambda v, *a: mod.apply(v, **call(*a)))(
        {"params": params, "batch_stats": stats}, *args)
    net = load(PM.CBHG(width, **kw), params, stats)
    assert (net.highway_in_proj is not None) == (width != H)
    p = lambda a: None if a is None else t(a)
    got = net(t(x), None if lengths is None else t(lengths).long(), p(bh),
              p(init))
    close(got, want, F32_MODULE_TOL)


def test_monotonic_attention_matches_jax():
    """bah_mon_norm: g v / ||v||, bias b, score_bias, masking before the
    sigmoid, the parallel monotonic expectation from a previous state."""
    rng = np.random.default_rng(12)
    B, T, Q, U = 3, 10, 12, 16
    query = rng.standard_normal((B, Q)).astype(np.float32)
    keys = rng.standard_normal((B, T, U)).astype(np.float32)
    state = rng.uniform(size=(B, T)).astype(np.float32)
    state /= state.sum(-1, keepdims=True)
    mask = np.arange(T)[None] < np.array([10, 7, 3])[:, None]
    mod = JA.make_attention("bah_mon_norm", U)
    args = (jnp.asarray(query), jnp.asarray(state), jnp.asarray(keys), None,
            jnp.asarray(mask))
    params = perturb(mod.init(jax.random.PRNGKey(0), *args)["params"], rng,
                     scale=0.5)
    want, want_state = mod.apply({"params": params}, *args)
    net = load(PA.BahdanauMonotonicAttention(Q, U, normalize=True), params)
    got, got_state = net(t(query), t(state), t(keys), t(mask),
                         net.loop_constants(t(keys)))
    close(got, want, F32_MODULE_TOL)
    close(got_state, want_state, F32_MODULE_TOL)
    init = PA.BahdanauMonotonicAttention.init_state(B, T)
    np.testing.assert_array_equal(init.numpy(),
                                  np.asarray(mod.init_state(B, T)))


def test_make_attention_knows_the_jax_table():
    """Every name of the JAX table builds the class of the same name (its
    flax scope) with JAX's parameter names; an unknown name raises
    KeyError."""
    assert set(PA.ATTENTION_TYPES) == {
        "bah", "bah_norm", "bah_mon", "bah_mon_norm", "bah_mon_norm_hccho",
        "loc_sen", "gmm", "luong", "luong_scaled"}
    for name in PA.ATTENTION_TYPES:        # every name the JAX table has
        mod = JA.make_attention(name, 8)
        net = PA.make_attention(name, 12, 8)
        assert type(net).__name__ == type(mod).__name__, name
        params = mod.init(jax.random.PRNGKey(0), jnp.ones((2, 12)),
                          mod.init_state(2, 5), jnp.ones((2, 5, 8)),
                          jnp.ones((2, 5, 4)), jnp.ones((2, 5), bool))
        want = set(convert.flatten(params.get("params", {})))
        got = {k.replace(".weight", "/kernel").replace(".", "/")
               for k in net.state_dict()}
        assert got == want, name
    with pytest.raises(KeyError):
        PA.make_attention("nope", 8, 8)


# ---------------------------------------------------------------------------
# Converter and config
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(cfg: PC.TacotronConfig, fused: bool):
    """{collection: {flat flax name: shape}} of the JAX Tacotron's
    variables, traced with ``jax.eval_shape`` (no init run)."""
    model = JTacotron(cfg=jax_cfg(dataclasses.replace(cfg, fused_rnn=fused)),
                      audio=JC.AudioConfig())
    tree = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 16), jnp.int32),
        jnp.array([16]), speaker_id=jnp.array([0]), train=False,
        free_run=True, max_iters=2))
    flat = lambda d, pre="": {
        kk: vv for k, v in d.items()
        for kk, vv in (flat(v, f"{pre}{k}/").items() if isinstance(v, dict)
                       else [(f"{pre}{k}", tuple(v.shape))])}
    return {col: flat(tree[col]) for col in ("params", "batch_stats")}


def _random_variables(cfg: PC.TacotronConfig, fused: bool, seed: int):
    """Random numpy variables with the JAX Tacotron's names and shapes
    (nested), at init-like scales, no term left at 0 or 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, shapes in _jax_shapes(cfg, fused).items():
        flat = {}
        for name, shape in shapes.items():
            leaf = name.rpartition("/")[2]
            if leaf == "var":
                v = rng.uniform(0.5, 1.5, shape)
            elif leaf in ("kernel", "w_ih", "w_hh"):
                v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf.endswith("embedding"):
                v = 0.5 * rng.standard_normal(shape)
            else:
                v = (leaf == "scale") + 0.1 * rng.standard_normal(shape)
            flat[name] = np.asarray(v, np.float32)
        out[col] = convert._nest(flat)
    return out
def test_fuse_gru_params_matches_jax():
    """numpy fuse_gru_params on a GRUCell tree equals JAX's, exactly."""
    params = _random_variables(TINY, False, 0)["params"]
    want = convert.flatten(JM.fuse_gru_params(params))
    got = convert.flatten(convert.fuse_gru_params(params))
    assert set(got) == set(want)
    assert any(k.endswith("attention_gru/w_ih") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "GRUCell"])
def test_tacotron_converter_consumes_every_jax_param(fused):
    """Every flax variable maps to one tensor of the port's state_dict
    (tolerance 0: a copy, transposed); a GRUCell tree gives the state the
    JAX-fused tree gives."""
    v = _random_variables(TINY, fused, 1)
    state = convert.tacotron_params_from_jax(TINY, v["params"],
                                             v["batch_stats"])
    model = Tacotron(TINY, AUDIO)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    flat = convert.flatten(JM.fuse_gru_params(v["params"]))
    np.testing.assert_array_equal(
        state["encoder_cbhg.proj_1.conv.weight"].numpy(),
        flat["encoder_cbhg/proj_1/conv/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["decoder.step.attention.attention_v"].numpy(),
        flat["decoder/step/BahdanauMonotonicAttention_0/attention_v"])
    np.testing.assert_array_equal(
        state["decoder.step.attention_gru.w_hh"].numpy(),
        flat["decoder/step/attention_gru/w_hh"].T)
    np.testing.assert_array_equal(
        state["post_cbhg.proj_2.bn.running_var"].numpy(),
        v["batch_stats"]["post_cbhg"]["proj_2"]["bn"]["var"])
    if not fused:
        want = convert.tacotron_params_from_jax(
            TINY, JM.fuse_gru_params(v["params"]), v["batch_stats"])
        for k in want:
            np.testing.assert_array_equal(state[k].numpy(),
                                          want[k].numpy(), err_msg=k)


def test_tacotron_converter_rejects_missing_extra_and_misshapen():
    params, stats = convert.seeded_tacotron_tree(TINY, 0)
    key = "decoder/step/frame_projection/kernel"
    with pytest.raises(KeyError):
        convert.tacotron_params_from_jax(
            TINY, {k: v for k, v in params.items() if k != key}, stats)
    with pytest.raises(KeyError):
        convert.tacotron_params_from_jax(TINY, dict(params, stray=0), stats)
    with pytest.raises(ValueError):
        convert.tacotron_params_from_jax(
            TINY, dict(params, **{key: params[key][:, :3]}), stats)


def test_tacotron_params_from_npz(tmp_path):
    """Flat names of both collections in one .npz (the stats are the names
    ending in /mean or /var): the same state as from the trees."""
    params, stats = convert.seeded_tacotron_tree(TINY, 4)
    path = tmp_path / "taco.npz"
    np.savez(path, **params, **stats)
    got = convert.tacotron_params_from_npz(TINY, str(path))
    want = convert.tacotron_params_from_jax(TINY, params, stats)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_synthesizer_load_from_the_tarball_config():
    """Synthesizer.load reads both_r2's params.json from the tarball and
    builds the full-width model from a seed (bf16 as the config asks)."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), REPO_TARBALL)
    synth = PSyn.Synthesizer.load(None, path, device="cpu", seed=0)
    assert synth.cfg.tacotron == PC.BOTH_R2
    assert synth.model.dtype == torch.bfloat16
    out = synth.synthesize(TEXTS, speaker_ids=[0, 1], max_iters=3,
                           attention_trim=False)
    assert out[1]["mel"].shape == (15, 80)
    assert out[1]["linear"].shape == (15, 1025)
    assert all(np.isfinite(r["mel"]).all() for r in out)
    with pytest.raises(ValueError):
        PSyn.Synthesizer.load(None, path, device="cpu")


@pytest.mark.parametrize("cfg", [TINY, PC.BOTH_R2], ids=["tiny", "both_r2"])
def test_seeded_tacotron_tree_has_the_jax_names_and_shapes(cfg):
    shapes = _jax_shapes(cfg, True)
    params, stats = convert.seeded_tacotron_tree(cfg, 3)
    assert {k: v.shape for k, v in params.items()} == shapes["params"]
    assert {k: v.shape for k, v in stats.items()} == shapes["batch_stats"]
    again, _ = convert.seeded_tacotron_tree(cfg, 3)
    assert all(np.array_equal(params[k], again[k]) for k in params)
    assert np.all(params["encoder_cbhg/highway_1/T/bias"] == -1.0)


def test_both_r2_constant_equals_the_tarball_group():
    """The port's BOTH_R2 equals the ``tacotron`` group of
    artifacts/both_r2.ckpt.tar.gz:params.json, and the JAX loader's."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), REPO_TARBALL)
    group = PC.read_params_from_tarball(path)["tacotron"]
    assert PC.from_dict({"tacotron": group}).tacotron == PC.BOTH_R2
    assert PC.load_config(path).tacotron == PC.BOTH_R2
    assert dataclasses.asdict(PC.BOTH_R2) == dataclasses.asdict(
        JC.from_dict({"tacotron": group}).tacotron)
    assert {f.name for f in dataclasses.fields(PC.TacotronConfig)} == {
        f.name for f in dataclasses.fields(JC.TacotronConfig)}
    assert dataclasses.asdict(PC.TacotronConfig()) == dataclasses.asdict(
        JC.TacotronConfig())


# ---------------------------------------------------------------------------
# Whole model, free run
# ---------------------------------------------------------------------------

def _inputs(B=2, T=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(2, 70, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 11][:B], np.int32)
    x[1, lengths[1]:] = 0
    return x, lengths, np.array([0, 1][:B], np.int32)


def _jax_decode(cfg, variables, x, lengths, speakers, **kw):
    model = JTacotron(cfg=jax_cfg(cfg), audio=JC.AudioConfig())
    fn = jax.jit(lambda v, *a: model.apply(
        v, *a[:2], speaker_id=a[2], train=False, free_run=True,
        **{k: w for k, w in zip(kw, a[3:])}))
    out = fn(variables, jnp.asarray(x), jnp.asarray(lengths),
             jnp.asarray(speakers), *[jnp.asarray(w) for w in kw.values()])
    return {k: np.asarray(v) for k, v in out.items()}


def _port_decode(cfg, state, x, lengths, speakers, **kw):
    model = Tacotron(cfg, AUDIO)
    model.load_state_dict(state)
    with torch.no_grad():
        out = model.eval()(t(x).long(), t(lengths).long(),
                           t(speakers).long(), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _seeded(cfg, seed=0):
    params, stats = convert.seeded_tacotron_tree(cfg, seed)
    variables = jax.tree.map(jnp.asarray, {
        "params": convert._nest(params), "batch_stats": convert._nest(stats)})
    return variables, convert.tacotron_params_from_jax(cfg, params, stats)


@pytest.fixture(scope="module")
def tiny_f32():
    """TINY, random weights and batch stats with the JAX names, over the
    full max_iters (30 steps)."""
    variables = _random_variables(TINY, True, 20)
    x, lengths, spk = _inputs()
    want = _jax_decode(TINY, jax.tree.map(jnp.asarray, variables), x,
                       lengths, spk)
    state = convert.tacotron_params_from_jax(
        TINY, variables["params"], variables["batch_stats"])
    return variables, state, (x, lengths, spk), want


@pytest.mark.parametrize("key", ["mel_outputs", "linear_outputs",
                                 "alignments"])
def test_tiny_free_run_matches_jax(tiny_f32, key):
    """<= 1e-4 (observed ~1e-6 mel/linear, ~1e-7 alignments)."""
    _, state, inputs, want = tiny_f32
    got = _port_decode(TINY, state, *inputs)
    B, T_in = inputs[0].shape
    shapes = {"mel_outputs": (B, 150, 80), "linear_outputs": (B, 150, 1025),
              "alignments": (B, T_in, 30)}
    assert got[key].shape == want[key].shape == shapes[key]
    assert got[key].dtype == np.float32
    close(got[key], want[key], 1e-4, key)


def test_single_speaker_free_run_matches_jax():
    """num_speakers=1 (no speaker table, no deepvoice projections), TINY,
    f32, the full 30 steps: <= 1e-5 (observed 7.2e-7 mel, 3.0e-7 linear,
    7.5e-8 alignments)."""
    cfg = dataclasses.replace(TINY, num_speakers=1, model_type="single")
    variables = _random_variables(cfg, True, 22)
    assert "speaker_embedding" not in variables["params"]
    x, lengths, _ = _inputs()
    spk = np.zeros(2, np.int32)
    want = _jax_decode(cfg, jax.tree.map(jnp.asarray, variables), x,
                       lengths, spk)
    state = convert.tacotron_params_from_jax(cfg, variables["params"],
                                             variables["batch_stats"])
    got = _port_decode(cfg, state, x, lengths, spk)
    for key in want:
        assert got[key].shape == want[key].shape
        close(got[key], want[key], 1e-5, key)


def test_full_width_free_run_matches_jax():
    """both_r2 widths, f32, max_iters cut to 20: <= 1e-3 (observed ~1e-6
    mel, ~1e-6 linear, ~1e-7 alignments)."""
    cfg = dataclasses.replace(PC.BOTH_R2, compute_dtype="float32",
                              max_iters=20)
    variables, state = _seeded(cfg)
    x, lengths, spk = _inputs()
    want = _jax_decode(cfg, variables, x, lengths, spk)
    got = _port_decode(cfg, state, x, lengths, spk)
    for key in want:
        assert got[key].shape == want[key].shape
        close(got[key], want[key], 1e-3, key)


def test_bf16_free_run_within_bf16_noise_of_jax():
    """compute_dtype bfloat16, TINY, 12 steps.  The two bf16 programs round
    differently (XLA may keep f32 between fused ops), so they are held to
    bf16's own noise: the mean |port - JAX| in bf16 is at most twice JAX's
    own mean |bf16 - f32| (observed ratio ~1), and the port's bf16 output
    stays as close to f32 as JAX's does."""
    c32 = dataclasses.replace(TINY, max_iters=12)
    c16 = dataclasses.replace(c32, compute_dtype="bfloat16")
    variables, state = _seeded(c32, seed=1)
    x, lengths, spk = _inputs()
    j32 = _jax_decode(c32, variables, x, lengths, spk)
    j16 = _jax_decode(c16, variables, x, lengths, spk)
    p16 = _port_decode(c16, state, x, lengths, spk)
    for key in j32:
        d_port = np.abs(p16[key] - j16[key]).mean()
        d_jax = np.abs(j16[key] - j32[key]).mean()
        assert np.isfinite(p16[key]).all()
        assert d_jax > 0, key
        assert d_port <= 2.0 * d_jax, (key, d_port, d_jax)
        assert np.abs(p16[key] - j32[key]).mean() <= 2.0 * d_jax, key


def test_manual_alignments_match_jax(tiny_f32):
    """Manual alignments injected at every step (the mechanism's state
    still advances): <= 1e-4."""
    variables, state, (x, lengths, spk), _ = tiny_f32
    T_dec = 8
    rng = np.random.default_rng(21)
    manual = rng.uniform(size=(2, T_dec, x.shape[1])).astype(np.float32)
    manual /= manual.sum(-1, keepdims=True)
    cfg = dataclasses.replace(TINY, max_iters=T_dec)
    want = _jax_decode(cfg, jax.tree.map(jnp.asarray, variables), x, lengths,
                       spk, manual_alignments=manual,
                       is_manual_attention=np.asarray(True))
    got = _port_decode(cfg, state, x, lengths, spk,
                       manual_alignments=t(manual))
    np.testing.assert_allclose(got["alignments"],
                               manual.transpose(0, 2, 1), atol=0)
    for key in want:
        close(got[key], want[key], 1e-4, key)


def test_prenet_dropout_is_seeded_by_the_generator():
    """Dropout on (the config asks and a generator is passed): the same
    seed gives the same decode, another seed another; without a generator
    the decode is deterministic."""
    variables, state = _seeded(TINY)
    x, lengths, spk = _inputs()
    run = lambda g: _port_decode(TINY, state, x, lengths, spk, max_iters=6,
                                 generator=g)["mel_outputs"]
    a = run(torch.Generator().manual_seed(0))
    b = run(torch.Generator().manual_seed(0))
    c = run(torch.Generator().manual_seed(1))
    plain = run(None)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and not np.array_equal(a, plain)
    off = dataclasses.replace(TINY, dec_prenet_dropout_inference=False)
    np.testing.assert_array_equal(
        _port_decode(off, state, x, lengths, spk, max_iters=6,
                     generator=torch.Generator().manual_seed(0))
        ["mel_outputs"], plain)


# ---------------------------------------------------------------------------
# Synthesizer (mel half)
# ---------------------------------------------------------------------------

def _alignments():
    rng = np.random.default_rng(30)
    out = [rng.uniform(size=(16, 40)) for _ in range(3)]
    walk = np.zeros((16, 40))                # attention walks to the end
    walk[np.minimum(np.arange(40) // 3, 15), np.arange(40)] = 1.0
    stuck = np.zeros((16, 40))               # never moves
    stuck[0] = 1.0
    back = walk.copy()                       # reaches the end, comes back
    back[:, 30:] = 0.0
    back[4, 30:] = 1.0
    return out + [walk, stuck, back]


@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("seq_len", [16, 9])
def test_attention_trim_index_matches_jax(i, seq_len):
    a = _alignments()[i]
    assert (PSyn.attention_trim_index(a, seq_len, 5)
            == JSyn.attention_trim_index(a, seq_len, 5))


TEXTS = ["존경하는 국민 여러분", "오늘 3,600마리 강아지가 KIA에 왔다"]


def test_synthesizer_trimmed_mel_matches_jax():
    """Synthesizer.synthesize on the CPU against the JAX Tacotron plus
    attention_trim_index on the same seeded weights and the same padded
    ids: the same trimmed lengths, mels within 1e-4."""
    cfg = dataclasses.replace(TINY, dec_prenet_dropout_inference=False)
    full = PC.Config(tacotron=cfg)
    variables, state = _seeded(cfg, seed=2)
    synth = PSyn.Synthesizer(full, state, device="cpu")
    inputs, lengths = synth._prepare_inputs(TEXTS)
    assert inputs.shape[1] % 16 == 0
    assert [int(n) for n in lengths] == [
        len(synth.codec.encode(s)) for s in TEXTS]
    spk = np.array([1, 0], np.int32)
    want = _jax_decode(cfg, variables, inputs, lengths, spk)
    results = synth.synthesize(TEXTS, speaker_ids=[1, 0])
    for i, r in enumerate(results):
        n = min(want["mel_outputs"].shape[1], JSyn.attention_trim_index(
            want["alignments"][i], int(lengths[i]), cfg.reduction_factor))
        assert r["mel"].shape == (n, 80) and r["linear"].shape == (n, 1025)
        assert r["text"] == TEXTS[i]
        close(r["mel"], want["mel_outputs"][i, :n], 1e-4)
        close(r["alignment"], want["alignments"][i], 1e-4)
    untrimmed = synth.synthesize(TEXTS, speaker_ids=[1, 0],
                                 attention_trim=False, max_iters=4)
    assert untrimmed[0]["mel"].shape == (20, 80)


def test_synthesizer_speaker_ids_are_checked_on_the_host():
    state = convert.seeded_tacotron_params(TINY, 0)
    synth = PSyn.Synthesizer(PC.Config(tacotron=TINY), state, device="cpu")
    np.testing.assert_array_equal(synth.speaker_rows([-1, 0], 2), [1, 0])
    np.testing.assert_array_equal(synth.speaker_rows(None, 3), [0, 0, 0])
    with pytest.raises(IndexError):
        synth.synthesize(TEXTS[:1], speaker_ids=[2], max_iters=2)
    a = synth.synthesize(TEXTS[:1], speaker_ids=[-1], max_iters=3,
                         attention_trim=False)[0]["mel"]
    b = synth.synthesize(TEXTS[:1], speaker_ids=[1], max_iters=3,
                         attention_trim=False)[0]["mel"]
    np.testing.assert_array_equal(a, b)


def test_synthesizer_refuses_to_run_on_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = convert.seeded_tacotron_params(TINY, 0)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PSyn.Synthesizer(PC.Config(tacotron=TINY), state)
