"""PyTorch port: the nine attention mechanisms and the ``simple`` speaker
mode against the JAX package (CPU).

Each mechanism alone over 5 chained steps (float32 queries and bf16 ones,
the attention GRU's width equal to ``attention_size`` and not), the
port's twins of the JAX package's ``loc_sen`` and ``gmm`` state tests, a
free-running TINY decode of each type with ``deepvoice`` speakers and of
``simple`` speakers, the converter both ways and ``seeded_tacotron_tree``
for each.  The same numpy-seeded weights and inputs go to both sides;
tolerances are stated per test, the observed errors beside them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu.models import attention as JA
from tacotron_wavenet_vocoder_korean_tpu.models import modules as JM
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.models import attention as PA
from tacotron_wavenet_vocoder_korean_tpu_torch.models.tacotron import Tacotron
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
    Synthesizer)
from test_torch_tacotron import (AUDIO, TINY, _inputs, _jax_decode,
                                 _jax_shapes, _port_decode, _random_variables,
                                 load, perturb, t)

TYPES = PA.ATTENTION_TYPES
# TINY with the attention GRU wider than attention_size (so the Luong
# query projection exists), 10 decoder steps.
WIDE = dataclasses.replace(TINY, attention_state_size=48, max_iters=10)


def config(name: str):
    """WIDE with ``name``'s mechanism and deepvoice speakers, or, for
    ``simple``, bah_mon_norm with simple speakers; ``simple-GRUCell`` is
    that with flax GRUCells (``fused_rnn: false``)."""
    if name.startswith("simple"):
        return dataclasses.replace(WIDE, model_type="simple",
                                   fused_rnn=name == "simple")
    return dataclasses.replace(WIDE, attention_type=name)


CONFIGS = TYPES + ("simple",)


# ---------------------------------------------------------------------------
# Each mechanism alone
# ---------------------------------------------------------------------------

def _start_state(name, B, T, U, rng):
    """A state a decode could hold: kappa for gmm (positive, growing
    mixtures), else a distribution over the T positions."""
    if name == "gmm":
        return rng.uniform(0.0, 3.0, (B, U)).astype(np.float32)
    s = rng.uniform(size=(B, T)).astype(np.float32)
    return s / s.sum(-1, keepdims=True)


@pytest.mark.parametrize("query", ["f32-32", "f32-48", "bf16-48"])
@pytest.mark.parametrize("name", TYPES)
def test_mechanism_steps_match_jax(name, query):
    """5 chained steps from the same state on both sides (each step's new
    state fed to the next), every parameter moved off its init value:
    alignments and states within 1e-6 of the step's largest |value| (GMM's
    alignments are unnormalised; observed <= 6.1e-7).  A bf16 query (the
    attention GRU's output under bf16) is promoted by both.  The port's
    parameters carry flax's names, and its initial state is JAX's."""
    dtype, Q = query.split("-")
    Q, U, B, T = int(Q), 32, 3, 10
    rng = np.random.default_rng(len(name) * 7 + Q)
    queries = rng.standard_normal((5, B, Q)).astype(np.float32)
    if dtype == "bf16":
        queries = np.asarray(jnp.asarray(queries, jnp.bfloat16)
                             .astype(jnp.float32))
    keys = rng.standard_normal((B, T, U)).astype(np.float32)
    values = rng.standard_normal((B, T, 8)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([10, 7, 3])[:, None]
    state = _start_state(name, B, T, U, rng)
    mod = JA.make_attention(name, U)
    jq = lambda i: jnp.asarray(queries[i], (jnp.bfloat16 if dtype == "bf16"
                                            else jnp.float32))
    args = (jnp.asarray(keys), jnp.asarray(values), jnp.asarray(mask))
    params = perturb(mod.init(jax.random.PRNGKey(0), jq(0),
                              jnp.asarray(state), *args).get("params", {}),
                     rng, scale=0.3)
    net = load(PA.make_attention(name, Q, U), params)
    assert type(net).__name__ == type(mod).__name__
    pq = torch.from_numpy(queries).to(torch.bfloat16 if dtype == "bf16"
                                      else torch.float32)
    pk, pm = t(keys), t(mask)
    consts = net.loop_constants(pk)
    j_state, p_state = jnp.asarray(state), t(state)
    for i in range(5):
        want_a, j_state = mod.apply({"params": params}, jq(i), j_state, *args)
        with torch.no_grad():
            got_a, p_state = net(pq[i], p_state, pk, pm, consts)
        for got, want in ((got_a, want_a), (p_state, j_state)):
            want = np.asarray(want)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-6 * max(1.0, float(np.abs(want).max())),
                err_msg=f"step {i}")
    np.testing.assert_array_equal(net.init_state(B, T).numpy(),
                                  np.asarray(mod.init_state(B, T)))


def test_location_sensitive_cumulates():
    """The port's twin of the JAX test: loc_sen's state is the running
    sum of its alignments."""
    net = PA.make_attention("loc_sen", 16, 16).eval()
    B, T = 2, 10
    keys, mask = torch.zeros(B, T, 16), torch.ones(B, T, dtype=torch.bool)
    q = torch.ones(B, 16)
    with torch.no_grad():
        a1, s1 = net(q, net.init_state(B, T), keys, mask, None)
        a2, s2 = net(q, s1, keys, mask, None)
    torch.testing.assert_close(s1, a1, rtol=0, atol=1e-6)
    torch.testing.assert_close(s2, a2 + s1, rtol=0, atol=1e-6)


def test_gmm_kappa_monotone():
    """The port's twin of the JAX test: GMM's kappa only moves forward."""
    net = PA.make_attention("gmm", 16, 8).eval()
    B, T = 2, 12
    keys, mask = torch.zeros(B, T, 8), torch.ones(B, T, dtype=torch.bool)
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 16)).astype(np.float32))
    consts = net.loop_constants(keys)
    with torch.no_grad():
        _, s1 = net(q, net.init_state(B, T), keys, mask, consts)
        _, s2 = net(q, s1, keys, mask, consts)
    assert s1.shape == (B, 8)
    assert bool((s1 >= 0).all()) and bool((s2 >= s1).all())


# ---------------------------------------------------------------------------
# Whole model, free run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_free_run_matches_jax(name):
    """10 free-running steps at WIDE, f32, random weights and statistics:
    the alignments within 1e-5 of their largest |value|, the mel and the
    linear output (a function of the mel) within 1e-5 of the mel's
    largest |value|, or 1e-5 where that is below 1 (observed <= 1.3e-6
    of it; GMM's unnormalised alignments and frames reach ~50); the
    padded encoder positions of the shorter text get < 1e-3, as JAX's
    test_attention_types_forward asks."""
    cfg = config(name)
    variables = _random_variables(cfg, True, 20)
    x, lengths, spk = _inputs()
    want = _jax_decode(cfg, jax.tree.map(jnp.asarray, variables), x,
                       lengths, spk)
    state = convert.tacotron_params_from_jax(cfg, variables["params"],
                                             variables["batch_stats"])
    got = _port_decode(cfg, state, x, lengths, spk)
    for key in want:
        assert got[key].shape == want[key].shape
        assert np.isfinite(got[key]).all()
        ref = want["alignments" if key == "alignments" else "mel_outputs"]
        np.testing.assert_allclose(
            got[key], want[key], rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=key)
    assert got["alignments"][1, lengths[1]:].max() < 1e-3


def test_simple_speakers_condition_the_decode():
    """simple: the speaker row reaches the decode (two speakers, one
    text, two mels) and the linear projection (a speaker-only change of
    ``linear_projection``'s first S input rows moves the linear output
    alone)."""
    cfg = config("simple")
    params, stats = convert.seeded_tacotron_tree(cfg, 1)
    model = Tacotron(cfg, AUDIO)
    model.load_state_dict(convert.tacotron_params_from_jax(cfg, params,
                                                           stats))
    x, lengths, _ = _inputs()
    x, lengths = np.repeat(x[:1], 2, 0), np.repeat(lengths[:1], 2)
    run = lambda: model.eval()(t(x).long(), t(lengths).long(),
                               torch.tensor([0, 1]))
    with torch.no_grad():
        a = run()
        S = cfg.speaker_embedding_size
        model.linear_projection.weight[:, :S] += 1.0
        b = run()
    assert np.abs((a["mel_outputs"][0] - a["mel_outputs"][1]).numpy()
                  ).max() > 1e-3
    torch.testing.assert_close(a["mel_outputs"], b["mel_outputs"])
    assert float((a["linear_outputs"] - b["linear_outputs"]).abs().min()
                 ) > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_synthesizer_serves_every_type(name, monkeypatch):
    """The Synthesizer on the CPU, random WIDE weights: a trimmed decode
    and manual mode 1 (the first decode's argmax injected at every step;
    the mechanism's own state still advances) give finite mels within the
    decode's frames, and the injected alignments are the ones returned.
    Griffin-Lim, which no mechanism reaches, is stubbed out (its own tests
    are tests/test_torch_griffin_lim.py and tests/test_torch_e2e.py)."""
    monkeypatch.setattr(Synthesizer, "griffin_lim_wav",
                        lambda self, linear: np.zeros(0, np.float32))
    cfg = PC.Config(tacotron=config(name))
    v = _random_variables(cfg.tacotron, True, 20)
    synth = Synthesizer(cfg, convert.tacotron_params_from_jax(
        cfg.tacotron, v["params"], v["batch_stats"]), device="cpu")
    assert synth.codec.vocab_size == 80      # _random_variables' table
    texts = ["존경하는 국민 여러분", "KIA 3대가 12시에 왔다"]
    frames = cfg.tacotron.max_iters * cfg.tacotron.reduction_factor
    first = synth.synthesize(texts, speaker_ids=[0, 1])
    manual = synth.synthesize(texts, speaker_ids=[0, 1],
                              manual_attention_mode=1, attention_trim=False)
    for a, m in zip(first, manual):
        assert 0 < a["mel"].shape[0] <= frames
        assert m["mel"].shape == (frames, 80)
        assert np.isfinite(a["mel"]).all() and np.isfinite(m["mel"]).all()
        assert set(np.unique(m["alignment"])) == {0.0, 1.0}
        np.testing.assert_array_equal(m["alignment"].argmax(0),
                                      a["alignment"].argmax(0))


@pytest.mark.parametrize("model_type", ["single", "nope"])
def test_several_speakers_need_deepvoice_or_simple(model_type):
    """As JAX: any other model_type with several speakers raises."""
    with pytest.raises(ValueError, match="model_type"):
        Tacotron(dataclasses.replace(TINY, model_type=model_type), AUDIO)


# ---------------------------------------------------------------------------
# Converter and seeded weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS + ("simple-GRUCell",))
def test_converter_both_ways(name):
    """JAX's tree (random values with the names and shapes of
    ``jax.eval_shape``) -> the port's state_dict -> JAX's tree again,
    equal leaf for leaf (tolerance 0: copies, transposes and exact GRU
    splits), flax GRUCells again for ``fused_rnn: false``; the mechanism's
    leaves sit under its class's scope."""
    cfg = config(name)
    v = _random_variables(cfg, cfg.fused_rnn, 2)
    state = convert.tacotron_params_from_jax(cfg, v["params"],
                                             v["batch_stats"])
    model = Tacotron(cfg, AUDIO)
    model.load_state_dict(state)
    back = convert.tacotron_to_jax(cfg, {
        k: v for k, v in state.items()
        if not k.endswith("num_batches_tracked")})
    for col in ("params", "batch_stats"):
        got, want = (convert.flatten(x[col]) for x in (back, v))
        assert set(got) == set(want), col
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mech = type(model.decoder.step.attention).__name__
    step = v["params"]["decoder"]["step"]
    assert f"{mech}_0" in step
    if not cfg.fused_rnn:
        assert set(JM.fuse_gru_params(step)["attention_gru"]) == {
            "w_ih", "w_hh", "b_ih", "b_hn"}


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_tree_has_the_jax_names_and_shapes(name):
    """seeded_tacotron_tree's names and shapes are jax.eval_shape's, for
    each mechanism and for simple; its attention leaves start at flax's
    init values: Luong's scale g at 1, the normalised score's g at
    sqrt(1 / attention_size), biases at 0, v's within glorot's limit."""
    cfg = config(name)
    shapes = _jax_shapes(cfg, True)
    params, stats = convert.seeded_tacotron_tree(cfg, 3)
    assert {k: v.shape for k, v in params.items()} == shapes["params"]
    assert {k: v.shape for k, v in stats.items()} == shapes["batch_stats"]
    U = cfg.attention_size
    for k, v in params.items():
        if "/step/" not in k or "Attention" not in k:
            continue
        leaf = k.rpartition("/")[2]
        if leaf == "attention_g":
            want = 1.0 if name == "luong_scaled" else np.sqrt(1.0 / U)
            np.testing.assert_allclose(v, want, rtol=1e-7, err_msg=k)
        elif leaf in ("attention_b", "attention_bias", "alignments_bias",
                      "score_bias", "bias"):
            assert not v.any(), k
        elif leaf in ("attention_v", "attention_variable"):
            lim = np.sqrt(6.0 / (U + 1))
            assert np.abs(v).max() <= lim and v.std() > lim / 4, k
        else:
            assert leaf == "kernel", k
