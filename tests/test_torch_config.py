"""PyTorch port: ``config.py`` against the JAX package's, on the committed
run configs and on ``--hparams`` strings.  Everything is compared exactly."""
import dataclasses
import json
import os

import pytest

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARBALLS = ("wn_moon", "both_r2")
HPARAMS = [
    "wavenet.dilations=[1,2,4],wavenet.momentum=0.5",
    "wavenet.optimizer=rmsprop, wavenet.clip_gradients=True,"
    "train.transfer_dtype=float32",
    "tacotron.main_data=[\"a\",\"b\"],audio.trim_top_db=30,"
    "train.max_checkpoints=None",
    "wavenet.compute_dtype=bfloat16,wavenet.l2_regularization_strength=1e-4",
]


@pytest.mark.parametrize("name", TARBALLS)
def test_params_json_survives_jax_port_jax(name, tmp_path):
    """A committed params.json read by JAX, handed to the port as JAX's
    dict, written by the port and read back by JAX: the same dict, the same
    Config, the port's params.json byte-equal to JAX's, and every value of
    the committed file in it unchanged (fields added since then get their
    defaults in both)."""
    raw = PC.read_params_from_tarball(
        os.path.join(REPO, "artifacts", f"{name}.ckpt.tar.gz"))
    jcfg = JC.from_dict(raw)
    pcfg = PC.from_dict(JC.to_dict(jcfg))
    assert PC.to_dict(pcfg) == JC.to_dict(jcfg)
    PC.save_config(pcfg, str(tmp_path / "port"))
    JC.save_config(jcfg, str(tmp_path / "jax"))
    port_json = (tmp_path / "port" / "params.json").read_bytes()
    assert port_json == (tmp_path / "jax" / "params.json").read_bytes()
    assert JC.load_config(str(tmp_path / "port")) == jcfg
    written = json.loads(port_json)
    for group, values in raw.items():
        for k, v in values.items():
            assert written[group][k] == v, (group, k)
    assert PC.debug_string(pcfg) == JC.debug_string(jcfg)


def test_every_jax_field_and_default_is_in_the_port():
    """Each group has JAX's fields, in JAX's order, with JAX's defaults."""
    for group in ("AudioConfig", "TacotronConfig", "WaveNetConfig",
                  "TrainConfig", "Config"):
        jf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(JC, group))]
        pf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(PC, group))]
        assert pf == jf, group
    assert PC.to_dict(PC.Config()) == JC.to_dict(JC.Config())


@pytest.mark.parametrize("spec", HPARAMS)
def test_hparams_strings_parse_as_in_jax(spec):
    parts = PC.split_overrides(spec)
    assert parts == JC.split_overrides(spec)
    assert PC.to_dict(PC.overlay_from_strings(PC.Config(), parts)) == (
        JC.to_dict(JC.overlay_from_strings(JC.Config(), parts)))


@pytest.mark.parametrize("bad,error", [
    (["wavenet.nope=1"], KeyError), (["nope.x=1"], KeyError),
    (["wavenet=1"], ValueError), (["wavenet.sample_size=100"], ValueError),
    (["wavenet.out_channels=31"], ValueError),
    (["wavenet.input_type=mulaw-quantize"], ValueError),
    (["audio.hop_size=200"], ValueError)])
def test_overrides_and_validate_raise_as_in_jax(bad, error):
    with pytest.raises(error):
        JC.overlay_from_strings(JC.Config(), bad)
    with pytest.raises(error):
        PC.overlay_from_strings(PC.Config(), bad)
