"""PyTorch port: parameter conversion from the JAX tree, import hygiene, and
no silent fall-back to the CPU."""
import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu.models.wavenet import (
    materialize_wn_params)
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.device import resolve_device
from torch_port_util import TINY, TINY_GC, jax_params, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tacotron_wavenet_vocoder_korean_tpu_torch")


@pytest.mark.parametrize("cfg", [TINY, TINY_GC], ids=["tiny", "tiny_gc"])
def test_converter_consumes_every_jax_param(cfg):
    """Every flax param maps to one port tensor with the same shape and
    value (tolerance 0: a copy), and the port reads no other name."""
    params = jax_params(cfg)
    flat = convert.flatten(params)
    port = convert.params_from_jax(port_cfg(cfg), params)
    assert set(port) == set(flat)
    assert set(port) == set(convert.param_shapes(port_cfg(cfg)))
    for k, v in flat.items():
        assert tuple(port[k].shape) == v.shape, k
        np.testing.assert_array_equal(port[k].numpy(), v)
    assert ("gc_embedding" in port) == (cfg.num_speakers > 1)


def test_converter_folds_weight_norm_like_jax():
    """A weight-normalized tree folds as materialize_wn_params folds it:
    max abs err <= 1e-6 (f32 norm, summed in another order)."""
    cfg = dataclasses.replace(TINY, weight_normalization=True)
    params = jax.tree.map(np.asarray, jax_params(cfg))
    # Scales away from their init value, so the fold is not the identity.
    rng = np.random.default_rng(0)
    params = {k: (v * rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                  if k.endswith("_g") else v) for k, v in params.items()}
    assert any(k.endswith("_v") for k in params)
    want = convert.flatten(materialize_wn_params(cfg, params))
    port = convert.params_from_jax(port_cfg(cfg), params)
    assert set(port) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(port[k].numpy(), v, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_converter_rejects_missing_extra_and_misshapen():
    cfg = port_cfg(TINY)
    tree = convert.seeded_tree(cfg, 0)
    with pytest.raises(KeyError):
        convert.params_from_jax(cfg, {k: v for k, v in tree.items()
                                      if k != "layer_3_res_kernel"})
    with pytest.raises(KeyError):
        convert.params_from_jax(cfg, dict(tree, stray=np.zeros(3)))
    with pytest.raises(ValueError):
        convert.params_from_jax(cfg, dict(tree, causal_kernel=np.zeros(3)))


def test_seeded_tree_loads_into_jax_sampler_shapes():
    """Seeded weights have exactly the JAX model's names and shapes, so the
    same numbers can drive both frameworks."""
    flat = convert.flatten(jax_params(TINY_GC))
    seeded = convert.seeded_tree(port_cfg(TINY_GC), 3)
    assert {k: v.shape for k, v in seeded.items()} == {
        k: v.shape for k, v in flat.items()}
    again = convert.seeded_tree(port_cfg(TINY_GC), 3)
    assert all(np.array_equal(seeded[k], again[k]) for k in seeded)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
              "zstandard", "matplotlib", "PIL")
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in banned or top == "tacotron_wavenet_vocoder_korean_tpu":
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not bad, bad
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert len(sources) >= 12
    # the mesh, the ranks' code and the evaluation commands are covered too
    pkg = os.path.relpath(PORT, REPO)
    assert {os.path.join(pkg, "parallel", "mesh.py"),
            os.path.join(pkg, "parallel", "__init__.py"),
            os.path.join(pkg, "utils", "misc.py"),
            "chip_smoke.py"} <= sources
    assert {os.path.join(pkg, "scripts", f"{name}.py") for name in (
        "__init__", "vocoder_eval", "quality_eval", "wavenet_diagnose")
            } <= sources


def test_entry_points_refuse_to_run_on_cpu_silently(monkeypatch, tmp_path):
    """With no GPU, an entry point not asked for the CPU raises."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import generate
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    from torch_port_util import port_full_cfg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    cfg = port_full_cfg(TINY)
    params = convert.seeded_params(cfg.wavenet, 0)
    with pytest.raises(RuntimeError, match="no CUDA"):
        WaveNetGenerator(cfg, params)
    mel = tmp_path / "m.npy"
    np.save(mel, np.zeros((3, 80), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA"):
        generate.main(["--init_seed", "0", "--mel", str(mel)])
    # the evaluation commands raise before reading a run or a corpus
    from tacotron_wavenet_vocoder_korean_tpu_torch.scripts import (
        quality_eval, vocoder_eval, wavenet_diagnose)
    run, data = str(tmp_path / "run"), str(tmp_path / "data")
    for cmd, args in (
            (vocoder_eval, ["--wavenet", run, "--data", data,
                            "--no_persist"]),
            (quality_eval, ["--tacotron", run, "--data", data,
                            "--no_persist"]),
            (wavenet_diagnose, ["--wavenet", run, "--data", data])):
        with pytest.raises(RuntimeError, match="no CUDA"):
            cmd.main(args)
    assert resolve_device("cpu") == torch.device("cpu")
