"""PyTorch port: ``utils/misc.py`` against the JAX package's, helper by
helper (CPU)."""
import argparse
import datetime as dt
import os
import subprocess

import pytest

from tacotron_wavenet_vocoder_korean_tpu.utils import misc as JM
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import misc as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def outcome(fn, *args):
    """``fn(*args)``'s value, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:            # noqa: BLE001 - compared as a type
        return type(e)


@pytest.mark.parametrize("value", [True, False, "yes", "True", "t", "Y", "1",
                                   "no", "FALSE", "f", "n", "0", "maybe", ""])
def test_str2bool_matches_jax(value):
    got = outcome(PM.str2bool, value)
    assert got == outcome(JM.str2bool, value)
    if isinstance(got, type):
        assert got is argparse.ArgumentTypeError


class FixedNow(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 18, 9, 5, 7)


@pytest.mark.parametrize("mod", [PM, JM], ids=["port", "jax"])
def test_get_time_format_matches_jax(mod, monkeypatch):
    monkeypatch.setattr(mod, "datetime", FixedNow)
    assert mod.get_time() == "2026-10-18_09-05-07"


@pytest.mark.parametrize("path,postfix", [
    ("out/0.wav", "manual"), ("a.b.c.npy", 3), ("run/x.mel.npy", "gl"),
    ("noext", "p")])
def test_add_postfix_matches_jax(path, postfix):
    assert (outcome(PM.add_postfix, path, postfix)
            == outcome(JM.add_postfix, path, postfix))


def test_get_git_revision_matches_jax_from_the_repo_root(tmp_path,
                                                         monkeypatch):
    """Both resolve the repository from their own path, whatever the
    working directory."""
    assert PM.REPO_DIR == REPO
    monkeypatch.chdir(tmp_path)
    got = PM.get_git_revision()
    assert got == JM.get_git_revision()
    try:
        head = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=REPO,
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        head = None
    assert got == head


@pytest.mark.parametrize("n_items,workers", [(0, 4), (1, 4), (7, 1), (7, 3),
                                             (20, 8)])
def test_parallel_map_matches_jax(n_items, workers):
    items = [(i * 7919) % 31 for i in range(n_items)]
    fn = lambda x: (x * x, str(x))          # noqa: E731
    got = PM.parallel_map(fn, iter(items), num_workers=workers)
    assert got == JM.parallel_map(fn, iter(items), num_workers=workers)
    assert got == [fn(x) for x in items]


@pytest.mark.parametrize("mod", [PM, JM], ids=["port", "jax"])
def test_remove_file_matches_jax(mod, tmp_path):
    f = tmp_path / "a.txt"
    f.write_text("x")
    assert mod.remove_file(str(f)) is None and not f.exists()
    assert mod.remove_file(str(f)) is None           # missing: no error
    assert mod.remove_file(str(tmp_path)) is None    # a dir: left alone
    assert tmp_path.is_dir()
