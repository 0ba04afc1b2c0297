"""Small utilities (counterpart of the JAX package's ``utils/misc.py``;
reference: utils/__init__.py:197-243).  The JAX module's platform and
compile-cache helpers have no counterpart here: the port's entry points
take ``--device`` instead."""
from __future__ import annotations

import argparse
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Callable, Iterable, List, Optional

# The repository root: this file is <root>/<package>/utils/misc.py.
REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def get_time() -> str:
    return datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def add_postfix(path: str, postfix) -> str:
    path_without_ext, ext = path.rsplit(".", 1)
    return f"{path_without_ext}.{postfix}.{ext}"


def get_git_revision() -> Optional[str]:
    """The repository's current commit hash, for run provenance
    (reference train_tacotron.py get_git_commit); ``None`` outside a git
    checkout."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=REPO_DIR,
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return None


def parallel_map(fn: Callable, items: Iterable, num_workers: int = 8) -> List:
    """Threaded map, results in the items' order (reference
    utils/__init__.py:212-226 used mp.Pool; threads share one process's
    CUDA context)."""
    items = list(items)
    if num_workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return list(ex.map(fn, items))


def remove_file(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
