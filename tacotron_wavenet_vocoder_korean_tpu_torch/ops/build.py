"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into a shared library under ``_build/`` beside this package (listed in
``.gitignore``).  The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale build is never
loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the path
    of its shared library.  Prints the build time and ptxas' report."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: a concurrent process never sees
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    print(f"built {os.path.basename(out)} in {time.perf_counter() - t0:.1f}s"
          f"\n{proc.stderr.strip()}", flush=True)
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built and loaded library of ``csrc/<name>.cu`` (once per
    process)."""
    return ctypes.CDLL(build(name))


def load_libraries(*names: str) -> None:
    """Build every ``csrc/<name>.cu`` at once (one ``nvcc`` each, all
    started together), then load each."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build, names))
    for name in names:
        load_library(name)
