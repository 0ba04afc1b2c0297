"""Tiny cells for the CPU tests: a cell's own configuration and traffic cut
to sizes the CPU runs in seconds, and a ``Context`` on the CPU that skips
the harness's look for a card."""
from __future__ import annotations

import copy
import tempfile
import time

import torch

from benchmark import harness

TINY_WAVENET = {
    "residual_channels": 4, "dilation_channels": 4, "skip_channels": 8,
    "dilations": [1, 2, 1, 2], "initial_filter_width": 4,
    "sample_size": 1200, "batch_size": 2,
}


def tiny_config(name: str) -> dict:
    conf = copy.deepcopy(harness.load_config(name))
    conf["wavenet"].update(TINY_WAVENET)
    return conf


def tiny_workload(name: str, **traffic) -> dict:
    wl = copy.deepcopy(harness.load_workload(name))
    wl["traffic"].update(traffic)
    return wl


def context(cell: str, config: dict, workload: dict, seed: int = 3,
            seconds: float = 0.5, traced: bool = False) -> harness.Context:
    return harness.Context(
        cell=cell, seed=seed, seconds=seconds, traced=traced,
        workload=workload, config=config, device=torch.device("cpu"),
        run_dir=tempfile.mkdtemp(prefix="bench-test-"),
        setup_start=time.perf_counter(), recorder=harness.Recorder(traced))
