"""Ranks of the PyTorch port's mesh tests (tests/test_torch_mesh*.py).

``Ranks`` starts one process per rank on the CPU (gloo), on a port found
by binding port 0, with the variables ``torch.distributed.run`` sets;
each runs one of the functions below (one thread each) and sends back
what it returns.  The ranks are forked from a fork server that has
imported this module once (torch, numpy and the port only, no JAX), so a
rank starts in well under a second.
"""
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.models.modules import (
    BatchNormConv1d)
from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
    DATA_AXIS, all_reduce_mean, gather_tree, make_mesh)
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    tacotron_task as PTT)
from tacotron_wavenet_vocoder_korean_tpu_torch.train import (
    wavenet_task as PWT)

JOIN_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


def _child(fn, rank, world, port, args, out):
    os.environ.update(rank_env(rank, world, port))
    torch.set_num_threads(1)
    try:
        out.put((rank, fn(*args), None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``fn(*args)`` started in ``world`` spawned ranks; ``results()``
    waits for their results, by rank.  A rank's exception, a rank that
    dies, or no result within ``timeout`` seconds of the start raises,
    and every rank is ended."""

    def __init__(self, fn, world: int, *args,
                 timeout: float = JOIN_TIMEOUT_S):
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        self._out = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_child, args=(
            fn, r, world, port, args, self._out), daemon=True)
            for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout

    def results(self) -> list:
        world = len(self._procs)
        results = {}
        try:
            while len(results) < world:
                if time.monotonic() > self._deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(results))}"
                        " gave no result in time")
                try:
                    rank, value, err = self._out.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} raised:\n{err}")
                results[rank] = value
        finally:
            for p in self._procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [results[r] for r in range(world)]


def _rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global numpy batch."""
    n = next(iter(batch.values())).shape[0] // mesh.n_data
    d = mesh.index(DATA_AXIS)
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def wavenet_step(cfg, tree, batch, n_data, n_model, device="cpu"):
    """One TP/DP WaveNet step from the JAX-layout state ``tree`` on the
    global ``batch``, on ``device``: the metrics, the gathered gradient
    (averaged over the data group), each parameter's local shape after
    the step, and the gathered new state as JAX's tree."""
    mesh = make_mesh(n_data, n_model, device=device)
    task = PWT.WaveNetTask(cfg, mesh=mesh)
    state = task.shard_state(convert.from_jax_tree(task.init_state(0), tree))
    b = PWT.batch_to_device(_rows(batch, mesh), mesh.device)
    _, grads = task.grads(state.params, b)
    grads = gather_tree(mesh, all_reduce_mean(mesh, grads)[0],
                        task.placements.params)
    new, metrics = task.train_step(state, b)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "backend": mesh.backend,
            "grads": _numpy(grads),
            "shapes": {k: tuple(v.shape) for k, v in new.params.items()},
            "tree": task.to_jax_tree(new)}


def tacotron_step(cfg, tree, batch, local_batch_norm=False):
    """One data-parallel Tacotron step from the JAX-layout state ``tree``
    on the global ``batch``: the metrics, the new parameters, statistics
    and Adam moments under the port's names.  ``local_batch_norm`` takes
    batch norm's statistics over this rank's rows alone (the fault the
    step must not have)."""
    mesh = make_mesh(device="cpu")
    task = PTT.TacotronTask(cfg, is_randomly_initialized=True, mesh=mesh)
    if local_batch_norm:
        for m in task.model.modules():
            if isinstance(m, BatchNormConv1d):
                m.stats_mesh = None
    template = task.init_state(0)
    state = convert.from_jax_tree(template,
                                  task.from_jax_tree(template, tree))
    b = PTT.batch_to_device(_rows(batch, mesh), "cpu")
    new, metrics = task.train_step(state, b)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _numpy(new.params),
            "batch_stats": _numpy(new.batch_stats),
            "mu": _numpy(new.opt_state[1][0]["mu"]),
            "nu": _numpy(new.opt_state[1][0]["nu"])}


def train_cli(module: str, argv: list, stop_at=None, stop_path=None):
    """``python -m ...<module> argv`` in this rank.  With ``stop_at``,
    rank 0 writes ``stop_path`` during its ``stop_at``-th step (the file
    a user touches to end a run)."""
    import importlib
    if stop_at is not None and os.environ["RANK"] == "0":
        cls = (PWT.WaveNetTask if module == "train_vocoder"
               else PTT.TacotronTask)
        real, calls = cls.train_step, []

        def step(self, *a, **kw):
            calls.append(1)
            if len(calls) == stop_at:
                open(stop_path, "w").close()
            return real(self, *a, **kw)
        cls.train_step = step
    importlib.import_module(
        f"tacotron_wavenet_vocoder_korean_tpu_torch.{module}").main(argv)
