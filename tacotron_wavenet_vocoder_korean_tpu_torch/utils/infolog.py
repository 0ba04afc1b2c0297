"""Timestamped logging to stdout and a run's log file, a moving average
(counterpart of the JAX package's ``utils/infolog.py``, without its Slack
mirror: the port sends nothing over the network), and the Tacotron
trainer's JSONL scalar log."""
from __future__ import annotations

import atexit
import json
import sys
import time
from datetime import datetime
from typing import Optional

_format = "%Y-%m-%d %H:%M:%S.%f"
_file = None
_rank = 0


def init(filename: str, rank: int = 0) -> None:
    """Append this run's log to ``filename`` (the JAX function's run name
    and Slack URL serve its Slack mirror alone).  On a mesh only rank 0
    writes the file; another rank's ``log`` prints to stderr, prefixed
    with its rank."""
    global _file, _rank
    close()
    _rank = rank
    if rank != 0:
        return
    _file = open(filename, "a", encoding="utf-8")
    _file.write("\n-----------------------------------------------------------------\n")
    _file.write("Starting new training run\n")
    _file.write("-----------------------------------------------------------------\n")


def log(msg: str) -> None:
    if _rank != 0:
        print(f"[rank {_rank}] {msg}", file=sys.stderr, flush=True)
        return
    print(msg, flush=True)
    if _file is not None:
        _file.write(f"[{datetime.now().strftime(_format)[:-3]}]  {msg}\n")
        _file.flush()


def close() -> None:
    global _file
    if _file is not None:
        _file.close()
        _file = None


atexit.register(close)


class ValueWindow:
    """Moving average over the last ``window_size`` values."""

    def __init__(self, window_size: int = 100):
        self._window_size = window_size
        self._values = []

    def append(self, x: float) -> None:
        self._values = self._values[-(self._window_size - 1):] + [float(x)]

    @property
    def sum(self) -> float:
        return sum(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)

    def reset(self) -> None:
        self._values = []


class MetricsWriter:
    """Appends one JSON line per call: ``step``, ``time`` and every 0-d
    value of ``metrics`` as a float (the JAX Tacotron trainer's
    ``metrics.jsonl``).  With ``path`` None (a rank other than 0) it
    writes nothing."""

    def __init__(self, path: Optional[str]):
        self._f = None if path is None else open(path, "a", encoding="utf-8")

    def write(self, step: int, metrics: dict) -> None:
        if self._f is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()
                    if getattr(v, "ndim", 0) == 0})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
