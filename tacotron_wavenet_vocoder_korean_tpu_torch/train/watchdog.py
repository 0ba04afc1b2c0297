"""The training loop's hang watchdog (counterpart of the JAX package's
``train/watchdog.py`` ``HangWatchdog``; its RSS and slowdown watchdogs and
``exec_restart`` answer a leak of the TPU client and are not ported)."""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


class HangWatchdog:
    """Hard-exit the process when the training loop stops making progress.

    A device call that never returns blocks the loop (and any checkpoint
    save) in native code, where no exception can reach it; the process
    must die so that a supervisor can restart it from the last checkpoint
    (``until python -m ...train_vocoder ... --load_path D; do sleep 60;
    done``).  The loop calls :meth:`beat` at every sync boundary; a daemon
    thread calls ``os._exit(EXIT_CODE)`` when no beat arrives within
    ``timeout_s``, or within ``first_timeout_s`` before the first beat (a
    resume restores and warms up before it can beat; a grace shorter than
    ``timeout_s`` is ignored).  A ``timeout_s`` of 0 or less disarms it.
    """

    EXIT_CODE = 42

    def __init__(self, timeout_s: float,
                 log_fn: Callable[[str], None] = print,
                 first_timeout_s: Optional[float] = None):
        self.timeout_s = timeout_s
        if first_timeout_s and timeout_s and first_timeout_s <= timeout_s:
            log_fn(f"HangWatchdog: ignoring first_timeout_s="
                   f"{first_timeout_s:.0f}s <= steady-state timeout "
                   f"{timeout_s:.0f}s (a grace period only makes sense "
                   f"when it is longer)")
        self.first_timeout_s = (
            first_timeout_s
            if first_timeout_s and first_timeout_s > timeout_s else None)
        self._log = log_fn
        self._last = time.monotonic()
        self._beaten = False
        self._stopped = False
        if timeout_s and timeout_s > 0:
            t = threading.Thread(target=self._watch, daemon=True,
                                 name="hang-watchdog")
            t.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self._beaten = True

    def stop(self) -> None:
        """Disarm (the clean ends of a run)."""
        self._stopped = True

    def _watch(self) -> None:
        while not self._stopped:
            time.sleep(min(30.0, self.timeout_s / 4))
            in_grace = self.first_timeout_s and not self._beaten
            limit = self.first_timeout_s if in_grace else self.timeout_s
            stalled = time.monotonic() - self._last
            if not self._stopped and stalled > limit:
                try:
                    phase = ("no first beat (restore/warm-up phase)"
                             if in_grace else "no train-loop progress")
                    self._log(
                        f"HangWatchdog: {phase} for {stalled:.0f}s "
                        f"(> {limit:.0f}s) — device call presumed wedged; "
                        f"hard-exiting {self.EXIT_CODE} so a supervisor "
                        f"can resume from the last checkpoint")
                    sys.stdout.flush()
                    sys.stderr.flush()
                except Exception:
                    pass
                os._exit(self.EXIT_CODE)
