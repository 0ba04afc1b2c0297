"""Background prefetch of batches onto the device (counterpart of the JAX
package's ``data/feeder.py``).

A daemon thread draws batches from the batcher and keeps up to
``buffer_size`` of them queued, already on the device, so the training
step never waits on the host.  On a card, a host batch is copied into
pinned memory and from there to the card on a side stream, with an event
per batch; the consumer's stream waits on that event.  The thread works
on the prefetcher's card (a rank's own on a mesh).  Batches already on
the device (the device store's) pass through.  An error in the thread is
raised in the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Union

import torch

from ..device import resolve_device
from ..train.wavenet_task import batch_to_device

Batch = Dict[str, torch.Tensor]


def pin_batch(batch: Any) -> Batch:
    """A host batch (a ``WaveNetBatch`` or a dict of arrays) as tensors in
    pinned memory, with ``batch_to_device``'s keys and dtypes."""
    return {k: v.pin_memory()
            for k, v in batch_to_device(batch, torch.device("cpu")).items()}


def _on_device(batch: Any, device: torch.device) -> bool:
    return isinstance(batch, dict) and all(
        isinstance(v, torch.Tensor) and v.device == device
        for v in batch.values())


class DevicePrefetcher:
    def __init__(self, batcher, put_fn: Optional[Callable[[Any], Batch]]
                 = None, buffer_size: int = 2,
                 device: Union[str, torch.device, None] = None):
        """``put_fn`` maps a host batch to a dict of tensors that are then
        copied to ``device`` (``cuda`` unless the caller asks for
        another); by default ``pin_batch`` on a card, ``batch_to_device``
        on the CPU.  ``pinned_batches`` counts the batches copied from
        pinned memory."""
        dev = resolve_device(device)
        cuda = dev.type == "cuda"
        if cuda and dev.index is None:     # as tensors name it: cuda:<n>
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._batcher = batcher
        self._put = put_fn or (pin_batch if cuda else
                               lambda b: batch_to_device(b, self.device))
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.pinned_batches = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-prefetcher")
        self._thread.start()

    def _transfer(self, batch: Any):
        """``(batch on the device, the event its copy recorded or None)``."""
        if _on_device(batch, self.device):
            return batch, None
        host = self._put(batch)
        if self._stream is None:
            return {k: v.to(self.device) for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        if all(v.is_pinned() for v in host.values()):
            self.pinned_batches += 1
        return out, event

    def _run(self) -> None:
        try:
            if self._stream is not None:
                # this thread's pinned copies and events on this rank's card
                torch.cuda.set_device(self.device)
            for batch in self._batcher:
                if self._stop.is_set():
                    return
                self._queue.put(self._transfer(batch))
        except BaseException as e:  # raised again in the consumer
            self._error = e
            self._queue.put(None)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        item = self._queue.get()
        if item is None and self._error is not None:
            raise self._error
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def _drain(self) -> None:
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def stop(self) -> None:
        """Stop the thread: drain the queue until it has returned."""
        self._stop.set()
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.05)
        self._drain()
