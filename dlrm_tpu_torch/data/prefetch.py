"""Batches copied to the device ahead of the step that takes them: the
counterpart of ``dlrm_tpu/data/prefetch.py``.

In a gang of processes (the sharded path) each process is fed only its own
rows of every global batch (``run._batch_iter(rows=)``, from
``parallel.mesh.local_batch_rows``), and the sharded steps take those rows
as they come (``local_batch``); so this moves only the rank's rows to its
device, and nothing is assembled: the JAX package's
``_put_process_local``, which builds a global array from each process's
rows, has no counterpart here.

A background thread pulls batches (dicts of numpy arrays or CPU tensors)
from the source and, on a CUDA device, issues their host-to-device copies
from pinned host memory on a side stream, so that the marshal of batch N+1
and its copy overlap step N.  The consumer's stream waits on an event
recorded after each batch's copies.  At most ``size`` batches are pulled
from the source and copied ahead of the consumer: a semaphore slot is taken
before each pull and given back when the consumer takes the batch.  Order
and contents are the source's, and an exception of the source is raised at
the consumer.  On the CPU the batches pass through unchanged, with no
thread: there is no copy to overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator

import numpy as np
import torch

from dlrm_tpu_torch.utils.telemetry import count, phase_scope, recording


class _End:
    """End of the stream, with the source's exception if it raised."""

    def __init__(self, exc):
        self.exc = exc


def _cuda_transfer(device: torch.device):
    """(put, take): ``put`` runs on the producer thread and issues a
    batch's copies on a side stream; ``take`` runs on the consumer and
    makes its current stream wait for them."""
    side = torch.cuda.Stream(device)

    def put(batch: Dict) -> tuple:
        out = {}
        with torch.cuda.device(device), torch.cuda.stream(side):
            for k, v in batch.items():
                host = v if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(v))
                if host.device.type == "cpu" and not host.is_pinned():
                    # from the caching host allocator, which records an
                    # event for the copy below and hands the block out
                    # again only once that copy has completed
                    host = host.pin_memory()
                out[k] = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def take(item: tuple) -> Dict[str, torch.Tensor]:
        out, done = item
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for t in out.values():
            # allocated for the side stream and used on this one: without
            # this the caching allocator could hand the memory to the next
            # copy while this stream still reads it
            t.record_stream(current)
        return out

    return put, take


def device_prefetch(source: Iterable, *, size: int = 2,
                    device) -> Iterator:
    """Yield the batches of ``source``, each on ``device`` (CUDA: tensors
    whose copies the current stream has been made to wait for, pulled and
    copied up to ``size`` ahead; CPU: the batch as the source gave it)."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    if device.type != "cuda":
        return iter(source)
    return _ahead(source, size, *_cuda_transfer(device))


def _ahead(source: Iterable, size: int, put: Callable, take: Callable
           ) -> Iterator:
    """``take(put(batch))`` for each batch of ``source``, with ``put`` run
    on a background thread at most ``size`` batches ahead of the consumer.

    Abandoning the iterator stops the thread once it next asks for a
    slot; it holds at most ``size`` batches until then.  The consumer's
    wait and take run under the span ``prefetch.take`` (never open across
    the ``yield``), counted by ``prefetch.takes`` and, when no batch was
    queued yet, ``prefetch.empty``.
    """
    q: "queue.Queue" = queue.Queue()
    slots = threading.Semaphore(size)
    stop = threading.Event()

    def producer():
        try:
            it = iter(source)
            while True:
                slots.acquire()  # before the pull and the copy
                if stop.is_set():
                    return
                try:
                    batch = next(it)
                except StopIteration:
                    break
                q.put(put(batch))
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            q.put(_End(e))
            return
        q.put(_End(None))

    threading.Thread(target=producer, daemon=True,
                     name="dlrm-prefetch").start()
    try:
        while True:
            # the producer thread may have started before a profiler: only
            # the consumer's side is seen, so it is named and counted here
            with phase_scope("prefetch.take"):
                if recording():
                    count("prefetch.takes")
                    count("prefetch.empty", q.empty())
                item = q.get()
                if isinstance(item, _End):
                    if item.exc is not None:
                        raise item.exc
                    return
                slots.release()  # the consumer owns this batch now
                batch = take(item)
            yield batch
    finally:
        stop.set()
        slots.release()  # wake a producer waiting for a slot
