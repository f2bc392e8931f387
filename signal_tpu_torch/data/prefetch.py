"""Host→device prefetch: overlap decode + H2D with device compute (the
port's own copy of `signal_tpu/data/prefetch.py`).

A single background thread drains the loader (whose own thread pool does
the decode) and eagerly runs ``put`` (the host→device copy), so batch
n+1's decode and transfer run while the device executes batch n.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, put: Callable, depth: int = 2) -> Iterator:
    """Yield ``put(item)`` for each item, computed ``depth`` items ahead in
    a daemon thread. ``put`` typically copies the batch to the device; the
    bounded queue caps host+device memory at ``depth`` in-flight batches.

    Exceptions from the worker re-raise at the consuming ``next()`` call.
    Abandoning the generator early (break / GeneratorExit) signals the
    worker to stop after at most one more ``put`` and unblocks it, so a
    preempted train loop doesn't strand threads across epochs."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err = []
    stop = threading.Event()

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    break
                q.put(put(item))
        except BaseException as e:  # noqa: BLE001 — surface to consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=worker, daemon=True,
                     name="signal-tpu-torch-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
        try:  # free a queue slot so a worker blocked on q.put can exit
            while q.get_nowait() is not _SENTINEL:
                pass
        except queue.Empty:
            pass
    if err:
        raise err[0]
