"""Host input pipeline with background prefetch.

Port of attngan_tpu/data/prefetch.py (the port imports nothing of the JAX
package). The reference's DataLoader blocks the train loop on host-side
batch assembly (single process, num_workers 0). Here a daemon thread
prepares the next host batches while the current step runs.

The thread does host work only. The training loops give it
``data.dataset.pinned_batch`` as its transform: it shuffles, tokenizes,
stacks the pixels and copies them into page-locked memory, and the main
thread then issues the non-blocking copies to the GPU and the pyramid
(``Dataset.device_batch``) on its own stream, ahead of the step that
reads them. A tensor made on the GPU by this thread would live on another
stream than the step's, and would need an event wait and
``record_stream`` so that the caching allocator does not hand its memory
to a running step; with one stream for all device work there is nothing
to order. The copies are small (3 MB of uint8 pixels a GAN batch of 16)
and the pinned source lets them run without holding the host.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Iterator, Optional

_SENTINEL = object()


def prefetch(iterator: Iterator, transform: Optional[Callable] = None,
             depth: int = 2) -> Iterator:
    """Wrap ``iterator``, applying ``transform`` in a background thread and
    keeping up to ``depth`` results in flight.

    Shutdown-safe: when the consumer stops early (break / generator close),
    the worker is signalled and exits instead of blocking forever on a full
    queue: otherwise every early exit leaked one thread plus up to
    ``depth + 1`` batches for the life of the process. An error in the
    worker is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that aborts once the consumer has gone away
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(transform(item) if transform is not None
                            else item):
                    return
                if stop.is_set():
                    # the consumer went away while the put was in flight:
                    # drop out now instead of leaving one more batch
                    # referenced by the queue
                    return
        except BaseException as e:  # surfaced in the consumer, re-raised there
            err.append(e)
        finally:
            _put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:  # unblock a worker mid-put by draining queued items
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        if err:
            # the consumer closed early AND the worker had already failed:
            # do not let the pipeline's error vanish with the generator
            logging.getLogger(__name__).warning(
                "prefetch worker failed but the consumer exited early; "
                "suppressed error was: %r", err[0])
