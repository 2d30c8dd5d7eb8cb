"""Background-prefetching batch loader.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4)``
(Utils.py:49-55): a producer thread assembles batches (itself fanning image
decodes over a thread pool, datasets.py) while the consumer feeds the
device, so host IO overlaps accelerator compute."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

_SENTINEL = object()


class Prefetcher:
    """Wraps a batch generator factory; each ``epoch()`` yields batches
    produced ``depth`` ahead on a daemon thread.  Exceptions in the producer
    re-raise in the consumer; abandoning the epoch early (exception or
    ``close()`` on the consumer side) unblocks and stops the producer."""

    def __init__(self, epoch_fn: Callable[[], Iterator], depth: int = 3) -> None:
        self.epoch_fn = epoch_fn
        self.depth = depth

    def epoch(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list = []

        def put_interruptible(item) -> bool:
            """Blocking put that gives up when the consumer abandoned us."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.epoch_fn():
                    if not put_interruptible(batch):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                err.append(e)
            finally:
                put_interruptible(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        completed = False
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    completed = True
                    break
                yield item
        finally:
            # consumer finished or abandoned the generator: release the
            # producer (it may be blocked on a full queue) and reap it
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
        if completed and err:
            raise err[0]
