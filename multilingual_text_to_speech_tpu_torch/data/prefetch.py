"""Background batch prefetching.

A copy of the JAX package's ``data/prefetch.py``: one producer thread keeps
a bounded queue of collated host batches ahead of the training step, so
``np.load`` and padding run while the card works.  The copy to the card
happens in the consumer (``training.trainer.train_step``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class PrefetchIterator:
    """Wrap a batch iterable with an N-deep background producer thread."""

    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None

        def producer():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # surface errors in the consumer
                self._error = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch(iterable: Iterable, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth)
