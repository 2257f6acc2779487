"""Streaming-generation helpers (own copy of ``medtok_tpu/qa/callbacks.py``).

``generate`` runs a host-side decode loop with an ``on_token`` callback;
``TokenStreamer`` turns those calls into a blocking iterator and
``stream_generate`` runs any such generator on a worker thread and yields
its tokens.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class TokenStreamer:
    """Iterator over generated tokens; pass .put as on_token to a generator
    running in another thread, then iterate. None terminates the stream."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()

    def put(self, token: int) -> None:
        self._q.put(int(token))

    def end(self) -> None:
        self._q.put(None)

    def __iter__(self) -> Iterator[int]:
        while True:
            tok = self._q.get()
            if tok is None:
                return
            yield tok


def stream_generate(
    generate_fn: Callable[..., np.ndarray],
    *args,
    **kwargs,
) -> Iterator[int]:
    """Run ``generate_fn(*args, on_token=..., **kwargs)`` on a worker thread
    and yield tokens as they are produced (the Iteratorize pattern)."""
    streamer = TokenStreamer()
    error: list[BaseException] = []

    def worker():
        try:
            generate_fn(*args, on_token=streamer.put, **kwargs)
        except BaseException as e:  # surface worker errors to the consumer
            error.append(e)
        finally:
            streamer.end()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    yield from streamer
    t.join()
    if error:
        raise error[0]
