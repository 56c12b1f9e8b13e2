"""One-batch-in-flight helper (the port's copy of
``vae_tagger_tpu/utils/pipelining.py``).

CUDA launches are asynchronous: work queued on the stream returns at once
and only copying the result to the host waits.  A batched host<->device loop
therefore dispatches batch N+1, THEN consumes batch N, so the device runs
while the host formats the previous batch.
"""

from __future__ import annotations

from typing import Callable


class OneInFlight:
    """Defers ``resolve(*payload)`` by one ``submit`` call.

    >>> pipeline = OneInFlight(resolve)
    >>> for item in items:
    ...     handle = dispatch(item)        # async device work
    ...     pipeline.submit(handle, item)  # resolves the PREVIOUS payload
    >>> pipeline.flush()                   # resolves the last one
    """

    def __init__(self, resolve: Callable):
        self._resolve = resolve
        self._pending = None

    def submit(self, *payload) -> None:
        if self._pending is not None:
            self._resolve(*self._pending)
        self._pending = payload

    def flush(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._resolve(*pending)
