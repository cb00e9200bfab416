"""Cooperative cancellation for host-side loops.

The reference threads an std::atomic<bool> canceller through every long
algorithm and polls it between hops/frames
(reference: src/flan/defines.h:49-62, e.g. Conversions/AudioPV.cpp:49).

Copied from flan_tpu/utils/cancel.py. A kernel launched on the card is
not cooperatively interruptible: once a stage is queued it runs to its
end, and a per-hop cancel point inside it would stall the card on the
host. Cancellation is therefore honored at every host-side loop boundary
instead: between clips in the CLI, and anywhere else Python iterates
device work. The granularity is one dispatch (seconds of audio) rather
than one hop (milliseconds).
"""
from __future__ import annotations

import threading


class CancelToken:
    """Thread-safe cooperative cancellation flag
    (reference defines.h:49-62 flan_CANCEL_ARG/flan_CANCEL_POINT)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise Cancelled if cancel() was called (the flan_CANCEL_POINT
        analog for host-side loops)."""
        if self._event.is_set():
            raise Cancelled()


class Cancelled(Exception):
    """Raised by CancelToken.check() at a host-side cancel point."""
