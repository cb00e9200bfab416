"""Prefetching audio loader: decode and stage clip k+1 while the caller
computes on clip k (flan_tpu/io/loader.py's contract).

A producer thread decodes each file on the host (io/files.py). For a CUDA
device it copies the samples into pinned host memory and issues their
host-to-device copy with non_blocking=True on a stream of its own,
recording an event after it. A copy on one stream read on another needs
that order made explicit, or the reader may see a half-copied buffer:
the consumer makes its current stream wait on the clip's event before it
yields the clip, and the pinned buffer is kept until that event has
passed, so the copy never reads freed host memory. On the CPU there is
no stream and no pinning: the decoded array becomes the clip's data.

Contract, as flan_tpu's: input order is kept; a decode error is raised
as RuntimeError(f"failed to load {p}") (a LoadError) at that item's turn;
an abandoned iterator (break, or an error raised mid-stream) stops and
joins its producer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Tuple

import torch

from flan_tpu_torch.core.types import DEFAULT_DEVICE


class LoadError(RuntimeError):
    """A file the loader could not decode; the decoder's error is its
    cause."""


def iter_audio_prefetched(paths: Iterable[str], depth: int = 2,
                          device=DEFAULT_DEVICE
                          ) -> Iterator[Tuple[str, object]]:
    """Yield (path, Audio on `device`) with up to `depth` clips decoded
    and staged ahead."""
    from flan_tpu_torch.audio.audio import Audio
    from flan_tpu_torch.io.files import read_audio_file

    paths = list(paths)
    device = torch.device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    _SENTINEL = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # a bounded put that gives up once the consumer has gone, so an
        # abandoned iterator never leaves a thread blocked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _stage(data):
        """Host array -> (tensor on device, pinned buffer, copy event)."""
        host = torch.from_numpy(data)
        if not on_card:
            return host.to(device), None, None
        pinned = host.pin_memory()
        with torch.cuda.stream(copy_stream):
            staged = pinned.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return staged, pinned, done

    def producer():
        for p in paths:
            if stop.is_set():
                return
            try:
                data, sr, _ = read_audio_file(p)
                staged, pinned, done = _stage(data)
                item = (p, Audio(data=staged, sample_rate=sr), pinned, done,
                        None)
            except Exception as e:  # raised in order on the consumer
                item = (p, None, None, None, e)
            if not _put(item):
                if item[3] is not None:
                    item[3].synchronize()   # the copy still reads pinned
                return
        _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    in_flight = []          # (copy event, pinned buffer) not yet passed
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            p, clip, pinned, done, err = item
            if err is not None:
                raise LoadError(f"failed to load {p}") from err
            if done is not None:
                # the caller's stream reads the clip only after its copy;
                # the data was allocated on the copy stream, so tell the
                # allocator the caller's stream uses it too
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                clip.data.record_stream(current)
                in_flight = [(e, b) for e, b in in_flight if not e.query()]
                in_flight.append((done, pinned))
            yield p, clip
    finally:
        stop.set()
        t.join()
        while not q.empty():        # clips staged but never taken
            item = q.get_nowait()
            if item is not _SENTINEL and item[3] is not None:
                in_flight.append((item[3], item[2]))
        for e, _ in in_flight:
            e.synchronize()
