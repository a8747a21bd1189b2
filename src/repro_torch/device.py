"""Device resolution shared by the port's entry points, the stream
hand-over a mesh needs (one side stream per distinct CUDA device), and the
staging ring that ships large host arrays to a device."""
from __future__ import annotations

import concurrent.futures
import contextlib
import threading

import numpy as np
import torch

# The staging ring's shape, fixed from a sweep on an H100's host (PERF.md §6):
# SLOTS pinned slots of SLOT_BYTES, filled by FILLERS host threads. One host
# thread copies pageable memory at about 4-6 GB/s there, so the fills, not the
# DMAs (about 42 GB/s from pinned memory), set the copy's pace.
SLOT_BYTES = 8 << 20
SLOTS = 8
FILLERS = 6


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def side_streams(devices) -> list:
    """One new CUDA stream per distinct CUDA device in ``devices`` (none for
    the CPU, which has no streams)."""
    out, seen = [], set()
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d not in seen:
            seen.add(d)
            out.append(torch.cuda.Stream(d))
    return out


@contextlib.contextmanager
def on_streams(streams):
    """Make each of ``streams`` the current stream of its device."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


def record_ready(streams) -> tuple | None:
    """An event recorded on each of ``streams``, as ``(device, event)``
    pairs; None when there are no streams (the CPU)."""
    if not streams:
        return None
    out = []
    for s in streams:
        ev = torch.cuda.Event()
        ev.record(s)
        out.append((s.device, ev))
    return tuple(out)


def wait_ready(ready) -> None:
    """Order each device's current stream after its event in ``ready``."""
    for dev, ev in ready or ():
        torch.cuda.current_stream(dev).wait_event(ev)


class StagingRing:
    """Host-to-device copies of large pageable arrays through a few pinned
    slots, in place of one pageable copy (which CUDA stages through buffers
    of its own on one thread).

    A copy cuts its source into slot-sized chunks and sends them through
    the slots in turn. ``fillers`` host threads fill up to ``slots - 1``
    chunks ahead, side by side; as each chunk is filled the caller queues
    its DMA on the destination's current stream and records an event after
    it, and a slot is handed to a filler again only once its event has
    passed. Every CUDA call stays on the caller's thread. One copy at a time
    goes through a ring (a lock), so concurrent callers never share a slot.
    The slots and the threads are made at the first copy and kept. Without
    CUDA the slots are plain host memory and every copy is synchronous."""

    def __init__(self, slot_bytes: int = SLOT_BYTES, slots: int = SLOTS,
                 fillers: int = FILLERS):
        if slots < 2 or fillers < 1:
            raise ValueError(f"a staging ring needs 2 slots or more and a filler: "
                             f"slots={slots}, fillers={fillers}")
        self.slot_bytes = slot_bytes
        self.slots = slots
        self.fillers = fillers
        self._lock = threading.Lock()
        self._slots = None  # per slot: (byte tensor, numpy view of it)
        self._done = None  # per slot: the event after its last DMA, or None
        self._pool = None

    def copy(self, src: np.ndarray, dst: torch.Tensor) -> int:
        """Copy the C-contiguous ``src`` into the contiguous ``dst`` of as
        many bytes. The DMAs are queued on ``dst``'s current stream and read
        only the slots, so ``src`` is free once this returns.
        -> the chunks it took: ceil(bytes / slot_bytes)."""
        nbytes = src.nbytes
        if not src.flags.c_contiguous or not dst.is_contiguous():
            raise ValueError("the staging ring copies contiguous arrays only")
        if dst.numel() * dst.element_size() != nbytes:
            raise ValueError(f"source of {nbytes} bytes, destination of "
                             f"{dst.numel() * dst.element_size()}")
        S, n = self.slot_bytes, self.slots
        n_chunks = -(-nbytes // S)
        src_b = src.reshape(-1).view(np.uint8)
        dst_b = dst.view(-1).view(torch.uint8)
        stream = torch.cuda.current_stream(dst.device) if dst.is_cuda else None
        with self._lock:
            if self._slots is None:
                self._make()
            filled = {}

            def fill(i):  # hand chunk i to a filler once its slot is free
                k = i % n
                if self._done[k] is not None:
                    self._done[k].synchronize()
                a = i * S
                m = min(S, nbytes - a)
                filled[i] = self._pool.submit(np.copyto, self._slots[k][1][:m], src_b[a:a + m])

            try:
                for i in range(min(n - 1, n_chunks)):
                    fill(i)
                for i in range(n_chunks):
                    filled.pop(i).result()
                    k, a = i % n, i * S
                    m = min(S, nbytes - a)
                    dst_b[a:a + m].copy_(self._slots[k][0][:m], non_blocking=stream is not None)
                    if stream is not None:
                        self._done[k] = torch.cuda.Event()
                        self._done[k].record(stream)
                    if i + n - 1 < n_chunks:
                        fill(i + n - 1)  # the slot chunk i - 1 left
            finally:
                # no filler may still write a slot once the lock is released
                concurrent.futures.wait(filled.values())
        return n_chunks

    def _make(self) -> None:
        S = self.slot_bytes
        buf = torch.empty(self.slots * S, dtype=torch.uint8,
                          pin_memory=torch.cuda.is_available())
        self._slots = [(t, t.numpy()) for t in (buf[k * S:(k + 1) * S] for k in range(self.slots))]
        self._done = [None] * self.slots
        self._pool = concurrent.futures.ThreadPoolExecutor(
            self.fillers, thread_name_prefix="staging-fill")
