"""Input pipeline: host batching, prefetch, straggler-aware skip — the JAX
package's ``data/pipeline.py``.

``Prefetcher`` runs the (host) batch generator on a thread and keeps a
bounded queue of batches, overlapping host work with compute. With a
``device``, each batch's numpy arrays become tensors there; for a CUDA
device they are staged in pinned host memory and copied with
``non_blocking=True``, so the copy overlaps the step in flight. If the
``StragglerMonitor`` flags a step, ``skip_slow`` drops the queue head (on a
cluster the slow shard's range would go to a healthy host; here the skip
policy and its bookkeeping are what is tested). As in the reference, the
trainer does not use it.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def _to_device(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    def __init__(self, gen, depth: int = 2, device=None):
        self._gen = gen
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = torch.device(device) if device is not None else None
        self._stop = False
        self._skipped = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for item in self._gen:
            if self._stop:
                return
            if self._device is not None:
                item = {k: _to_device(v, self._device) for k, v in item.items()}
            self._q.put(item)

    def next(self):
        return self._q.get()

    def skip_slow(self, n: int = 1):
        """Straggler mitigation: drop ``n`` queued batches (they would have
        been produced by the slow shard) and account for them."""
        for _ in range(n):
            try:
                self._q.get_nowait()
                self._skipped += 1
            except queue.Empty:
                break

    @property
    def skipped(self) -> int:
        return self._skipped

    def close(self):
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
