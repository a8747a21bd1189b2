"""repro_torch.mining.tune — the backend registry, kernel execution plans
and a small persisted autotuner for the early-stop wave kernel's tile.

* **Backend registry.** ``MineSpec.backend`` names resolve here to a
  concrete backend for the device the miner runs on, keyed on the torch
  device type: ``auto`` picks the CUDA kernels on a CUDA device and the
  plain PyTorch versions (``torch``) on the CPU; ``cuda`` is only
  available on a CUDA device; ``torch`` resolves everywhere, but the plain
  versions take CPU tensors only (a kernel wrapper handed a CUDA tensor
  launches its kernel or raises). Unknown names — including the JAX
  package's ``pallas*`` names — raise with the registered list.

* **KernelPlan.** One frozen record of what the execution layer needs to
  launch a wave: the resolved backend, the early-stop liveness tile
  ``la_block`` and the early-stop flag. ``HPrepostMiner`` resolves a plan
  per (candidate-count, N-list-width) bucket. The CUDA kernels take one
  candidate per block and tile no Y codes, so the reference's
  ``ly_block``/``batch_block`` have no counterpart here.

* **KernelTuner.** Times the wave kernel over ``la_block`` choices on
  first use per (backend, device type, early stop, width bucket, batch
  bucket) and persists the winner as ``kernel_plans.json`` next to the
  ``SnapshotStore``, so a warm process reruns its best plan with zero
  trials. ``la_block`` moves only the time, never the answer.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.atomic import fsync_write

PLANS_SCHEMA = 1
PLANS_FILENAME = "kernel_plans.json"

# user-facing backend names -> how they resolve per device type. ``None``
# means "not available here" and makes resolve_backend raise.
_REGISTRY: dict[str, dict[str, str | None]] = {
    "auto": {"cuda": "cuda", "*": "torch"},
    "cuda": {"cuda": "cuda", "*": None},
    "torch": {"*": "torch"},
}


def registered_backends() -> list[str]:
    """Every name ``MineSpec.backend`` may carry."""
    return sorted(_REGISTRY)


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_backend(name: str, device_type: str | None = None) -> str:
    """Map a user-facing backend name to the concrete backend for
    ``device_type`` (default: CUDA when present, else CPU). Unknown names
    and unavailable backends raise ValueError."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(registered_backends())}"
        )
    device_type = device_type or default_device_type()
    table = _REGISTRY[name]
    resolved = table.get(device_type, table.get("*"))
    if resolved is None:
        raise ValueError(f"backend {name!r} is not available on a {device_type!r} device")
    return resolved


def check_backend(backend: str, t: torch.Tensor) -> None:
    """Raise unless concrete ``backend`` can run on ``t``'s device: the CUDA
    kernels take CUDA tensors, the plain versions CPU tensors."""
    want = "cuda" if backend == "cuda" else "cpu"
    if t.device.type != want:
        raise ValueError(
            f"backend {backend!r} runs on {want} tensors, got a tensor on {t.device}"
        )


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Resolved execution config for one wave launch: a concrete backend,
    the liveness tile, and the early-stop flag. ``source`` records where the
    tile came from (``config`` = the HPrepostConfig field, ``tuned`` = fresh
    search, ``cached`` = persisted search)."""

    backend: str
    la_block: int
    early_stop: bool
    source: str = "config"


def static_plan(
    backend: str,
    la_block: int,
    early_stop: bool,
    device_type: str | None = None,
) -> KernelPlan:
    """A plan straight from config knobs — no search, backend resolved."""
    return KernelPlan(
        backend=resolve_backend(backend, device_type),
        la_block=la_block,
        early_stop=early_stop,
        source="config",
    )


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n, clamped to [lo, hi] — plans are keyed
    per bucket, not per exact shape."""
    n = max(int(n), 1)
    b = 1 << (n - 1).bit_length()
    return max(lo, min(hi, b))


def _synthetic_nlists(B: int, W: int) -> tuple[np.ndarray, ...]:
    """Timing fixtures: shape- and dtype-faithful PP-code batches, seeded.

    The wave kernel's cost depends on the data (B2 stops reading at a
    candidate's first dead tile), unlike the reference's dense contraction.
    On these sorted random full-width codes at ``min_count=2`` no candidate
    dies early, so the search times B2 at its worst case; a plan moves only
    the time, never the answer."""
    rng = np.random.default_rng(0)
    a_pre = np.sort(rng.integers(0, 1 << 20, (B, W)), axis=1).astype(np.int32)
    a_post = np.sort(rng.integers(0, 1 << 20, (B, W)), axis=1).astype(np.int32)
    y_pre = np.sort(rng.integers(0, 1 << 20, (B, W)), axis=1).astype(np.int32)
    y_post = np.sort(rng.integers(0, 1 << 20, (B, W)), axis=1).astype(np.int32)
    y_cnt = rng.integers(1, 8, (B, W)).astype(np.int32)
    a_cnt = rng.integers(1, 8, (B, W)).astype(np.int32)
    return a_pre, a_post, a_cnt, y_pre, y_post, y_cnt


class KernelTuner:
    """Timed ``la_block`` search with a cross-process JSON plan cache.

    ``plan_for`` is the only entry point: it buckets the requested shape,
    serves a persisted plan when one exists (``stats['trials']`` stays 0),
    and otherwise times the wave kernel at each choice and persists the
    winner atomically. ``la_block`` only changes B2, so with early stop off
    the search has one choice, still timed once. A search that cannot build
    or launch a kernel raises.
    """

    LA_CHOICES = (128, 256, 512)

    def __init__(self, plan_dir: str | None = None, platform: str | None = None):
        self._dir = plan_dir
        self._platform = platform or default_device_type()
        self._plans: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.stats = {
            "trials": 0,       # timed kernel launches this process
            "tuned": 0,        # keys searched this process
            "plan_hits": 0,    # keys served from memory/disk
            "loaded_plans": 0, # keys read from kernel_plans.json
        }
        if self._dir:
            self._load()
            self.stats["loaded_plans"] = len(self._plans)

    # ------------------------------------------------------------ persistence
    def _path(self) -> str:
        return os.path.join(self._dir, PLANS_FILENAME)

    def _load(self) -> None:
        try:
            with open(self._path(), "rb") as f:
                doc = json.loads(f.read().decode())
        except (FileNotFoundError, ValueError, OSError):
            return
        if doc.get("schema") != PLANS_SCHEMA:
            return
        self._plans.update(doc.get("plans", {}))

    def _save(self) -> None:
        if not self._dir:
            return
        os.makedirs(self._dir, exist_ok=True)
        doc = {"schema": PLANS_SCHEMA, "plans": self._plans}
        fsync_write(self._path(), json.dumps(doc, indent=1, sort_keys=True).encode())

    # ------------------------------------------------------------ the search
    def _key(self, backend: str, B: int, W: int, early_stop: bool) -> str:
        wb = _bucket(W, 8, 1024)
        bbk = _bucket(B, 8, 512)
        return f"{backend}|{self._platform}|es{int(early_stop)}|W{wb}|B{bbk}"

    def _measure_us(self, backend, B, W, la, early_stop, reps=3) -> float:
        from repro_torch.kernels.nlist_intersect.ops import nlist_intersect

        device = torch.device("cuda" if backend == "cuda" else "cpu")
        a_pre, a_post, a_cnt, y_pre, y_post, y_cnt = (
            torch.from_numpy(a).to(device) for a in _synthetic_nlists(B, W)
        )

        def launch():
            nlist_intersect(
                a_pre, a_post, y_pre, y_post, y_cnt,
                a_cnt=a_cnt, backend=backend, la_block=la,
                early_stop=early_stop, min_count=2 if early_stop else None,
            )
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        launch()  # builds the kernel on first use: outside the timed region
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            launch()
            best = min(best, time.perf_counter() - t0)
            self.stats["trials"] += 1
        return best * 1e6

    def _search(self, backend: str, B: int, W: int, early_stop: bool) -> dict:
        # measure at the bucketed shape (that is what the key promises); the
        # plain versions run on the CPU, so cap their fixture sizes
        wb = _bucket(W, 8, 1024)
        bbk = _bucket(B, 8, 512)
        if backend == "torch":
            wb, bbk = min(wb, 128), min(bbk, 32)
        if early_stop:
            la_opts = sorted({min(wb, c) for c in self.LA_CHOICES})
        else:
            la_opts = [min(wb, self.LA_CHOICES[-1])]  # B1 reads no tile
        best = None
        for la in la_opts:
            us = self._measure_us(backend, bbk, wb, la, early_stop)
            if best is None or us < best["best_us"]:
                best = {"la_block": la, "best_us": round(us, 1), "trials": len(la_opts)}
        return best

    # -------------------------------------------------------------- frontdoor
    def plan_for(
        self,
        *,
        backend: str,
        B: int,
        W: int,
        early_stop: bool,
    ) -> KernelPlan:
        """The plan for a wave of ``B`` candidates over ``W``-slot N-lists:
        the persisted one, else a fresh search."""
        resolved = resolve_backend(backend, self._platform)
        key = self._key(resolved, B, W, early_stop)
        with self._lock:
            rec = self._plans.get(key)
            if rec is not None:
                self.stats["plan_hits"] += 1
                src = "cached"
            else:
                rec = self._search(resolved, B, W, early_stop)
                self._plans[key] = rec
                self._save()
                self.stats["tuned"] += 1
                src = "tuned"
            return KernelPlan(
                backend=resolved,
                la_block=int(rec["la_block"]),
                early_stop=early_stop,
                source=src,
            )
