"""repro_torch.mining.tune — the backend registry and kernel execution plans.

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
  ``la_block`` and the early-stop flag. The CUDA kernels take one
  candidate per block and tile no Y codes, so the reference's
  ``ly_block``/``batch_block`` have no counterpart here.

The reference's ``KernelTuner`` (a timed block search persisted as
``kernel_plans.json``) is not ported yet: ``HPrepostConfig(tune=True)``
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

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
    tile came from (``config`` = the HPrepostConfig field)."""

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
