"""Device meshes for the port: a grid of torch devices with named axes.

The counterpart of the JAX package's ``make_mesh`` / ``make_mesh_from_spec``
(``repro/compat.py``, re-exported by ``repro/launch/mesh.py``), without
JAX. A ``Mesh`` is a NumPy object array of ``torch.device`` with one named
axis per dimension. The port is single-controller like the reference: one
host loop drives every position, a data shard's kernels launch on its
position's device, and a reduce over an axis (the reference's ``psum``) is a
sum of the positions' tensors on one device.

An explicit ``devices`` list may repeat a device: eight positions on
``"cpu"`` run a 4x2 mesh's shard arithmetic with the plain kernel versions,
and eight on ``"cuda:0"`` run it on one card (which then measures no
interconnect). The reference's ``make_production_mesh`` (a 16x16 TPU pod)
has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of torch devices."""

    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device, one dimension per axis

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        """Each device the mesh places a position on, once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def grid(self, data_axes: tuple[str, ...], model_axis: str | None) -> np.ndarray:
        """``(D, M)`` object array of the devices at each (data shard,
        candidate group) position: the data axes flattened in order (the
        first major, as the reference shards rows over several axes), the
        model axis next; any other axis is a replica and contributes its
        first index."""
        names = list(self.axis_names)
        unknown = [a for a in (*data_axes, model_axis) if a is not None and a not in names]
        if unknown:
            raise ValueError(f"mesh axes {tuple(names)} have no axis {unknown[0]!r}")
        lead = [names.index(a) for a in data_axes]
        if model_axis is not None:
            lead.append(names.index(model_axis))
        rest = [i for i in range(len(names)) if i not in lead]
        arr = self.devices.transpose(lead + rest)
        D = math.prod(self.devices.shape[i] for i in lead[:len(data_axes)])
        M = self.devices.shape[names.index(model_axis)] if model_axis is not None else 1
        return arr.reshape(D, M, -1)[:, :, 0]


def _normalize(device) -> torch.device:
    """``resolve_device``, with a bare ``cuda`` pinned to the current card so
    that repeated positions compare equal to an explicit ``cuda:0``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``. With no ``devices``, the
    first ``prod(shape)`` CUDA devices, raising when there are fewer (as
    ``jax.make_mesh`` does); an explicit list (which may repeat a device)
    fills the mesh in row-major order. A mesh never lands on the CPU unless
    the caller lists the CPU."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit axis names {axes}")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"Number of devices {have} must be >= the product of mesh_shape {shape}; "
                f"pass devices= (a device may repeat) to place several positions on one"
            )
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [_normalize(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a mesh of {n} positions {shape}")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh holds one device type, got {sorted({d.type for d in devs})}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return Mesh(axes, arr.reshape(shape))


def make_mesh_from_spec(spec: str, devices=None) -> Mesh:
    """e.g. "4x2" -> (data, model); "2x4x2" -> (pod, data, model)."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):] if len(dims) == 3 else ("data", "model")
    return make_mesh(dims, axes, devices)
