"""Logical-axis -> mesh-axis sharding rules, divisibility-aware.

The JAX package's ``sharding/rules.py`` over the port's meshes
(``repro_torch.launch.mesh.Mesh``). Every tensor is annotated with *logical*
axis names ("batch", "heads", "ff", "experts", "vocab", ...). A
``MeshRules`` bound to a mesh resolves them to ``PartitionSpec``s, falling
back to replication when a dimension does not divide the mesh axes' extent
(e.g. xlstm's 4 heads on a 16-way model axis, or seamless' 256206 vocab).

A ``PartitionSpec`` is a tuple, one entry per dimension: ``None``, an axis
name, or a tuple of names. A ``NamedSharding`` pairs it with a mesh and
splits a tensor into the blocks the mesh positions hold (``Sharded``), and
reassembles them. The reference lets XLA keep a copy of a replicated block
on every device that holds it; the port stores each distinct block once, on
the device of the first position (in row-major mesh order) that holds it.
Splitting a whole tensor sends its blocks out from the first position, and
reassembling one gathers them there: both charge an active cost recorder
(``repro_torch.launch.cost``) the bytes that leave a position.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.launch import cost
from repro_torch.launch.mesh import Mesh

# logical axis -> preferred mesh axes (tried in order; tuple entries combine)
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), ("data",)),  # DP over pod+data when present
    "heads": (("model",),),  # TP: attention q-heads
    "kv_heads": (("model",),),  # TP: kv heads (replicated if indivisible)
    "ff": (("model",),),  # TP: MLP hidden
    "experts": (("model",),),  # EP: MoE experts
    "vocab": (("model",),),  # TP: embedding/logits vocab shard
    "seq_kv": (("model",),),  # SP: decode KV-cache sequence shard
    "d_inner": (("model",),),  # TP: SSM inner channels
    "embed": (),
    "layers": (),
    "seq": (),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (unsplit), an axis name, or a
    tuple of axis names whose extents multiply."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor of ``shape`` held as blocks over a mesh: ``blocks`` maps each
    block's coordinates (one per dimension) to its tensor, on the device of
    the first mesh position that holds it."""

    sharding: NamedSharding
    shape: tuple
    blocks: dict

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first block's by default)."""
        first = next(iter(self.blocks.values()))
        out = torch.empty(self.shape, dtype=first.dtype, device=device if device is not None else first.device)
        away = sum(b.numel() * b.element_size() for c, b in self.blocks.items() if any(c))
        if away:
            cost.collective("all-gather", out.numel() * out.element_size(), away)
        for c, s in self.sharding.slices(self.shape).items():
            out[s] = self.blocks[c].to(out.device)
        return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a spec over a mesh."""

    mesh: Mesh
    spec: PartitionSpec

    def grid(self, shape) -> tuple[int, ...]:
        """Blocks along each dimension of a tensor of ``shape``."""
        if len(shape) != len(self.spec):
            raise ValueError(f"spec {self.spec} does not fit shape {tuple(shape)}")
        sizes = self.mesh.shape
        out = tuple(math.prod(sizes[a] for a in _entry_axes(e)) for e in self.spec)
        for n, (size, e) in enumerate(zip(shape, out)):
            if size % e:
                raise ValueError(f"dimension {n} of {tuple(shape)} does not split {e} ways ({self.spec})")
        return out

    def slices(self, shape) -> dict[tuple, tuple]:
        """Block coordinates -> the index (a tuple of slices) of its block."""
        grid = self.grid(shape)
        return {c: tuple(slice(i * (s // n), (i + 1) * (s // n)) for i, s, n in zip(c, shape, grid))
                for c in np.ndindex(*grid)}

    def placement(self) -> dict[tuple, torch.device]:
        """Block coordinates -> the device of the first position holding it."""
        names = self.mesh.axis_names
        out = {}
        for pos in np.ndindex(*self.mesh.devices.shape):
            c = []
            for e in self.spec:
                i = 0
                for a in _entry_axes(e):
                    i = i * self.mesh.shape[a] + pos[names.index(a)]
                c.append(i)
            out.setdefault(tuple(c), self.mesh.devices[pos])
        return out

    def split(self, t: torch.Tensor) -> Sharded:
        """``t``'s blocks, each a contiguous copy on its device."""
        where = self.placement()
        blocks = {c: t[s].to(where[c], copy=True, memory_format=torch.contiguous_format)
                  for c, s in self.slices(tuple(t.shape)).items()}
        away = sum(b.numel() * b.element_size() for c, b in blocks.items() if any(c))
        if away:
            cost.collective("collective-permute", away, away)
        return Sharded(self, tuple(t.shape), blocks)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Mesh
    rules: dict | None = None

    def _axes_for(self, logical: str | None, dim_size: int) -> tuple[str, ...] | None:
        table = self.rules or DEFAULT_RULES
        for cand in table.get(logical, ()):
            cand = tuple(a for a in cand if a in self.mesh.shape)
            if not cand:
                continue
            extent = 1
            for a in cand:
                extent *= self.mesh.shape[a]
            if extent > 1 and dim_size % extent == 0:
                return cand
        return None

    def spec(self, logical_axes: tuple, shape: tuple) -> PartitionSpec:
        """PartitionSpec for a tensor given its logical axes and shape."""
        assert len(logical_axes) == len(shape), (logical_axes, shape)
        used: set[str] = set()
        out = []
        for name, size in zip(logical_axes, shape):
            axes = self._axes_for(name, size)
            if axes and not (set(axes) & used):
                out.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                out.append(None)
        return PartitionSpec(*out)

    def sharding(self, logical_axes: tuple, shape: tuple) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes, shape))


def logical_to_spec(mesh: Mesh, logical_axes: tuple, shape: tuple) -> PartitionSpec:
    return MeshRules(mesh).spec(logical_axes, shape)
