"""Parameter-spec trees: one model definition drives init, the modules'
parameters and the caches.

A model is described as a nested dict of ``ParamSpec`` leaves (shape, dtype,
logical axes), as in the JAX package. From that single description the port
derives the parameters each block registers (``SpecModule``), materialized
trees for weights and caches (``init_params``), parameter counts
(``n_params``), and a mesh's ``PartitionSpec`` and ``NamedSharding`` trees
(``param_specs_pspec``, ``param_shardings``, over
``repro_torch.sharding.MeshRules``; ``models/convert.py`` maps their stacked
leaves to a ``state_dict``'s keys), and the dry-run's allocation-free
stand-ins (``abstract_params``: a meta-device tensor and its
``NamedSharding`` a leaf, the counterpart of ``jax.ShapeDtypeStruct(...,
sharding=)``) with their per-device bytes (``bytes_per_device``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict (keys sorted at every level, as
    ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_specs(spec_tree: dict, n: int) -> dict:
    """Give every leaf a leading (n,) 'layers' axis."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype, s.init, s.scale),
        spec_tree,
    )


def n_params(tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(tree))


def init_params(tree, generator: torch.Generator | None = None, device=None):
    """Materialize a ParamSpec tree into tensors on ``device`` (the
    generator's device by default). The reference's rules: ``normal`` draws
    N(0, 1) × ``scale`` (1/√fan_in with fan_in = shape[-2], or shape[-1] for
    a vector) in float32, then casts; ``zeros``; ``ones`` × ``scale``.
    Draws come from ``generator`` in leaf order; JAX's PRNG stream is not
    reproduced (``models/convert.py`` carries the reference's weights)."""
    if device is None:
        device = generator.device if generator is not None else torch.device("cpu")

    def one(spec: ParamSpec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.full(spec.shape, spec.scale if spec.scale is not None else 1,
                              dtype=spec.dtype, device=device)
        if generator is None:
            raise ValueError("a normal-initialized leaf needs a torch.Generator")
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        t = torch.empty(spec.shape, dtype=torch.float32, device=device)
        t.normal_(0.0, 1.0, generator=generator).mul_(scale)
        return t.to(spec.dtype)

    def build(t):  # draws in jax.tree leaf order (sorted keys), keeps the key order
        if not isinstance(t, dict):
            return one(t)
        made = {k: build(t[k]) for k in sorted(t)}
        return {k: made[k] for k in t}

    return build(tree)


class SpecModule(nn.Module):
    """A block whose parameters are registered from a spec tree under the
    tree's names: a ``ParamSpec`` leaf becomes an (uninitialized) parameter
    on ``device``, the meta device by default, and a dict a child
    ``SpecModule``. ``m["wq"]`` and ``"bq" in m`` read like the reference's
    parameter dicts, so the layer functions take either."""

    def __init__(self, specs: dict, device="meta"):
        super().__init__()
        for name, s in specs.items():
            if is_spec(s):
                self.register_parameter(
                    name, nn.Parameter(torch.empty(s.shape, dtype=s.dtype, device=device)))
            else:
                self.add_module(name, SpecModule(s, device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def param_shardings(tree, rules) -> dict:
    """The ``NamedSharding`` of every leaf of a ParamSpec tree."""
    return tree_map(lambda s: rules.sharding(s.axes, s.shape), tree)


def param_specs_pspec(tree, rules) -> dict:
    """The ``PartitionSpec`` of every leaf of a ParamSpec tree."""
    return tree_map(lambda s: rules.spec(s.axes, s.shape), tree)


@dataclasses.dataclass(frozen=True, eq=False)
class AbstractTensor:
    """A leaf of the dry-run: a meta-device tensor (shape and dtype, no
    memory) and the ``NamedSharding`` the mesh would hold it under."""

    tensor: torch.Tensor
    sharding: Any = None

    @property
    def shape(self) -> tuple:
        return tuple(self.tensor.shape)


def abstract_params(tree, rules, dtype_override=None) -> dict:
    """An ``AbstractTensor`` for every leaf of a ParamSpec tree, sharded by
    ``rules`` (a ``MeshRules``). Allocates nothing."""

    def one(spec: ParamSpec) -> AbstractTensor:
        t = torch.empty(spec.shape, dtype=dtype_override or spec.dtype, device="meta")
        return AbstractTensor(t, rules.sharding(spec.axes, spec.shape))

    return tree_map(one, tree)


def bytes_per_device(abstract_tree, mesh) -> int:
    """Exact per-device bytes of a sharded ``AbstractTensor`` tree: a leaf's
    bytes over the product of the mesh extents its spec splits it on."""
    def leaves(t):
        if isinstance(t, (tuple, list)):
            return [leaf for x in t for leaf in leaves(x)]
        return [leaf for leaf in tree_leaves(t) if leaf is not None]

    total = 0
    for leaf in leaves(abstract_tree):
        n = math.prod(leaf.shape)
        shards = 1
        spec = leaf.sharding.spec if leaf.sharding is not None else ()
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= mesh.shape[ax]
        total += n * leaf.tensor.element_size() // shards
    return total
