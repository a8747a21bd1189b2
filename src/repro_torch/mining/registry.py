"""Miner protocol + registry: ``@register_miner("name")`` is how an
algorithm joins the front-door. The registry maps names to factories
(classes); ``get_miner`` instantiates, ``list_miners`` enumerates — the CLI
and the parity tests iterate it so new algorithms are picked up for free.
"""
from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

from repro_torch.mining.result import MineResult
from repro_torch.mining.spec import MineSpec


@runtime_checkable
class Miner(Protocol):
    """One mining backend behind the unified front-door."""

    name: str
    # True when `itemsets` materializes *every* frequent itemset (pattern
    # post-passes need the full dict; CPE-pruned miners set False).
    exhaustive: bool

    def mine(self, rows, n_items: int, spec: MineSpec) -> MineResult:
        ...


_REGISTRY: dict[str, Callable[..., Miner]] = {}


def register_miner(name: str):
    """Class decorator registering a Miner factory under ``name``."""

    def deco(cls):
        cls.name = name
        if name in _REGISTRY:
            raise ValueError(f"miner {name!r} already registered")
        _REGISTRY[name] = cls
        return cls

    return deco


def get_miner(name: str, **kwargs) -> Miner:
    """Instantiate the miner registered under ``name``."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown miner {name!r}; registered: {list_miners()}") from None
    return factory(**kwargs)


def list_miners() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
