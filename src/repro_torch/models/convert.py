"""Weights and caches across the two packages' layouts.

The reference keeps a model's parameters as one tree with stacked leaves
(``params["layers"]["attn"]["wq"]`` is (L, d, H, hd)); the port's modules
hold one ``SpecModule`` a layer (``layers.3.attn.wq`` is (d, H, hd)). Every
``nn.ModuleList`` on a path adds one leading index to the reference leaf:
(L, ...) for DecoderLM and encdec, (g, m, ...) for the xLSTM and Zamba
groups' members and (g, ...) for the groups' own blocks. Caches have the
same layout in both packages, so they convert leaf for leaf.

Trees go in as numpy arrays or tensors: a tensor leaf is sliced (views, no
copies), a numpy leaf copied. Trees come out as numpy arrays, bfloat16
widened to float32 (numpy has no bfloat16). Train states
(``training/step.py``) convert leaf for leaf too, their moments and
residuals laid out as the parameters.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.registry import build_model


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _paths(module: nn.Module, key: tuple = (), path: tuple = (), idx: tuple = ()):
    """(state key, reference tree path, leading index) for every parameter."""
    for name, _ in module.named_parameters(recurse=False):
        yield ".".join(key + (name,)), path + (name,), idx
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            for i, c in enumerate(child):
                yield from _paths(c, key + (name, str(i)), path + (name,), idx + (i,))
        else:
            yield from _paths(child, key + (name,), path + (name,), idx)


def params_from_reference(cfg, tree) -> dict:
    """The reference's parameter tree (numpy arrays or tensors) as the port
    model's ``state_dict`` mapping."""
    out = {}
    for key, path, idx in _paths(build_model(cfg)):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out[key] = _tensor(leaf[idx] if idx else leaf)
    return out


def params_to_reference(cfg, state: dict) -> dict:
    """The port's ``state_dict`` mapping as the reference's parameter tree
    of numpy arrays, stacked leaves and all."""
    leaves = {}
    for key, path, idx in _paths(build_model(cfg)):
        leaves.setdefault(path, {})[idx] = _numpy(state[key])
    tree = {}
    for path, by_idx in leaves.items():
        if () in by_idx:
            arr = by_idx[()]
        else:  # one leading axis a ModuleList on the path
            lead = tuple(np.max(list(by_idx), axis=0) + 1)
            first = next(iter(by_idx.values()))
            arr = np.empty(lead + first.shape, first.dtype)
            for i, a in by_idx.items():
                arr[i] = a
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def shardings_from_reference(cfg, tree) -> dict:
    """A tree of ``NamedSharding``s over the reference's stacked leaves (e.g.
    ``param_shardings`` of a model's ``param_specs()``) as one sharding a
    ``state_dict`` key: a key's tensor is its stacked leaf at a leading
    index, so its spec drops the leaf's leading entries, which must be
    unsplit."""
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec

    out = {}
    for key, path, idx in _paths(build_model(cfg)):
        sh = tree
        for k in path:
            sh = sh[k]
        lead, rest = sh.spec[:len(idx)], sh.spec[len(idx):]
        if any(e is not None for e in lead):
            raise ValueError(f"{key}: a per-layer tensor cannot hold a split of its stacked axes {sh.spec}")
        out[key] = NamedSharding(sh.mesh, PartitionSpec(*rest))
    return out


def cache_from_reference(tree) -> dict:
    """A reference cache tree (numpy arrays) as the port's cache (tensors)."""
    if isinstance(tree, dict):
        return {k: cache_from_reference(v) for k, v in tree.items()}
    return _tensor(tree)


def cache_to_reference(tree) -> dict:
    """The port's cache as a reference cache tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: cache_to_reference(v) for k, v in tree.items()}
    return _numpy(tree)


def train_state_from_reference(cfg, tree) -> dict:
    """The reference's train state (``{"params", "opt": {"m", "v", "step"},
    "rng"}`` and ``"residuals"`` under compression) as the port's. The
    ``rng`` leaf is per package: the reference's PRNG key has no torch
    counterpart, so the port's state gets a CPU ``torch.Generator`` seeded 0
    (as a fresh ``make_train_state`` on the CPU); it drives only the int8
    compression's noise."""
    out = {
        "params": params_from_reference(cfg, tree["params"]),
        "opt": {"m": params_from_reference(cfg, tree["opt"]["m"]),
                "v": params_from_reference(cfg, tree["opt"]["v"]),
                "step": _tensor(tree["opt"]["step"])},
        "rng": torch.Generator().manual_seed(0).get_state(),
    }
    if "residuals" in tree:
        out["residuals"] = params_from_reference(cfg, tree["residuals"])
    return out


def train_state_to_reference(cfg, state: dict) -> dict:
    """The port's train state as the reference's, numpy leaves. The ``rng``
    leaf is per package: the reference's state gets ``PRNGKey(0)`` (the
    uint32 pair (0, 0), as a fresh ``make_train_state`` keeps)."""
    out = {
        "params": params_to_reference(cfg, state["params"]),
        "opt": {"m": params_to_reference(cfg, state["opt"]["m"]),
                "v": params_to_reference(cfg, state["opt"]["v"]),
                "step": _numpy(_tensor(state["opt"]["step"]))},
        "rng": np.zeros(2, np.uint32),
    }
    if "residuals" in state:
        out["residuals"] = params_to_reference(cfg, state["residuals"])
    return out
