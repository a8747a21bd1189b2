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
widened to float32 (numpy has no bfloat16).
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
