"""Layout-free training checkpoints: manifest + one .npy an array, atomic,
async — the JAX package's ``checkpoint/ckpt.py`` and its on-disk format
(``step_%09d/``, ``manifest.json``, ``a%06d.npy``), so either package's
manager reads the other's directories.

  - *Atomicity*: a save fills a tmp sibling and renames it into place only
    after every array and the manifest are fsync'd (``atomic.py``).
  - *Elasticity*: arrays are stored whole on the host (a save gathers a
    ``Sharded`` moment's blocks), so ``restore`` puts them on whatever
    ``device`` it is given, or splits them over any mesh by the
    ``shardings`` it is given, as the reference's ``restore(shardings=)``
    re-shards onto another mesh.
  - *Async*: ``save(block=False)`` copies the state to the host, then writes
    on a thread, so the step loop waits only for the device-to-host copy.
  - *Retention*: the ``keep`` most recent checkpoints stay (all if ``keep``
    ≤ 0).

Tensors are written as numpy arrays of their dtype (bfloat16 widened to
float32: numpy has none); ``restore`` returns tensors.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np
import torch

from repro_torch.checkpoint.atomic import (
    fsync_write,
    is_tmp,
    prune_oldest,
    reap_stale_tmp,
    save_array,
    write_dir_atomic,
)
from repro_torch.sharding.rules import Sharded


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _host(x) -> np.ndarray:
    """A host copy: the caller may go on writing ``x`` in place (the train
    step does) while a thread writes the copy."""
    if isinstance(x, Sharded):
        x = x.full("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ io
    def _write(self, step: int, host_tree: dict[str, np.ndarray], extra: dict):
        final = os.path.join(self.dir, f"step_{step:09d}")
        manifest = {"step": step, "arrays": {}, "extra": extra}

        def writer(tmp):
            for i, (name, arr) in enumerate(host_tree.items()):
                fname = f"a{i:06d}.npy"
                save_array(os.path.join(tmp, fname), arr)
                manifest["arrays"][name] = {"file": fname, "dtype": str(arr.dtype), "shape": list(arr.shape)}
            fsync_write(os.path.join(tmp, "manifest.json"), json.dumps(manifest).encode())

        write_dir_atomic(final, writer)
        self._gc()

    def _gc(self):
        reap_stale_tmp(self.dir)  # residue of writers killed mid-save
        if self.keep <= 0:  # retain all
            return
        prune_oldest([os.path.join(self.dir, f"step_{s:09d}") for s in self.list_steps()], keep=self.keep)

    # ----------------------------------------------------------------- api
    def list_steps(self) -> list[int]:
        return sorted(int(d[5:]) for d in os.listdir(self.dir) if d.startswith("step_") and not is_tmp(d))

    def save(self, step: int, state, extra: dict | None = None, block: bool = True):
        host = {k: _host(v) for k, v in _flatten(state).items()}
        if block:
            self._write(step, host, extra or {})
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def save_async(self, step: int, state, extra: dict | None = None):
        self.save(step, state, extra, block=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> int | None:
        """The newest step saved, counting a save still being written (it
        waits for it: a restart must not miss the checkpoint just taken)."""
        self.wait()
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, device=None, shardings=None):
        """-> (state, extra) of ``step`` (the latest by default), tensors on
        ``device`` (the CPU by default); (None, None) when there is none.
        ``shardings``: a tree matching (part of) the state whose
        ``NamedSharding`` leaves split those arrays over their mesh (a
        ``Sharded`` each) instead."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        flat = {}
        for name, meta in manifest["arrays"].items():
            t = torch.from_numpy(np.load(os.path.join(path, meta["file"])))
            sh = flat_sh.get(name)
            flat[name] = sh.split(t) if sh is not None else t.to(device) if device is not None else t
        return _unflatten(flat), manifest["extra"]
