"""Atomic directory snapshots: tmp + fsync + rename, plus retention GC.

Shared by the training checkpoint writer (``checkpoint/ckpt.py``) and the
mining PreparedDB snapshot store (``mining/service/store.py``): both write
a directory of arrays + a manifest that must never be observed half-done,
and both prune old entries under a retention policy (count-based for
checkpoints, byte-budgeted for snapshots).

The atomicity contract: ``write_dir_atomic`` fills a unique
``<final>.tmp<pid>-<nonce>`` sibling and renames it into place only after
every file has been fsync'd — a crash mid-write leaves at worst a tmp
directory that listings ignore (filter with ``is_tmp``), and two
processes publishing the same entry concurrently each write their own tmp
instead of clobbering the other's (the rename loser gets an ``OSError``;
for content-addressed entries the winner's copy is equivalent).
"""
from __future__ import annotations

import os
import shutil
import time
import uuid
from typing import Callable, Sequence

import numpy as np

TMP_SUFFIX = ".tmp"


def is_tmp(path: str) -> bool:
    """Whether ``path`` is an in-progress/crashed tmp dir of this module."""
    return TMP_SUFFIX in os.path.basename(path)


def fsync_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` and fsync before returning."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save_array(path: str, arr: np.ndarray) -> None:
    """``np.save`` + fsync (one array per file, the checkpoint layout)."""
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def replace_file_atomic(path: str, data: bytes) -> None:
    """Atomically replace the single file ``path`` with ``data``.

    The file-granularity sibling of ``write_dir_atomic``: write + fsync a
    unique tmp next to the target, then ``os.replace`` (atomic within a
    filesystem) — a reader at ``path`` sees the old bytes or the new
    bytes, never a prefix. Used for manifests that index directory
    entries (e.g. the coordinator's append-log manifest), where a torn
    write would orphan or duplicate entries on replay."""
    tmp = f"{path}{TMP_SUFFIX}{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        fsync_write(tmp, data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_dir_atomic(final: str, writer: Callable[[str], None]) -> None:
    """Populate directory ``final`` atomically.

    ``writer(tmp)`` fills a per-call unique sibling tmp directory; only
    after it returns is any existing ``final`` replaced by a rename. A
    failing writer leaves ``final`` untouched. Losing a concurrent
    publish race for the same ``final`` (another process renamed between
    our rmtree and rename) raises ``OSError`` after cleaning up the tmp.
    """
    tmp = f"{final}{TMP_SUFFIX}{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    try:
        writer(tmp)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def reap_stale_tmp(root: str, ttl_s: float = 3600.0) -> list[str]:
    """Remove tmp directories under ``root`` whose mtime is older than
    ``ttl_s`` — the residue of writers that crashed mid-``write_dir_atomic``
    (unique tmp names mean nothing else ever reclaims them). A live
    writer's tmp keeps a fresh mtime (files are still being created in
    it), so any sane TTL never touches one. Returns the removed paths."""
    removed: list[str] = []
    now = time.time()
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    for name in names:
        path = os.path.join(root, name)
        if not is_tmp(name) or not os.path.isdir(path):
            continue
        try:
            stale = now - os.path.getmtime(path) > ttl_s
        except OSError:
            continue
        if stale:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def dir_bytes(path: str) -> int:
    """Total size of the files under ``path`` (0 if it vanished)."""
    total = 0
    for root, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


def prune_oldest(
    dirs: Sequence[str],
    *,
    keep: int | None = None,
    byte_budget: int | None = None,
) -> list[str]:
    """Remove entries from the front of ``dirs`` until the retention policy
    holds; returns the removed paths.

    The caller passes ``dirs`` least-valuable-first (checkpoints: ascending
    step; snapshots: ascending mtime). ``keep`` bounds the entry count,
    ``byte_budget`` the total on-disk size — either alone or both together.
    Like the engine's LRU, a byte budget may remove every entry when even
    the newest alone exceeds it.
    """
    removed: list[str] = []
    sizes = [dir_bytes(d) for d in dirs] if byte_budget is not None else None
    total = sum(sizes) if sizes else 0
    for i, d in enumerate(dirs):
        over_keep = keep is not None and len(dirs) - len(removed) > keep
        over_bytes = byte_budget is not None and total > byte_budget
        if not (over_keep or over_bytes):
            break
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
        if sizes is not None:
            total -= sizes[i]
    return removed
