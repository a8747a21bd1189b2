"""SnapshotStore: content-addressed on-disk PreparedDB snapshots.

The cross-process half of the engine's PreparedDB cache (ROADMAP
follow-up): a cold process pointed at a populated store warm-starts with
zero prep stages on a known database. Entries are keyed exactly like the
in-memory LRU — (algorithm, database fingerprint, n_items, device config)
plus the data-shard count the prep was laid out for — hashed to one
directory name, so any process that computes the same key finds the same
snapshot.

Layout per entry (written atomically, ``checkpoint/atomic`` style):

    <dir>/<key>/manifest.json   scalar meta + per-array file/dtype/shape/sha256
    <dir>/<key>/<name>.npy      one file per payload array

``get`` verifies every array against its manifest digest and shape; a
corrupted or partial entry (crash mid-write never produces one, but disk
rot or truncation can) is deleted and reported as a miss — the caller
re-prepares and the next ``put`` heals the store. GC is byte-budgeted,
evicting by mtime (``get`` touches entries, so eviction is LRU-ish).
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading

import numpy as np

from repro_torch.checkpoint.atomic import (
    dir_bytes, fsync_write, is_tmp, prune_oldest, reap_stale_tmp, save_array, write_dir_atomic,
)
from repro_torch.fault import failures

MANIFEST = "manifest.json"
STORE_SCHEMA = 1


def _canonical(obj) -> str:
    """Deterministic JSON for key hashing (tuples/dataclasses normalized)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    return json.dumps(obj, sort_keys=True, default=lambda o: list(o) if isinstance(o, (tuple, set)) else str(o))


class SnapshotStore:
    """Byte-budgeted, content-addressed PreparedDB snapshot directory.

    Thread-safe: the service's prep thread and worker pool may hit one
    store concurrently. All counters are under ``info()``.
    """

    def __init__(self, directory: str, *, byte_budget: int = 4 << 30):
        self.dir = directory
        self.byte_budget = int(byte_budget)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.stats = {
            "hits": 0, "misses": 0, "stores": 0,
            # puts skipped because the resident entry already serves at
            # least as loose a floor (content-addressed: nothing to gain)
            "store_skips": 0,
            "corrupt": 0,  # entries rejected (and deleted) by validation
            "evictions": 0,  # entries removed by the byte-budget GC
        }

    # ------------------------------------------------------------------ keys
    @staticmethod
    def key_for(algorithm: str, fingerprint, n_items: int, device_config, n_shards: int) -> str:
        """Stable hex key: same database + device config + shard count in
        any process maps to the same entry."""
        blob = _canonical(
            {
                "algorithm": algorithm,
                "fingerprint": fingerprint,
                "n_items": int(n_items),
                "device_config": device_config,
                "n_shards": int(n_shards),
            }
        )
        return hashlib.sha256(blob.encode()).hexdigest()

    def path_of(self, key: str) -> str:
        return os.path.join(self.dir, key)

    # ------------------------------------------------------------------- api
    def entries(self) -> list[str]:
        """Entry directories, oldest-mtime first (the GC eviction order)."""
        out = []
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if is_tmp(name) or not os.path.isdir(path):
                continue
            try:
                out.append((os.path.getmtime(path), path))
            except OSError:
                pass
        return [p for _, p in sorted(out)]

    def bytes_in_use(self) -> int:
        return sum(dir_bytes(p) for p in self.entries())

    def info(self) -> dict:
        return {
            **self.stats,
            "entries": len(self.entries()),
            "bytes_in_use": self.bytes_in_use(),
            "byte_budget": self.byte_budget,
        }

    def get(self, key: str) -> dict | None:
        """The validated payload for ``key``, or None (miss / corrupt).

        Every array is re-hashed against the manifest digest before it is
        trusted; a *content* mismatch deletes the entry so a re-prepare +
        re-put replaces it instead of tripping on it forever. Transient
        I/O failures (fd exhaustion, another process's GC racing the
        read) are plain misses — they prove nothing about the bytes on
        disk, so the entry survives to be read again.

        The store lock is held across the whole read (and ``put`` holds
        it across the whole write): within one process, a reader can
        never interleave with a same-key replacement and observe arrays
        from two different snapshot generations that each pass their own
        digest. Snapshot payloads are small next to the mining itself —
        consistency is worth the serialization. Across processes the lock
        cannot help, so a content failure is re-read once before the
        entry is condemned: a reader racing another process's atomic
        replace sees a mixed/missing generation on the first read and the
        complete new entry on the second."""
        failures.fire("snapshot.read")  # chaos: corruption / I/O mid-read
        with self._lock:
            path = self.path_of(key)
            for attempt in (0, 1):
                if not os.path.isdir(path):
                    self.stats["misses"] += 1  # absent (or a racing GC won)
                    return None
                try:
                    payload = self._read_validated(path)
                except OSError as e:
                    if isinstance(e, FileNotFoundError):
                        if attempt == 0:
                            continue  # mid-replace by another process: re-read
                        self._reject(path)  # member still missing: partial
                    else:
                        self.stats["misses"] += 1  # transient I/O: keep it
                    return None
                except Exception:
                    if attempt == 0:
                        continue  # possibly a mid-replace read: re-read
                    self._reject(path)  # it really is broken on disk
                    return None
                try:
                    os.utime(path)  # recency for the byte-budget GC
                except OSError:
                    pass  # e.g. a cross-process GC won; the payload is valid
                self.stats["hits"] += 1
                return payload

    def _read_validated(self, path: str) -> dict:
        """One full read of an entry, digests and shapes checked; raises on
        any inconsistency (``ValueError``) or I/O failure (``OSError``)."""
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("schema") != STORE_SCHEMA:
            raise ValueError(f"store schema {manifest.get('schema')!r}")
        payload = dict(manifest["meta"])
        for name, spec in manifest["arrays"].items():
            with open(os.path.join(path, spec["file"]), "rb") as f:
                raw = f.read()
            if hashlib.sha256(raw).hexdigest() != spec["sha256"]:
                raise ValueError(f"digest mismatch for array {name!r}")
            arr = np.load(io.BytesIO(raw))
            if list(arr.shape) != spec["shape"] or str(arr.dtype) != spec["dtype"]:
                raise ValueError(f"shape/dtype mismatch for array {name!r}")
            payload[name] = arr
        return payload

    def _reject(self, path: str) -> None:
        import shutil

        shutil.rmtree(path, ignore_errors=True)
        self.stats["corrupt"] += 1
        self.stats["misses"] += 1

    def peek_meta(self, key: str) -> dict | None:
        """Scalar meta of an entry without loading arrays (put's policy
        check); None when absent or unreadable."""
        try:
            with open(os.path.join(self.path_of(key), MANIFEST)) as f:
                manifest = json.load(f)
            if manifest.get("schema") != STORE_SCHEMA:
                return None
            return dict(manifest["meta"])
        except Exception:
            return None

    @staticmethod
    def _improves(new_meta: dict, old_meta: dict) -> bool:
        """Whether a payload is worth replacing the resident entry: wave
        state (full prep) beats F1-only, then a looser floor beats a
        tighter one — mirroring the engine LRU's replacement policy."""
        if bool(new_meta.get("f1_only")) != bool(old_meta.get("f1_only")):
            return bool(old_meta.get("f1_only"))
        return int(new_meta.get("min_count_floor", 0)) < int(old_meta.get("min_count_floor", 0))

    def put(self, key: str, payload: dict) -> str | None:
        """Persist a ``PreparedDB.to_host()`` payload under ``key``.

        Atomic (tmp + fsync + rename); skipped when the resident entry is
        already at least as useful. Returns the entry path, or None when
        the write was skipped."""
        arrays = {k: v for k, v in payload.items() if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in payload.items() if not isinstance(v, np.ndarray)}
        with self._lock:
            old = self.peek_meta(key)
            if old is not None and not self._improves(meta, old):
                self.stats["store_skips"] += 1
                return None
            path = self.path_of(key)

            def writer(tmp):
                manifest = {"schema": STORE_SCHEMA, "meta": meta, "arrays": {}}
                for name, arr in arrays.items():
                    fname = f"{name}.npy"
                    save_array(os.path.join(tmp, fname), arr)
                    with open(os.path.join(tmp, fname), "rb") as f:
                        digest = hashlib.sha256(f.read()).hexdigest()
                    manifest["arrays"][name] = {
                        "file": fname,
                        "dtype": str(arr.dtype),
                        "shape": list(arr.shape),
                        "sha256": digest,
                    }
                fsync_write(os.path.join(tmp, MANIFEST), json.dumps(manifest, sort_keys=True).encode())

            write_dir_atomic(path, writer)
            self.stats["stores"] += 1
            self._gc_locked()
        return path

    def gc(self) -> int:
        """Evict oldest entries until the byte budget holds; returns the
        number evicted."""
        with self._lock:
            return self._gc_locked()

    def _gc_locked(self) -> int:
        # the full-store walk (mtimes + per-entry sizes) is the only byte
        # accounting that stays correct when other processes also write
        # this directory; it runs once per spill, which is once per new
        # PreparedDB build — rare next to the mining it amortizes over
        reap_stale_tmp(self.dir)  # crashed writers' residue
        removed = prune_oldest(self.entries(), byte_budget=self.byte_budget)
        self.stats["evictions"] += len(removed)
        return len(removed)
