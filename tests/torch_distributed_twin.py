"""Shared helpers of the port's distributed tests
(``tests/test_torch_distributed*.py``): the specs for both packages, the
seeded batches, exact result comparison, and the wire check that every
frame the coordinator sends or receives holds NumPy arrays and scalars
only. Not a test module (pytest collects ``test_*.py`` only)."""
import numpy as np
import pytest

import repro.mining as jm
import repro_torch.mining as tm
from repro.data.synth import random_db

# nlist_width: one static W for every segment (no batch here holds more than
# 32 rows), and batches padded to 32 rows: the reference compiles few shapes
SPEC = dict(algorithm="hprepost", max_k=4, candidate_unit=8, min_sup=0.3, nlist_width=128)
ROW_PAD = 32
RESULT_FIELDS = ("algorithm", "total_count", "n_explicit", "min_count", "n_rows",
                 "prep_shared")
PLANNING = ("planned_candidates", "host_pruned_parent", "host_pruned_subset",
            "host_pruned_seed")


def spec(pkg, **kw):
    """The spec for one package: the reference on its jnp kernels, the port
    on the default registry entry (the plain versions on the CPU)."""
    over = dict(SPEC, **kw)
    if pkg is jm:
        over["backend"] = "jnp"
    return pkg.MineSpec(**over)


def stream_spec(pkg, **kw):
    if pkg is jm:
        from repro.mining.stream import StreamSpec
    else:
        from repro_torch.mining.stream import StreamSpec
    return StreamSpec(**dict(dict(row_pad=ROW_PAD), **kw))


def batches(seed=0, sizes=(30, 14, 22), n_items=10, max_len=6):
    rng = np.random.default_rng(seed)
    return [random_db(rng, n, n_items, max_len) for n in sizes], n_items


def single_process(engine, name, bs, n_items, pkg=jm, stream_kw=None, **kw):
    """``bs`` appended to a fresh stream ``name`` of ``engine`` (one engine
    per module, so the reference reuses its compiled programs), then one
    query. -> MineResult."""
    for b in bs:
        engine.append(b, n_items, stream=name, spec=spec(pkg),
                      stream_spec=stream_spec(pkg, **(stream_kw or {})))
    return engine.submit_stream(spec(pkg, **kw), stream=name)


def assert_same_result(got, want, *, peak=False, service=False):
    """The itemsets, the result fields and the planning counters, exactly;
    with ``peak`` also ``peak_bytes`` and with ``service`` the distributed
    ``service_stats`` (both only against a reference *distributed* answer:
    the single-process stream accounts its peak differently)."""
    assert got.itemsets == want.itemsets
    for f in RESULT_FIELDS + (("peak_bytes",) if peak else ()):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.flist_items, want.flist_items)
    for k in PLANNING:
        assert got.stage_times_s.get(k) == want.stage_times_s.get(k), k
    if service:
        for k in ("prep_source", "stream_segments", "stream_digest", "workers"):
            assert got.service_stats.get(k) == want.service_stats.get(k), k


_SCALARS = (bool, int, float, str, bytes, type(None), np.generic)


def frame_violations(obj, path="frame") -> list[str]:
    """Where ``obj`` holds anything but NumPy arrays (of a non-object
    dtype), NumPy scalars and Python scalars, inside dicts, lists and
    tuples."""
    if isinstance(obj, np.ndarray):
        return [f"{path}: object array"] if obj.dtype == object else []
    if isinstance(obj, _SCALARS):
        return []
    if isinstance(obj, dict):
        return [v for k, x in obj.items() for v in frame_violations(x, f"{path}[{k!r}]")]
    if isinstance(obj, (list, tuple)):
        return [v for i, x in enumerate(obj) for v in frame_violations(x, f"{path}[{i}]")]
    return [f"{path}: {type(obj).__name__}"]


@pytest.fixture(scope="module")
def wire():
    """Every frame the port's coordinator sends or receives in this module,
    checked as it passes: ``{"ops": {op: n}, "replies": n, "bad": [...]}``.
    Only the coordinator's side is wrapped (workers are other processes)."""
    from repro_torch.mining.distributed.transport import Channel

    seen = {"ops": {}, "replies": 0, "bad": []}
    send, recv = Channel.send, Channel.recv

    def checked_send(self, obj):
        seen["ops"][obj.get("op")] = seen["ops"].get(obj.get("op"), 0) + 1
        seen["bad"] += frame_violations(obj, f"request {obj.get('op')}")
        return send(self, obj)

    def checked_recv(self, timeout=None):
        obj = recv(self, timeout)
        seen["replies"] += 1
        seen["bad"] += frame_violations(obj, "reply")
        return obj

    mp = pytest.MonkeyPatch()
    mp.setattr(Channel, "send", checked_send)
    mp.setattr(Channel, "recv", checked_recv)
    yield seen
    mp.undo()


__all__ = ["jm", "tm", "random_db"]
