"""Port vs reference: the torch PPC-tree build against ``build_ppc_jnp``,
the host ``build_ppc`` and the pointer oracle ``_build_ppc_pointer``; the
torch N-list intersection against ``intersect_jnp``/``intersect_np``; the
device N-list pack against the host ``pack_nlists``. Tolerance 0."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import nlist as jnl
from repro.core.ppc import _build_ppc_pointer, build_ppc, build_ppc_jnp
from repro.data.synth import load, random_db
from repro_torch.core import nlist as tnl
from repro_torch.core import ppc as tppc
from repro_torch.core.hprepost import pack_nlists_torch


def _ranked(rows, n_items, min_count):
    fl = jenc.build_flist(jenc.item_support(rows, n_items), min_count)
    return jenc.rank_encode(rows, fl), fl.k


def _cases():
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}", random_db(rng, 60, 10, 6), 10, 2))
    rows, n = load("mushroom", scale=0.03)  # L=23 > 8: the reference packs key pairs
    out.append(("mushroom", rows, n, 20))
    rows, n = load("kosarak", scale=0.0005)
    out.append(("kosarak", rows, n, 3))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_ppc_torch_vs_references(case, weighted):
    _, rows, n_items, mc = case
    ranked, K = _ranked(rows, n_items, mc)
    R, L = ranked.shape
    rng = np.random.default_rng(R)
    w = (rng.integers(1, 5, R) if weighted else np.ones(R)).astype(np.int32)

    item, count, pre, post = (x.numpy() for x in tppc.build_ppc_torch(
        torch.from_numpy(ranked), torch.from_numpy(w), K))
    ji, jc, jpre, jpost, jvalid = (np.asarray(x) for x in build_ppc_jnp(
        jnp.asarray(ranked), jnp.asarray(w), R * L, n_items=K))
    np.testing.assert_array_equal(item, ji[jvalid])
    np.testing.assert_array_equal(count, jc[jvalid])
    np.testing.assert_array_equal(pre, jpre[jvalid])
    np.testing.assert_array_equal(post, jpost[jvalid])

    host = build_ppc(ranked, w)
    ptr = _build_ppc_pointer(ranked, w)
    for t in (host, ptr):
        np.testing.assert_array_equal(item, t.item)
        np.testing.assert_array_equal(count, t.count)
        np.testing.assert_array_equal(pre, t.pre)
        np.testing.assert_array_equal(post, t.post)


def test_host_ppc_copies_match(paper_db):
    rows, n_items = paper_db
    ranked, _ = _ranked(rows, n_items, 2)
    urows, w = jenc.dedup_rows(ranked)
    for a, b in ((tppc.build_ppc(urows, w), build_ppc(urows, w)),
                 (tppc._build_ppc_pointer(urows, w), _build_ppc_pointer(urows, w))):
        for f in ("item", "count", "pre", "post", "depth"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pack_nlists_torch_vs_host(case):
    _, rows, n_items, mc = case
    ranked, K = _ranked(rows, n_items, mc)
    w = np.ones(len(ranked), np.int32)
    item, count, pre, post = tppc.build_ppc_torch(torch.from_numpy(ranked), torch.from_numpy(w), K)
    nls = build_ppc(ranked, w).nlists(K)
    W = max(8, max(len(x) for x in nls))
    got = pack_nlists_torch(item, count, pre, post, K, W)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, K, W, 3)
    np.testing.assert_array_equal(got[0].numpy(), jnl.pack_nlists(nls, width=W))


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_intersect_torch_vs_jnp_and_np(case):
    _, rows, n_items, mc = case
    ranked, K = _ranked(rows, n_items, mc)
    urows, w = jenc.dedup_rows(ranked)
    nls = build_ppc(urows, w).nlists(K)
    packed = jnl.pack_nlists(nls).astype(np.int32)
    for q in range(K):
        for p in range(q + 1, K):
            a, y = packed[q], packed[p]
            got = tnl.intersect_torch(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                                        (a[:, 0], a[:, 1], y[:, 0], y[:, 1], y[:, 2])))
            want = jnl.intersect_jnp(*(jnp.asarray(x) for x in
                                       (a[:, 0], a[:, 1], y[:, 0], y[:, 1], y[:, 2])))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            host = jnl.intersect_np(nls[q][:, 0], nls[q][:, 1], nls[p][:, 0], nls[p][:, 1], nls[p][:, 2])
            np.testing.assert_array_equal(got.numpy()[: len(host)], host)
            np.testing.assert_array_equal(
                tnl.intersect_np(nls[q][:, 0], nls[q][:, 1], nls[p][:, 0], nls[p][:, 1], nls[p][:, 2]), host)
