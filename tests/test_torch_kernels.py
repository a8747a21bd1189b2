"""Port kernels' plain versions vs the reference's Pallas kernels
(``interpret=True``) and oracles, at the shapes of tests/test_kernels.py,
and the ops' backend checks. Integer outputs: tolerance 0. The CUDA
kernels themselves are tested in tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import encoding as jenc
from repro.core.nlist import INF, pack_nlists
from repro.core.ppc import build_ppc
from repro.data.synth import random_db
from repro.kernels.cooccur.kernel import cooccur_pallas
from repro.kernels.histogram.kernel import histogram_pallas
from repro.kernels.histogram.ops import item_histogram as jax_item_histogram
from repro.kernels.nlist_intersect.kernel import nlist_intersect_pallas
from repro.kernels.nlist_intersect.ref import nlist_intersect_masked_ref as jax_masked_ref
from repro.kernels.nlist_intersect.ref import nlist_intersect_ref as jax_exact_ref
from repro_torch.kernels.cooccur.kernel import cooccur_cuda
from repro_torch.kernels.cooccur.ops import cooccurrence_matrix
from repro_torch.kernels.cooccur.ref import cooccur_ref
from repro_torch.kernels.histogram.kernel import histogram_cuda
from repro_torch.kernels.histogram.ops import item_histogram
from repro_torch.kernels.nlist_intersect.kernel import (
    nlist_intersect_cuda,
    nlist_intersect_es_cuda,
    nlist_wave_cuda,
)
from repro_torch.kernels.nlist_intersect.ops import nlist_intersect, nlist_wave
from repro_torch.kernels.nlist_intersect.ref import (
    nlist_intersect_fused_ref,
    nlist_intersect_masked_ref,
)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.mark.parametrize("R,L,n_bins", [(1, 1, 1), (7, 3, 5), (64, 8, 33), (300, 12, 129), (513, 5, 1000)])
@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_vs_pallas(R, L, n_bins, weighted):
    rng = np.random.default_rng(R * 1000 + n_bins)
    rows = rng.integers(-1, n_bins, size=(R, L)).astype(np.int32)
    w = (rng.integers(1, 5, size=R) if weighted else np.ones(R)).astype(np.int32)
    want = histogram_pallas(jnp.asarray(rows), jnp.asarray(w), n_bins=n_bins,
                            row_block=64, bin_block=128, interpret=True)
    got = histogram_cuda(T(rows), T(w), n_bins=n_bins)  # CPU tensors: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["negative-weights", "wrapping-weights", "ids-past-n_bins",
                                  "repeated-items", "pad-mid-row"])
def test_histogram_edge_cases_vs_pallas(case):
    """The plain version is held to the Pallas kernel, the function B3
    ports: ids at or past n_bins count nothing there. (The reference's
    ``ops.py`` scatter path for more than 8192 bins clips such ids into the
    last bin instead; the main path never passes one.) Sums are int32 and
    wrap mod 2^32 on both sides."""
    rng = np.random.default_rng(len(case))
    R, L, n_bins = 300, 12, 129
    rows = rng.integers(0, n_bins, size=(R, L)).astype(np.int32)
    rows[:, 9:] = -1
    w = rng.integers(1, 5, size=R).astype(np.int32)
    if case == "negative-weights":
        w = rng.integers(-9, 9, size=R).astype(np.int32)
    elif case == "wrapping-weights":
        w = rng.choice(np.array([2**31 - 1, -2**31, 1 << 30, 3]), size=R).astype(np.int32)
        rows[:, :4] = 7  # bin 7 gets 4 * R such weights
    elif case == "ids-past-n_bins":
        far = rng.random((R, L)) < 0.2
        rows[far] = n_bins + rng.integers(0, 300, size=int(far.sum()))
    elif case == "repeated-items":
        rows[:, 1] = rows[:, 0]
        rows[::2, 2] = rows[::2, 0]
    elif case == "pad-mid-row":
        rows[rng.random((R, L)) < 0.4] = -1
    want = histogram_pallas(jnp.asarray(rows), jnp.asarray(w), n_bins=n_bins,
                            row_block=64, bin_block=128, interpret=True)
    got = histogram_cuda(T(rows), T(w), n_bins=n_bins)  # CPU tensors: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_histogram_large_universe_vs_reference():
    """Above the reference's 8192-bin one-hot cut-off (its scatter path),
    at kosarak's universe; the plain version builds no one-hot tensor."""
    rng = np.random.default_rng(5)
    rows = rng.integers(-1, 41270, size=(2000, 48)).astype(np.int32)
    want = jax_item_histogram(jnp.asarray(rows), n_bins=41270, backend="jnp")
    got = item_histogram(T(rows), n_bins=41270)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("R,L,K", [(1, 1, 1), (9, 4, 7), (100, 6, 40), (257, 10, 130)])
def test_cooccur_vs_pallas(R, L, K):
    rng = np.random.default_rng(R + K)
    rows = rng.integers(-1, K, size=(R, L)).astype(np.int32)
    w = rng.integers(1, 4, size=R).astype(np.int32)
    want = cooccur_pallas(jnp.asarray(rows), jnp.asarray(w), n_items=K,
                          row_block=64, k_block=64, interpret=True)
    got = cooccur_cuda(T(rows), T(w), n_items=K)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [57, 300, 2048, 7117])
def test_cooccur_cpu_takes_the_plain_version(monkeypatch, K):
    """A CPU tensor goes to ``cooccur_ref`` at any K, one band or many: the
    wrapper neither builds nor loads the CUDA library for it."""
    from repro_torch.kernels import _cuda

    def no_library(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_cuda, "library", no_library)
    rng = np.random.default_rng(K)
    rows = rng.integers(-1, K, size=(300, 9)).astype(np.int32)
    w = rng.integers(0, 4, size=300).astype(np.int32)
    before = cooccur_cuda.launches
    got = cooccur_cuda(T(rows), T(w), n_items=K)
    assert cooccur_cuda.launches == before
    assert torch.equal(got, cooccur_ref(T(rows), T(w), n_items=K))


@pytest.mark.parametrize("K", [1, 57, 128])
def test_cooccur_bucket_pass_needs_two_bands(K):
    """K <= 128 runs the single-band kernel, which has no bucketing pass to
    time apart."""
    from repro_torch.kernels.cooccur.kernel import cooccur_bucket_pass

    with pytest.raises(ValueError, match="single-band"):
        cooccur_bucket_pass(T(np.zeros((4, 3), np.int32)), T(np.ones(4, np.int32)), n_items=K)


@pytest.mark.parametrize("R,K,sms,want", [
    (1 << 20, 2048, 132, 132),   # 136 tiles x 8,192 row tiles: one block a SM
    (12_262, 7_104, 132, 132),
    (8_124, 300, 132, 96),       # 3 bands: 6 tiles x 64 row tiles / 4
    (100, 200, 132, 1),          # 3 tiles x 1 row tile
    (1_000, 2048, 8, 8),
    (2_000, 300, 132, 24),       # 6 tiles x 16 row tiles / 4
    (129, 129, 132, 2),          # 3 tiles x 2 row tiles, rounded up
])
def test_cooccur_product_blocks(R, K, sms, want):
    """Persistent product blocks: one a SM, or fewer so that each takes
    4 row tiles on average (each piece ends in an epilogue of atomics)."""
    from repro_torch.kernels.cooccur.kernel import product_blocks

    assert product_blocks(R, K, sms) == want


def test_cooccur_chunking_is_exact(monkeypatch):
    from repro_torch.kernels.cooccur import ref

    rng = np.random.default_rng(3)
    rows = rng.integers(-1, 20, size=(300, 9)).astype(np.int32)
    w = rng.integers(1, 4, size=300).astype(np.int32)
    one = cooccur_ref(T(rows), T(w), n_items=20)
    monkeypatch.setattr(ref, "CHUNK_PAIRS", 200)
    small = cooccur_ref(T(rows), T(w), n_items=20)
    np.testing.assert_array_equal(one.numpy(), small.numpy())


def _nlist_batch(rng, B, La, Ly, with_a_cnt=False):
    """Batches of tree-valid PP-codes (tests/test_kernels.py's sampler),
    plus A's own node counts when asked."""
    a_pre = np.full((B, La), INF, np.int32)
    a_post = np.full((B, La), -1, np.int32)
    a_cnt = np.zeros((B, La), np.int32)
    y_pre = np.full((B, Ly), INF, np.int32)
    y_post = np.full((B, Ly), -1, np.int32)
    y_cnt = np.zeros((B, Ly), np.int32)
    for b in range(B):
        n_items = int(rng.integers(2, 16))
        rows = random_db(rng, int(rng.integers(5, 120)), n_items, min(8, n_items))
        fl = jenc.build_flist(jenc.item_support(rows, n_items), 1)
        if fl.k < 2:
            continue
        urows, w = jenc.dedup_rows(jenc.rank_encode(rows, fl))
        if not len(urows):
            continue
        nls = build_ppc(urows, w).nlists(fl.k)
        qa, qy = sorted(rng.choice(fl.k, size=2, replace=False))
        A, Y = nls[qa][:La], nls[qy][:Ly]
        a_pre[b, : len(A)], a_post[b, : len(A)], a_cnt[b, : len(A)] = A[:, 0], A[:, 1], A[:, 2]
        y_pre[b, : len(Y)], y_post[b, : len(Y)] = Y[:, 0], Y[:, 1]
        y_cnt[b, : len(Y)] = Y[:, 2]
    if with_a_cnt:
        return a_pre, a_post, a_cnt, y_pre, y_post, y_cnt
    return a_pre, a_post, y_pre, y_post, y_cnt


@pytest.mark.parametrize("B,La,Ly", [(1, 1, 1), (3, 8, 5), (5, 40, 70), (2, 130, 257)])
def test_nlist_intersect_vs_pallas(B, La, Ly):
    rng = np.random.default_rng(B * La + Ly)
    arrs = _nlist_batch(rng, B, La, Ly)
    want, wsup = nlist_intersect_pallas(*map(jnp.asarray, arrs), la_block=64, ly_block=64,
                                        batch_block=3, interpret=True)
    got, sup = nlist_intersect_cuda(*map(T, arrs))
    assert got.dtype == sup.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(wsup))


def test_nlist_intersect_zero_count_and_pad_slots():
    rng = np.random.default_rng(7)
    a_pre, a_post, y_pre, y_post, y_cnt = (x.copy() for x in _nlist_batch(rng, 5, 24, 16))
    y_cnt[1] = 0
    a_pre[2, :], a_post[2, :] = INF, -1
    y_pre[3, :], y_post[3, :], y_cnt[3, :] = INF, -1, 0
    args = (a_pre, a_post, y_pre, y_post, y_cnt)
    want, wsup = nlist_intersect_pallas(*map(jnp.asarray, args), la_block=8, ly_block=8,
                                        batch_block=2, interpret=True)
    got, sup = nlist_intersect_cuda(*map(T, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(wsup))
    for b in (1, 2, 3):
        assert not got[b].any() and sup[b] == 0


def _soiled(rng, pre, x, low, high):
    """A copy of ``x`` holding values drawn from [low, high) on the padding
    slots (``pre`` INT32_MAX); the valid slots keep theirs."""
    pad = pre == INF
    x = x.copy()
    x[pad] = rng.integers(low, high, size=int(pad.sum()))
    return x


@pytest.mark.parametrize("soiled", ["y", "a", "both"])
def test_padding_contract_plain_b1_b2_wave(soiled):
    """The padding contract: a slot whose pre is INT32_MAX is padding and,
    whatever post and count it carries, merges into no A slot and adds
    nothing to B2's liveness mass. The plain B1, B2 and wave entry (two
    levels) on inputs with soiled padding (Y's, A's or both) equal the same
    calls on the clean inputs (post -1, count 0 there), tolerance 0."""
    rng = np.random.default_rng(len(soiled))
    clean = _nlist_batch(rng, 8, 40, 48, with_a_cnt=True)
    a_pre, a_post, a_cnt, y_pre, y_post, y_cnt = clean
    if soiled != "a":
        y_post, y_cnt = _soiled(rng, y_pre, y_post, -5, 64), _soiled(rng, y_pre, y_cnt, 1, 10)
    if soiled != "y":
        a_post, a_cnt = _soiled(rng, a_pre, a_post, -5, 64), _soiled(rng, a_pre, a_cnt, 1, 10)
    dirty = (a_pre, a_post, a_cnt, y_pre, y_post, y_cnt)

    def eq(got, want):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def b1(a_pre, a_post, a_cnt, *y):
        return nlist_intersect_cuda(*map(T, (a_pre, a_post, *y)))

    eq(b1(*dirty), b1(*clean))
    for stop in (0, 5, 40, 1 << 20):
        for lab in (1, 8, 512):
            eq(nlist_intersect_es_cuda(*map(T, dirty), stop, la_block=lab),
               nlist_intersect_es_cuda(*map(T, clean), stop, la_block=lab))

    planes, l2, n2, l3, n3 = _wave_inputs(len(soiled), width=24, pad=3)
    assert (planes[0] == INF).any()
    dirty_planes = planes.copy()
    if soiled != "y":  # the extension items' rows: A's posts and counts
        dirty_planes[1] = _soiled(rng, planes[0], planes[1], -5, 64)
        dirty_planes[2] = _soiled(rng, planes[0], planes[2], 1, 10)
    prev, prev_pre = planes[2], planes[0]  # level 2 reads the singleton states
    for idx, n_live in ((l2, n2), (l3, n3)):
        dirty_prev = _soiled(rng, prev_pre, prev, 1, 10) if soiled != "a" else prev
        for kw in ({}, *(dict(early_stop=True, min_count=s, la_block=lab)
                         for s in (0, 4, 30) for lab in (1, 8, 512))):
            eq(nlist_wave_cuda(T(dirty_planes), T(dirty_prev), T(idx), n_live, **kw),
               nlist_wave_cuda(T(planes), T(prev), T(idx), n_live, **kw))
        # a state row lies on its extension item's code slots
        prev, prev_pre = nlist_wave_cuda(T(planes), T(prev), T(idx), n_live)[0].numpy(), planes[0][idx[2]]


def test_reference_padding_answers_out_of_contract():
    """Pinned on purpose: on counts at padding slots the reference's two
    wave backends disagree with each other and with the port. A holds 3
    valid codes, Y 2 (counts 3 and 4) then 6 padding slots of count 7,
    La = Ly = 8. The Pallas kernel's dense subsume mask reads a padding
    code as a descendant of every valid A code (each gets 6 * 7 = 42);
    ``intersect_jnp``'s searchsorted gives all 42 to the last valid A code;
    the port merges no padding (its contract)."""
    from repro.core.nlist import intersect_jnp

    a_pre = np.array([[1, 5, 9] + [INF] * 5], np.int32)
    a_post = np.array([[4, 8, 12] + [-1] * 5], np.int32)
    y_pre = np.array([[2, 6] + [INF] * 6], np.int32)
    y_post = np.array([[3, 7] + [-1] * 6], np.int32)
    y_cnt = np.array([[3, 4] + [7] * 6], np.int32)
    args = (a_pre, a_post, y_pre, y_post, y_cnt)
    pallas, psup = nlist_intersect_pallas(*map(jnp.asarray, args), la_block=8, ly_block=8,
                                          batch_block=1, interpret=True)
    np.testing.assert_array_equal(np.asarray(pallas)[0], [45, 46, 42, 0, 0, 0, 0, 0])
    assert int(np.asarray(psup)[0]) == 133
    dense = np.asarray(intersect_jnp(*(jnp.asarray(x[0]) for x in args)))
    np.testing.assert_array_equal(dense, [3, 4, 42, 0, 0, 0, 0, 0])
    assert int(dense.sum()) == 49
    got, sup = nlist_intersect_cuda(*map(T, args))
    np.testing.assert_array_equal(got.numpy()[0], [3, 4, 0, 0, 0, 0, 0, 0])
    assert int(sup[0]) == 7


def test_nlist_intersect_real_tree(paper_db):
    rows, n_items = paper_db
    fl = jenc.build_flist(jenc.item_support(rows, n_items), 3)
    urows, w = jenc.dedup_rows(jenc.rank_encode(rows, fl))
    packed = pack_nlists(build_ppc(urows, w).nlists(fl.k), width=8).astype(np.int32)
    pairs = [(q, p) for p in range(fl.k) for q in range(p)]
    a = packed[[q for q, _ in pairs]]
    y = packed[[p for _, p in pairs]]
    args = (a[:, :, 0], a[:, :, 1], y[:, :, 0], y[:, :, 1], y[:, :, 2])
    want, wsup = nlist_intersect_pallas(*map(jnp.asarray, args), la_block=8, ly_block=8,
                                        batch_block=4, interpret=True)
    got, sup = nlist_intersect_cuda(*map(T, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(wsup))
    assert int(sup[pairs.index((0, 2))]) == 3


@pytest.mark.parametrize("la_block", [4, 16, 512])
@pytest.mark.parametrize("stop", [0, 1, 5, 40, 1 << 20])
def test_masked_plain_vs_reference(la_block, stop):
    rng = np.random.default_rng(la_block + stop)
    arrs = _nlist_batch(rng, 6, 48, 64, with_a_cnt=True)
    want, wsup = jax_masked_ref(*map(jnp.asarray, arrs), stop, la_block=la_block)
    got, sup = nlist_intersect_es_cuda(*map(T, arrs), stop, la_block=la_block)
    assert got.dtype == sup.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(wsup))
    if stop <= 0:
        exact, esup = nlist_intersect_fused_ref(*map(T, (arrs[0], arrs[1], *arrs[3:])))
        np.testing.assert_array_equal(got.numpy(), exact.numpy())
        np.testing.assert_array_equal(sup.numpy(), esup.numpy())


def test_ops_check_backend_against_device():
    rows = torch.zeros((2, 2), dtype=torch.int32)
    np.testing.assert_array_equal(item_histogram(rows, n_bins=3, backend="torch").numpy(), [4, 0, 0])
    for op in (lambda b: item_histogram(rows, n_bins=3, backend=b),
               lambda b: cooccurrence_matrix(rows, n_items=3, backend=b),
               lambda b: nlist_intersect(rows, rows, rows, rows, rows, backend=b)):
        with pytest.raises(ValueError, match="not available"):
            op("cuda")
        with pytest.raises(ValueError, match="registered backends"):
            op("pallas")


def test_ops_early_stop_dispatch():
    rng = np.random.default_rng(11)
    a_pre, a_post, a_cnt, y_pre, y_post, y_cnt = map(T, _nlist_batch(rng, 4, 32, 32, with_a_cnt=True))
    exact = nlist_intersect(a_pre, a_post, y_pre, y_post, y_cnt)
    masked = nlist_intersect(a_pre, a_post, y_pre, y_post, y_cnt, a_cnt=a_cnt,
                             early_stop=True, min_count=1 << 20, la_block=8)
    want = nlist_intersect_masked_ref(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, 1 << 20, la_block=8)
    assert not torch.equal(exact[1], masked[1]) or not exact[1].any()
    assert torch.equal(masked[0], want[0]) and torch.equal(masked[1], want[1])


def _wave_inputs(seed, width=32, pad=5):
    """Two waves of one random tree, laid out as the miner lays them out:
    the (3, K, W) N-list planes, and for level 2 (every pair q < p: parent
    p's singleton state, base p, extension q) and level 3 (each pair slot
    (q, p) extended by every q2 < q: base q) the (3, Cpad) index rows with
    ``pad`` padding slots of zeros."""
    rng = np.random.default_rng(seed)
    rows = random_db(rng, 200, 12, 7)
    fl = jenc.build_flist(jenc.item_support(rows, 12), 2)
    urows, w = jenc.dedup_rows(jenc.rank_encode(rows, fl))
    packed = pack_nlists(build_ppc(urows, w).nlists(fl.k), width=width).astype(np.int32)
    planes = np.ascontiguousarray(packed.transpose(2, 0, 1))
    pairs = [(q, p) for p in range(fl.k) for q in range(p)]
    trip = [(s, q, q2) for s, (q, _) in enumerate(pairs) for q2 in range(q)]

    def idx_of(parent, base, ext):
        idx = np.zeros((3, len(parent) + pad), np.int64)
        idx[0, :len(parent)], idx[1, :len(parent)], idx[2, :len(parent)] = parent, base, ext
        return idx

    l2 = idx_of([p for _, p in pairs], [p for _, p in pairs], [q for q, _ in pairs])
    l3 = idx_of(*zip(*trip))
    return planes, l2, len(pairs), l3, len(trip)


def _jax_wave(planes, prev_state, idx, stop, la_block):
    """The JAX package's wave on the same inputs: jnp.take of the parent
    states and of the N-list rows, then its masked (or exact) reference."""
    state = jnp.take(jnp.asarray(prev_state), jnp.asarray(idx[0]), axis=0)
    a = jnp.take(jnp.asarray(planes), jnp.asarray(idx[2]), axis=1)
    y = jnp.take(jnp.asarray(planes), jnp.asarray(idx[1]), axis=1)
    if stop is None:
        merged = jax_exact_ref(a[0], a[1], y[0], y[1], state)
        return np.asarray(merged), np.asarray(merged.sum(axis=1))
    merged, sup = jax_masked_ref(a[0], a[1], a[2], y[0], y[1], state, stop, la_block=la_block)
    return np.asarray(merged), np.asarray(sup)


@pytest.mark.parametrize("la_block", [1, 8, 512])
@pytest.mark.parametrize("stop", [None, 0, 4, 30, 1 << 30])
def test_wave_plain_vs_jax(la_block, stop):
    """The gather-fused wave's plain version against the JAX package's wave
    (gather, then its reference) over two levels, rows < n_live, tolerance
    0; padding rows are zero."""
    planes, l2, n2, l3, n3 = _wave_inputs(la_block + (stop or 0) % 97)
    prev = planes[2]  # level-2 parents: the singleton states
    for idx, n_live in ((l2, n2), (l3, n3)):
        assert n_live < idx.shape[1]
        es = stop is not None
        got, sup = nlist_wave_cuda(T(planes), T(prev), T(idx), n_live, early_stop=es,
                                   min_count=stop or 0, la_block=la_block)
        want, wsup = _jax_wave(planes, prev, idx, stop, la_block)
        assert got.dtype == sup.dtype == torch.int32
        np.testing.assert_array_equal(got[:n_live].numpy(), want[:n_live])
        np.testing.assert_array_equal(sup[:n_live].numpy(), wsup[:n_live])
        assert not got[n_live:].any() and not sup[n_live:].any()
        prev = got.numpy()


def test_wave_op_matches_gathered_op():
    """``nlist_wave`` equals ``nlist_intersect`` on the rows it would have
    gathered, B1 and B2 alike."""
    planes, idx, n_live, _, _ = _wave_inputs(3)
    P, I = T(planes), T(idx)
    a, y, state = P[:, I[2]], P[:2, I[1]], P[2][I[0]]
    for es in (False, True):
        got = nlist_wave(P, P[2], I, n_live, early_stop=es, min_count=6, la_block=4)
        want = nlist_intersect(a[0], a[1], y[0], y[1], state, a_cnt=a[2], early_stop=es,
                               min_count=6, la_block=4)
        assert torch.equal(got[0][:n_live], want[0][:n_live])
        assert torch.equal(got[1][:n_live], want[1][:n_live])
    with pytest.raises(ValueError, match="not available"):
        nlist_wave(P, P[2], I, n_live, backend="cuda")
