"""Port vs reference: host encoding, F-list, the seeded datasets, and the
torch rank encoding against ``rank_encode_jnp``. Integer outputs are
compared exactly (tolerance 0), dtype included."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import encoding as jenc
from repro.data import synth as jsynth
from repro_torch.core import encoding as tenc
from repro_torch.data import synth as tsynth

DATASETS = [("chess", 0.02), ("mushroom", 0.02), ("pumsb", 0.01), ("kosarak", 0.001)]


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,scale", DATASETS)
@pytest.mark.parametrize("seed", [0, 1])
def test_synth_load_identical(name, scale, seed):
    rows_t, n_t = tsynth.load(name, scale=scale, seed=seed)
    rows_j, n_j = jsynth.load(name, scale=scale, seed=seed)
    assert n_t == n_j
    assert_same(rows_t, rows_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_db_identical(seed):
    assert_same(tsynth.random_db(np.random.default_rng(seed), 50, 12, 7),
                jsynth.random_db(np.random.default_rng(seed), 50, 12, 7))


@pytest.mark.parametrize("name,scale", DATASETS)
def test_flist_and_host_rank_encode(name, scale):
    rows, n_items = jsynth.load(name, scale=scale)
    sup_t, sup_j = tenc.item_support(rows, n_items), jenc.item_support(rows, n_items)
    assert_same(sup_t, sup_j)
    mc = max(1, int(0.1 * len(rows)))
    fl_t, fl_j = tenc.build_flist(sup_t, mc), jenc.build_flist(sup_j, mc)
    assert_same(fl_t.items, fl_j.items)
    assert_same(fl_t.supports, fl_j.supports)
    assert (fl_t.n_items, fl_t.min_count) == (fl_j.n_items, fl_j.min_count)
    assert_same(fl_t.rank_lut(), fl_j.rank_lut())
    r_t, r_j = tenc.rank_encode(rows, fl_t), jenc.rank_encode(rows, fl_j)
    assert_same(r_t, r_j)
    for a, b in zip(tenc.dedup_rows(r_t), jenc.dedup_rows(r_j)):
        assert_same(a, b)


@pytest.mark.parametrize("name,scale", DATASETS)
@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_rank_encode_torch_vs_jnp(name, scale, frac):
    rows, n_items = jsynth.load(name, scale=scale)
    fl = jenc.build_flist(jenc.item_support(rows, n_items), max(1, int(frac * len(rows))))
    lut = fl.rank_lut()
    want = np.asarray(jenc.rank_encode_jnp(jnp.asarray(rows), jnp.asarray(lut), n_items))
    got = tenc.rank_encode_torch(torch.from_numpy(rows), torch.from_numpy(lut), n_items)
    assert_same(got.numpy(), want)


def test_pad_transactions_identical():
    tx = [[3, 1, 3], [], [7, 2, 5, 9, 0], [4]]
    assert_same(tenc.pad_transactions(tx), jenc.pad_transactions(tx))
    assert_same(tenc.pad_transactions(tx, max_len=2), jenc.pad_transactions(tx, max_len=2))
