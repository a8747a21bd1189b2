"""Quickstart on the PyTorch port: the twin of ``examples/quickstart.py``,
the paper's pipeline end-to-end on a torch device.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The HPrepost mines run on ``--device`` (CUDA by default, raising without
one; ``cpu`` runs the kernels' plain PyTorch versions).

1. Builds the paper's Table-1 database.
2. Shows the PPC-tree/N-lists from the paper's Fig. 2.
3. Mines it through the unified ``repro_torch.mining`` front-door: one MineSpec,
   every algorithm (the distributed HPrepost contribution and the host
   baselines), one enriched MineResult each — all cross-checked.
4. Runs the paper's experimental surface — a threshold sweep — through the
   engine's planned path: prepare() once at the loosest threshold,
   mine_prepared() per threshold.
5. Shows the persistent PreparedDB cache: ad-hoc submits after the sweep
   re-run zero prep stages (engine.cache_info() tells the story).
"""
import argparse

from repro_torch.core import encoding as enc
from repro_torch.core.ppc import build_ppc
from repro_torch.mining import MineSpec, MiningEngine, mine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
DEV = ap.parse_args().device

# Paper Table 1 (a=0 b=1 c=2 d=3 e=4 f=5 g=6)
TX = [[0, 1, 6], [1, 2, 3, 5, 6], [0, 1, 4], [0, 3], [1, 2, 4], [0, 3, 4, 5], [1, 2]]
NAMES = "abcdefg"

rows = enc.pad_transactions(TX)
spec = MineSpec(algorithm="hprepost", min_count=3, candidate_unit=4)
# paper Example 1: threshold 3 of 7 transactions; a fraction spec resolves
# to the same count through MineSpec.resolve (the one conversion site).
assert spec.resolve(len(rows)) == MineSpec(min_sup=3 / 7).resolve(len(rows)) == 3

# --- the PPC-tree + N-lists of Fig. 1/2 --------------------------------
fl = enc.build_flist(enc.item_support(rows, 7), spec.resolve(len(rows)))
print("F-list:", [(NAMES[i], int(s)) for i, s in zip(fl.items, fl.supports)])
urows, w = enc.dedup_rows(enc.rank_encode(rows, fl))
tree = build_ppc(urows, w)
for rank, nl in enumerate(tree.nlists(fl.k)):
    item = NAMES[fl.items[rank]]
    codes = " ".join(f"({p},{q}):{c}" for p, q, c in nl)
    print(f"  N-list({item}) = {codes}")

# --- one front-door, every miner ---------------------------------------
res = mine(rows, 7, spec, device=DEV)  # the paper's distributed HPrepost
ref = mine(rows, 7, spec.with_(algorithm="prepost"), device=DEV)  # host baseline
assert res.itemsets == ref.itemsets
print(f"\n{res.summary()}")
print(f"stage times: " + ", ".join(f"{k} {v * 1e3:.1f}ms" for k, v in res.stage_times_s.items()))
print("frequent itemsets (HPrepost == PrePost):")
for items, sup in sorted(res.itemsets.items()):
    print(f"  {{{','.join(NAMES[i] for i in items)}}}: {sup}")

# --- derived pattern families (closed/maximal/top-rank-k post-passes) ---
closed = mine(rows, 7, spec.with_(algorithm="prepost", patterns="closed"), device=DEV)
print(f"closed itemsets: {len(closed.itemsets)} of {closed.total_count} frequent")

# --- the paper's x-axis: a planned threshold sweep -----------------------
# engine.sweep groups the thresholds over one database: Job 1 (histogram),
# Job 2 (PPC-tree), the N-list pack, and the F2 scan run ONCE at the
# loosest threshold; every min_sup is then served from the shared
# PreparedDB by the k>2 wave loop alone. min_sup resolves with ceiling
# semantics: an itemset is frequent iff support/n_rows >= min_sup.
engine = MiningEngine(device=DEV)
fracs = [4 / 7, 3 / 7, 2 / 7]
swept = engine.sweep(rows, 7, spec, fracs)
counters = engine.frontend("hprepost").miner_for(spec).stage_counters
assert counters["job1"] == counters["job2"] == counters["f2"] == 1
print(f"\nplanned sweep over min_sup={[f'{f:.2f}' for f in fracs]} "
      f"(prep ran once, {engine.stats['prepared_mines']} prepared mines):")
for frac, res in zip(fracs, swept):
    assert res.itemsets == mine(rows, 7, spec.with_(min_sup=frac), device=DEV).itemsets
    tag = " [shared prep]" if res.prep_shared else ""
    print(f"  min_sup={frac:.2f} (min_count={res.min_count}): "
          f"{res.total_count} itemsets{tag}")

# --- persistent PreparedDB cache ----------------------------------------
# the sweep's PreparedDB stays resident (LRU under prep_cache_bytes), so an
# ad-hoc submit at any tighter-or-equal threshold re-runs ZERO prep stages:
adhoc = engine.submit(rows, 7, spec)
assert adhoc.prep_shared and counters["job1"] == 1  # no prep re-run
info = engine.cache_info()
print(f"\ncache after ad-hoc resubmit: {info['hits']} hit(s), "
      f"{info['misses']} miss(es), {info['entries']} entr(ies), "
      f"{info['bytes_in_use']}B of {info['byte_budget']}B budget")
