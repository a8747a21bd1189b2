"""Kernel times of one checkout of the PyTorch/CUDA port, taken with
``chip_smoke.py``'s method, so that two commits can be compared like for
like in one run on one card.

    python3 chip_compare.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``src/repro_torch`` is built and timed
(default: this file's own); the timing code is always this file's and the
``chip_smoke.py`` beside it. To compare a commit with its parent, unpack the
parent (``git archive``) into a directory and run parent, this, this, parent.

At the main path's shapes — the level-2 waves of mushroom@0.15, pumsb@0.15
and kosarak@0.01, their ranked rows, their rows — it times, each with
the stream held while the launches queue (``queued``, device time) and
without (``unqueued``, which also counts the host's launch time):
  - ``b1_rows`` / ``b2_rows``: B1 and B2 on the gathered rows, through the
    JAX-shaped ``nlist_intersect_cuda`` / ``nlist_intersect_es_cuda`` that
    every commit of the port has: the same kernel inputs on both sides;
  - ``b1_wave`` / ``b2_wave``: one wave as the checkout's miner runs it
    (``HPrepostMiner._wave``: its index copy, any gathers, the kernel);
  - ``b4``: ``cooccur_cuda`` on the ranked rows; ``b3``: ``histogram_cuda``
    on the rows (weights all ones, as Job 1 calls it), and
    ``b3_zero_weights`` with every weight 0: a kernel that skips a zero
    weight then makes the same loads and no atomic.
B2 runs at the dataset's min_count, la_block 512. Then B4 at its two wide
shapes: ``b4_production``, the reference's production rows (1,048,576 x 48
Zipf rows over 41,270 items from ``launch.dryrun_fim.zipf_rows``, ranked by
``top_k_flist`` to K = 2,048, as phase 14 of ``chip_smoke.py`` builds them)
and ``b4_pumsb_segment``, pumsb's first 12,262 rows ranked by their own
supports (K = 7,104, the width of phase 8's first segment). Every output is
held to exact equality with the checkout's plain version. Prints one JSON
line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SUPS = {"mushroom": 0.15, "pumsb": 0.15, "kosarak": 0.01}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import assert_equal, time_ms

    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import repro_torch
    import repro_torch.kernels as K
    from repro_torch.core import encoding as enc
    from repro_torch.core.hprepost import HPrepostConfig, HPrepostMiner
    from repro_torch.data import synth
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.cooccur import ref as cooc_ref
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.nlist_intersect import ref as nl_ref

    _cuda.build_all()
    dev = torch.device("cuda")
    out = {"label": args.label, "package": str(Path(repro_torch.__file__).parent), "device":
           torch.cuda.get_device_name(0)}

    def both(fn):
        return {"queued": time_ms(fn), "unqueued": time_ms(fn, queued=False)}

    miners = {es: HPrepostMiner("cuda", HPrepostConfig(early_stop=es)) for es in (False, True)}
    fused = "n_live" in inspect.signature(miners[True]._wave).parameters
    for name in SUPS:
        rows, n_items = synth.load(name, scale=1.0)
        mc = max(1, math.ceil(SUPS[name] * len(rows) - 1e-9))
        prep = miners[True].prepare(rows, n_items, mc)
        qs, ps = np.nonzero(prep.C >= mc)
        ranks = np.stack([qs, ps], axis=1).astype(np.int32)
        idx, _, _ = miners[True]._pack_wave(ranks, ps.astype(np.int64), qs.astype(np.int32))
        n_live = len(ranks)
        planes = prep.packed[0].permute(2, 0, 1).contiguous()
        state = planes[2]
        idx_t = torch.from_numpy(idx).to(dev)
        a, y, c = planes[:, idx_t[2]], planes[:2, idx_t[1]], state[idx_t[0]]
        g1 = (a[0], a[1], y[0], y[1], c)
        g2 = (a[0], a[1], a[2], y[0], y[1], c, mc)
        want1 = nl_ref.nlist_intersect_fused_ref(*g1)
        want2 = nl_ref.nlist_intersect_masked_ref(*g2, la_block=512)
        assert_equal(f"B1 rows {name}", K.nlist_intersect_cuda(*g1), want1)
        assert_equal(f"B2 rows {name}", K.nlist_intersect_es_cuda(*g2, la_block=512), want2)

        def wave(es):
            if fused:
                return lambda: miners[es]._wave(planes, state, idx, n_live, mc)
            return lambda: miners[es]._wave(planes, state, idx, mc)

        for es, want in ((False, want1), (True, want2)):
            got = wave(es)()
            assert_equal(f"wave early_stop={es} {name}", [g[:n_live] for g in got],
                         [w[:n_live] for w in want])
        r = out[name] = {"n_live": n_live, "Cpad": idx.shape[1], "W": planes.shape[2],
                         "min_count": mc}
        r["b1_rows"] = both(lambda: K.nlist_intersect_cuda(*g1))
        r["b2_rows"] = both(lambda: K.nlist_intersect_es_cuda(*g2, la_block=512))
        r["b1_wave"], r["b2_wave"] = both(wave(False)), both(wave(True))
        del a, y, c, g1, g2, want1, want2

        lut = torch.from_numpy(prep.fl.rank_lut()).to(dev)
        ranked = enc.rank_encode_torch(torch.from_numpy(rows).to(dev), lut, n_items)
        w1 = torch.ones(ranked.shape[0], dtype=torch.int32, device=dev)
        assert_equal(f"B4 {name}", (K.cooccur_cuda(ranked, w1, n_items=prep.fl.k),),
                     (cooc_ref.cooccur_ref(ranked, w1, n_items=prep.fl.k),))
        r["b4"] = both(lambda: K.cooccur_cuda(ranked, w1, n_items=prep.fl.k))
        rows_d = torch.from_numpy(rows).to(dev)
        w0 = torch.zeros_like(w1)
        for key, wb in (("b3", w1), ("b3_zero_weights", w0)):
            assert_equal(f"{key} {name}", (K.histogram_cuda(rows_d, wb, n_bins=n_items),),
                         (hist_ref.histogram_ref(rows_d, wb, n_bins=n_items),))
            r[key] = both(lambda: K.histogram_cuda(rows_d, wb, n_bins=n_items))
        del prep, planes, state, idx_t, ranked, lut, w1, w0, rows_d
        torch.cuda.empty_cache()
    # B4 at its wide shapes
    from repro_torch.launch.dryrun_fim import top_k_flist, zipf_rows

    def wide(key, ranked, k):
        w1 = torch.ones(ranked.shape[0], dtype=torch.int32, device=dev)
        assert_equal(key, (K.cooccur_cuda(ranked, w1, n_items=k),), (cooc_ref.cooccur_ref(ranked, w1, n_items=k),))
        out[key] = {"shape": f"{tuple(ranked.shape)}, K {k}", **both(lambda: K.cooccur_cuda(ranked, w1, n_items=k))}

    raw = zipf_rows(1_048_576, 48, 41_270, seed=0, device=dev)
    fl = top_k_flist(torch.bincount(raw[raw >= 0].long(), minlength=41_270).cpu().numpy(), 2048)
    wide("b4_production", enc.rank_encode_torch(raw, torch.from_numpy(fl.rank_lut()).to(dev), 41_270), 2048)
    del raw
    rows, n_items = synth.load("pumsb", scale=1.0)
    seg = rows[:12_262]
    sup = np.bincount(seg[seg >= 0], minlength=n_items)
    items = np.nonzero(sup)[0]
    order = items[np.argsort(-sup[items], kind="stable")]
    lut = np.full(n_items, -1, np.int32)
    lut[order] = np.arange(len(order))
    ranked = np.where(seg >= 0, lut[np.maximum(seg, 0)], -1).astype(np.int32)
    wide("b4_pumsb_segment", torch.from_numpy(ranked).to(dev), len(order))
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
