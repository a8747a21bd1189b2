"""The prep kernels' share of their roofline over the traced window.

Time: the device time of every B3 (item histogram) and B4 (co-occurrence)
kernel the window ran, from the profiler's trace by the program's kernel
names. Work: for each request whose call launched B3 (B4), one histogram
of the cell's rows (one co-occurrence pass over the rows' items that are
frequent at the request's threshold), whatever number of launches did it,
by the program's launch counters; its bound is ``fimbench.roofline``'s,
counted from the cell's inputs. Σ bound / Σ time, in percent. Silent
where the window ran neither kernel."""
import numpy as np

from fimbench import reference, roofline

B3_KERNELS = ("hist_kernel",)
B4_KERNELS = ("cooc_band_kernel", "cooc_bucket_kernel", "cooc_wgmma_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace["op_s"].items()
                  if any(k in name for k in B3_KERNELS + B4_KERNELS))
    n_rows, width = run.rows.shape
    valid = run.rows >= 0
    support = np.bincount(run.rows[valid], minlength=run.n_items)  # a row's items are distinct
    b3 = roofline.bound_s(*roofline.histogram_work(n_rows, width, run.n_items))
    b4: dict = {}

    def cooccur_bound(min_sup):
        if min_sup not in b4:
            frequent = support >= reference.min_count_of(min_sup, n_rows)
            n_valid = (valid & frequent[np.clip(run.rows, 0, None)]).sum(axis=1)
            b4[min_sup] = roofline.bound_s(*roofline.cooccur_work(
                n_rows, width, n_valid, int(frequent.sum())))
        return b4[min_sup]

    bound = 0.0
    for r in (r for r in run.requests if r.launches is not None):
        if r.launches["histogram"]:
            bound += b3
        if r.launches["cooccur"]:
            bound += cooccur_bound(r.min_sup)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
