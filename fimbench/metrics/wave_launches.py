"""B1 and B2 launches a request, from the program's kernel launch counters
(read around each call in the traced run)."""

WAVE_KERNELS = ("nlist_intersect", "nlist_intersect_es")


def read(run):
    counted = [r.launches for r in run.requests if r.launches is not None]
    if not counted:
        return None
    return sum(sum(c[k] for k in WAVE_KERNELS) for c in counted) / len(counted)
