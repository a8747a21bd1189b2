"""Prep (Job 1, Job 2 with the pack, the F2 scan) a request, from the
program's ``stage_times_s``: their sum ends at a synchronising read of the
F2 matrix, so it holds the device's prep work; the split does not."""
from fimbench.metrics import stage_mean

PREP = ("job1_flist", "job2_ppc_pack", "f2_scan")


def read(run):
    return stage_mean(run, lambda st: sum(st.get(k, 0.0) for k in PREP))
