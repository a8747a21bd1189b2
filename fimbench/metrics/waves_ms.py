"""The wave loop a request (host planning and the B1/B2 launches), from the
program's ``stage_times_s["mining_waves"]``, which ends once the last
wave's supports are on the host."""
from fimbench.metrics import stage_mean


def read(run):
    return stage_mean(run, lambda st: st.get("mining_waves", 0.0))
