"""What a request spends outside the program's timed stages (prep and
waves): the front end, the engine, and the miner between its stages. The
harness's own span around the call, less the stages the answer reports."""
from fimbench.metrics import stage_mean

STAGES = ("job1_flist", "job2_ppc_pack", "f2_scan", "mining_waves")


def read(run):
    return stage_mean(run, lambda st: -sum(st.get(k, 0.0) for k in STAGES), with_latency=True)
