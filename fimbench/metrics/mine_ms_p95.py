"""The 95th percentile of every request's latency in the window: the host
clock around the call, which returns with the itemsets on the host."""
import statistics


def read(run):
    lat = [r.latency_s for r in run.requests]
    if len(lat) < 2:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
