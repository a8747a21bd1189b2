"""The readers of the program's span table, on hand-built runs: each takes
its spans' seconds a request, the wave roofline its floor bytes against
the traced wave kernels, and each is silent where the table (or the
trace) holds nothing for it, as on a program that keeps no table."""
import importlib
from types import SimpleNamespace

import pytest

from fimbench import roofline
from fimbench.loops import Request
from repro_torch.mining.telemetry import trace

TABLE = {
    "engine.submit": {"count": 4, "total_s": 0.200, "self_s": 0.004, "device_s": 0.0},
    "engine.fingerprint": {"count": 4, "total_s": 0.002, "self_s": 0.002, "device_s": 0.0},
    "engine.cache": {"count": 4, "total_s": 0.001, "self_s": 0.001, "device_s": 0.0},
    "frontend.mine": {"count": 4, "total_s": 0.190, "self_s": 0.003, "device_s": 0.0},
    "frontend.finish": {"count": 4, "total_s": 0.005, "self_s": 0.005, "device_s": 0.0},
    "mine.planes": {"count": 4, "total_s": 0.006, "self_s": 0.006, "device_s": 0.0},
    "prep": {"count": 4, "total_s": 0.100, "self_s": 0.001, "device_s": 0.0},
    "prep.h2d": {"count": 4, "total_s": 0.030, "self_s": 0.030, "device_s": 0.032},
    "prep.job1": {"count": 4, "total_s": 0.010, "self_s": 0.010, "device_s": 0.011},
    "prep.job2": {"count": 4, "total_s": 0.020, "self_s": 0.020, "device_s": 0.021},
    "prep.pack": {"count": 4, "total_s": 0.015, "self_s": 0.015, "device_s": 0.013},
    "prep.f2": {"count": 4, "total_s": 0.024, "self_s": 0.024, "device_s": 0.022},
    "mine.waves": {"count": 4, "total_s": 0.080, "self_s": 0.004, "device_s": 0.0},
    "mine.plan": {"count": 24, "total_s": 0.040, "self_s": 0.040, "device_s": 0.0},
    "mine.wave": {"count": 12, "total_s": 0.012, "self_s": 0.012, "device_s": 0.0},
    "mine.reduce": {"count": 12, "total_s": 0.008, "self_s": 0.008, "device_s": 0.0},
    "mine.emit": {"count": 12, "total_s": 0.016, "self_s": 0.016, "device_s": 0.0},
    "wave.floor_bytes": {"count": 12, "total": 3_350_000},
}
WAVE_KERNELS = {"void (anonymous namespace)::wave_kernel<true, 256, 8>(int const*)": 2e-6,
                "void (anonymous namespace)::wave_kernel<false, 1024, 4>(int const*)": 3e-6,
                "void (anonymous namespace)::hist_kernel<true>(int const*)": 7.0}

# reader -> its value on TABLE over four requests, in ms (or %)
EXPECTED = {
    "frontdoor_self_ms": 1e3 * (0.004 + 0.002 + 0.001 + 0.003 + 0.005 + 0.006) / 4,
    "prep_h2d_ms": 1e3 * 0.032 / 4,
    "prep_job1_ms": 1e3 * 0.011 / 4,
    "prep_job2_ms": 1e3 * (0.021 + 0.013) / 4,
    "prep_f2_ms": 1e3 * 0.022 / 4,
    "wave_host_ms": 1e3 * (0.004 + 0.040 + 0.012 + 0.016) / 4,
    "wave_wait_ms": 1e3 * 0.008 / 4,
    "wave_kernel_roofline": 100 * roofline.bound_s(3_350_000, 0) / 5e-6,
}


def run_of(n_requests=4, op_s=WAVE_KERNELS):
    reqs = [Request(0.01, 0.05, {}, None, (0, 0)) for _ in range(n_requests)]
    return SimpleNamespace(requests=reqs, trace={"op_s": dict(op_s)})


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_takes_its_spans_a_request(monkeypatch, name):
    monkeypatch.setattr(trace, "profiled", lambda: {k: dict(v) for k, v in TABLE.items()})
    reader = importlib.import_module(f"fimbench.metrics.{name}")
    assert reader.read(run_of()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_without_the_table(monkeypatch, name):
    """An empty table (an untraced window) and a program without one."""
    reader = importlib.import_module(f"fimbench.metrics.{name}")
    monkeypatch.setattr(trace, "profiled", dict)
    assert reader.read(run_of()) is None
    monkeypatch.delattr(trace, "profiled")
    assert reader.read(run_of()) is None


def test_wave_roofline_needs_the_traced_wave_kernels(monkeypatch):
    from fimbench.metrics import wave_kernel_roofline

    monkeypatch.setattr(trace, "profiled", lambda: dict(TABLE))
    assert wave_kernel_roofline.read(run_of(op_s={"hist_kernel<true>": 1.0})) is None
    run = run_of()
    run.trace = None
    assert wave_kernel_roofline.read(run) is None
