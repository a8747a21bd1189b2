"""The port's ``StatsEmitter`` against the reference's: the emitter cases of
``test_telemetry.py``, each run with both classes on the same inputs. The
chaos-drop, error and sink cases are deterministic and compared exactly
(counters and lines but the clocks); the periodic case's tick count depends
on thread timing, so both are held to the same invariants."""
import io
import json
import time

import pytest

import repro.fault.failures as jfail
import repro.mining.telemetry as jtel
import repro_torch.fault.failures as tfail
import repro_torch.mining.telemetry as ttel

SIDES = ((jtel, jfail), (ttel, tfail))
CLOCKS = ("uptime_s", "wall_time")


def _lines(text):
    return [{k: v for k, v in json.loads(line).items() if k not in CLOCKS}
            for line in text.splitlines()]


def test_emitter_periodic_lines_and_final_snapshot():
    for tel, _ in SIDES:
        sink = io.StringIO()
        reg = tel.Registry()
        reg.histogram("x_s").record(0.01)
        with tel.StatsEmitter(reg.snapshot, sink, interval_s=0.01) as em:
            time.sleep(0.08)
        lines = [json.loads(line) for line in sink.getvalue().splitlines()]
        assert em.stats["periodic"] >= 2 and em.stats["errors"] == 0
        assert len(lines) == em.stats["emits"]
        assert lines[-1]["reason"] == "final"
        for i, line in enumerate(lines):
            assert line["schema"] == tel.SCHEMA_VERSION == jtel.SCHEMA_VERSION and line["seq"] == i
            assert line["stats"]["histograms"]["x_s"]["count"] == 1
            assert line["uptime_s"] >= 0


def test_emitter_swallows_chaos_drops_and_keeps_ticking():
    out = []
    for tel, failures in SIDES:
        sink = io.StringIO()
        em = tel.StatsEmitter(lambda: {"ok": 1}, sink, interval_s=0.01)
        inj = failures.ChaosInjector().arm("telemetry.emit", times=2)
        with failures.installed(inj):
            steps = [em.emit_once(), em.emit_once(), em.emit_once()]
        out.append((steps, dict(em.stats), _lines(sink.getvalue())))
    assert out[1] == out[0]
    steps, stats, lines = out[1]
    assert steps == [False, False, True]  # schedule exhausted -> line lands
    assert stats["dropped"] == 2 and stats["emits"] == 1 and stats["errors"] == 0
    assert len(lines) == 1


def test_emitter_counts_snapshot_and_sink_errors():
    def boom():
        raise RuntimeError("snapshot failed")

    class BadSink:
        def write(self, s):
            raise OSError("disk gone")

    out = []
    for tel, _ in SIDES:
        em = tel.StatsEmitter(boom, io.StringIO(), interval_s=0.01)
        em2 = tel.StatsEmitter(lambda: {}, BadSink(), interval_s=0.01)
        got = (em.emit_once(), dict(em.stats), em2.emit_once(), dict(em2.stats))
        em2.stop(final=False)
        out.append(got)
    assert out[1] == out[0]
    assert out[1][0] is False and out[1][1]["errors"] == 1
    assert out[1][2] is False and out[1][3]["errors"] == 1


def test_emitter_file_sink_creates_parents(tmp_path):
    out = []
    for i, (tel, _) in enumerate(SIDES):
        path = tmp_path / str(i) / "deep" / "stats.jsonl"
        with tel.StatsEmitter(lambda: {"n": 1}, str(path), interval_s=5.0):
            pass  # no periodic tick fits; stop() emits the final line
        out.append(_lines(path.read_text()))
    assert out[1] == out[0]
    assert len(out[1]) == 1 and out[1][0]["reason"] == "final"


def test_emitter_rejects_bad_interval():
    for tel, _ in SIDES:
        with pytest.raises(ValueError):
            tel.StatsEmitter(lambda: {}, io.StringIO(), interval_s=0.0)
