"""The trace digest on hand-written Chrome traces."""

import pytest

from benchmark import tracing


def _ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_busy_union_idle_and_gaps():
    trace = {"traceEvents": [
        _ev("step", 0, 100, "cpu_op"),
        _ev("k1", 10, 20, "kernel"),
        _ev("k2", 20, 20, "kernel"),      # overlaps k1: counted once
        _ev("memcpy", 60, 10, "gpu_memcpy"),
        _ev("pdb_text", 72, 20, "cpu_op"),
        _ev("k3", 95, 5, "kernel"),
    ]}
    d = tracing.digest(trace)
    assert d["window_s"] == pytest.approx(100e-6)
    assert d["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert d["ops"]["k1"] == pytest.approx(20)
    # the longest gap (70..95) is named by the host op inside it
    assert d["gaps"][0][0] == "pdb_text"
    assert d["gaps"][0][1] == pytest.approx(25e-6)
    assert tracing.top_ops(d["ops"], 2)[0][0] in ("k1", "k2")


def test_no_device_events():
    d = tracing.digest({"traceEvents": [_ev("x", 0, 5, "cpu_op")]})
    assert d["busy_s"] == 0.0 and d["ops"] == {}
