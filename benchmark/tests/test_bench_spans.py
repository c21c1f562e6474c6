"""The readers of the program's spans (benchmark/spans.py and the
per-layer metrics that use it) on hand-made runs and records."""

import importlib.util
import types

import pytest

from benchmark import spans
from benchmark.run import ROOT

READERS = ("serve.queue_wait_ms", "engine.inputs_ms.serve",
           "engine.results_ms.serve", "serve.pad_share",
           "structure.device_ms.serve", "sequence.device_ms.serve",
           "train.data_wait_ms", "structure.host_ms.sample")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"),
        ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(mix=None):
    return types.SimpleNamespace(t0=100.0, setup_s=20.0, seconds=40.0,
                                 mix=mix or {})


def _span(ms, device_ms=None, **attrs):
    return types.SimpleNamespace(seconds=ms / 1e3, device_ms=device_ms,
                                 attrs=attrs)


def test_the_window_starts_with_the_timed_window_and_ends_at_the_trace():
    assert spans.window(_run()) == (120.0, 160.0)
    assert spans.window(_run({"trace_s": 1.5, "trace_end_s": 0.5})) == (
        120.0, 158.0)
    assert spans.window(_run({"trace_s": 1.5})) == (120.0, 158.5)


def test_records_are_the_program_s_spans_inside_the_window():
    from e3diff_tpu_torch.utils import telemetry

    rec = telemetry.recorder()
    rec.clear()
    try:
        for t0, t1 in ((119.0, 121.0), (121.0, 122.0), (157.0, 159.0)):
            s = rec.start("engine.inputs")
            s.t0 = t0
            rec.finish(s, t1)
        got = spans.records(_run({"trace_s": 1.5, "trace_end_s": 0.0}),
                            "engine.inputs")
        assert [(s.t0, s.t1) for s in got] == [(121.0, 122.0)]
        assert spans.records(_run(), "engine.results") == []
    finally:
        rec.clear()


HAND_MADE = {
    "batcher.queue_wait": [_span(ms, batcher="design")
                           for ms in range(1, 21)]
    + [_span(500.0, batcher="inverse_fold")],
    "engine.inputs": [_span(10.0), _span(30.0)],
    "engine.results": [_span(4.0), _span(8.0), _span(12.0)],
    "engine.batch": [_span(1.0, batch=16, ligand=8, positions=48),
                     _span(1.0, batch=64, ligand=16, positions=400)],
    "structure.run": [_span(5.0, 100.0, captured=True),
                      _span(6.0, 80.0, captured=False), _span(7.0, 90.0),
                      _span(2400.0, None)],
    "sequence.run": [_span(3.0, 40.0), _span(3.0, 60.0)],
    "train.data_wait": [_span(1.0), _span(2.0), _span(6.0)],
}

WANT = {
    "serve.queue_wait_ms": 19.0,            # nearest rank of 20: the 19th
    "engine.inputs_ms.serve": 20.0,
    "engine.results_ms.serve": 8.0,
    "serve.pad_share": 100.0 * (1 - 448 / (16 * 8 + 64 * 16)),
    "structure.device_ms.serve": 85.0,
    "sequence.device_ms.serve": 50.0,
    "train.data_wait_ms": 3.0,
    "structure.host_ms.sample": 6.5,
}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_hand_made_records(name, monkeypatch):
    monkeypatch.setattr(spans, "records",
                        lambda run, span: list(HAND_MADE.get(span, [])))
    assert _reader(name)(_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_none_from_an_empty_window(name, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda run, span: [])
    assert _reader(name)(_run()) is None
