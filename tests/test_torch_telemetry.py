"""The port's span recorder (utils/telemetry.py) and the spans and counters
at its layer boundaries, on the CPU: nesting and parent ids, links across
threads, the ring's bound, windows, concurrent appends, profiler ranges;
the batcher's queue waits, the engine's stages under each device batch,
the prefetch thread's data waits, the training loop's record, the graph
cache's counters and GET /stats."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from e3diff_tpu_torch.data.prefetch import prefetch_to_device
from e3diff_tpu_torch.serving import DesignServer, MicroBatcher
from e3diff_tpu_torch.training.loop import train_loop
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.graph_cache import GraphCache
from tests.test_torch_engine import (  # noqa: F401  (params: a fixture)
    _engine,
    _pocket,
    params,
)


@pytest.fixture
def rec():
    telemetry.recorder().clear()
    yield telemetry.recorder()
    telemetry.recorder().clear()


def test_spans_nest_and_name_their_parents(rec):
    with telemetry.span("outer", a=1) as outer:
        with telemetry.span("inner") as inner:
            inner.attrs["b"] = 2
        with telemetry.span("other", parent=7) as other:
            pass
    with telemetry.span("after") as after:
        pass
    assert outer.parent is None and inner.parent == outer.id
    assert other.parent == 7 and after.parent is None
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.attrs == {"b": 2} and outer.attrs == {"a": 1}
    assert [s.name for s in rec.spans("inner")] == ["inner"]
    assert inner.device_ms is None
    with pytest.raises(ValueError):
        with telemetry.span("failed"):
            raise ValueError("x")
    assert rec.spans("failed")[0].attrs["error"] == "ValueError"


def test_a_span_started_on_one_thread_is_finished_on_another(rec):
    with telemetry.span("request") as request:
        wait = telemetry.start("wait", batches=[])
    assert wait.parent == request.id and wait.t1 is None

    def worker():
        with telemetry.span("batch") as batch:
            wait.attrs["batches"].append(batch.id)
            telemetry.finish(wait, batch.t0)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    batch = rec.spans("batch")[0]
    assert batch.parent is None and batch.thread != request.thread
    assert rec.spans("wait")[0].attrs["batches"] == [batch.id]
    assert wait.t1 == batch.t0


def test_the_ring_keeps_the_newest_and_totals_keep_all():
    r = telemetry.Recorder(size=8)
    for i in range(20):
        with r.span("s", i=i):
            pass
    kept = r.spans("s")
    assert [s.attrs["i"] for s in kept] == list(range(12, 20))
    n, secs = r.total("s")
    assert n == 20 and secs >= 0
    summary = r.summary()["s"]
    assert summary["count"] == 8
    assert summary["p95_ms"] == max(1e3 * s.seconds for s in kept)
    r.clear()
    assert r.spans("s") == [] and r.total("s") == (0, 0.0)


def test_spans_inside_a_window(rec):
    with telemetry.span("a"):
        pass
    mid = time.monotonic()
    with telemetry.span("a"):
        pass
    with telemetry.span("b"):
        pass
    assert len(rec.spans("a")) == 2
    assert len(rec.spans("a", mid)) == 1
    assert rec.spans("a", mid, mid) == []
    assert len(rec.spans("a", hi=mid)) == 1


def test_concurrent_appends_from_eight_threads_lose_none():
    r = telemetry.Recorder(size=1 << 16)

    def worker(k):
        for i in range(1000):
            with r.span("s", k=k):
                with r.span("t"):
                    pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = r.spans("s")
    assert len(spans) == 8000 and r.total("t")[0] == 8000
    assert len({s.id for s in spans + r.spans("t")}) == 16000
    parents = {s.id: s.thread for s in spans}
    assert all(parents[t.parent] == t.thread for t in r.spans("t"))


def test_a_profiler_on_the_spans_thread_gets_a_range(rec, monkeypatch):
    made = []
    original = torch.autograd.profiler.record_function

    def counting(name):
        made.append(name)
        return original(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with telemetry.span("unprofiled"):
        pass
    assert made == []
    other = threading.Thread(
        target=lambda: telemetry.span("elsewhere").__enter__().__exit__(
            None, None, None))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with telemetry.span("profiled"):
            torch.ones(4).sum()
        other.start()
        other.join()
    names = {e.name for e in prof.events()}
    assert made == ["profiled"]
    assert "profiled" in names and "elsewhere" not in names
    assert "unprofiled" not in names


def test_batcher_queue_wait_names_the_batches_its_slots_rode_in(rec):
    gate = threading.Event()

    def run(items):
        gate.wait(5)
        return items

    b = MicroBatcher(run, max_batch=2, max_wait_ms=50.0, linger_ms=20.0,
                     name="design")
    try:
        first = b.submit("held")         # the worker holds it at the gate
        time.sleep(0.1)
        with telemetry.span("server.request") as request:
            futures = b.submit_many(["a", "b", "c"])
        gate.set()
        assert first.result(5) == "held"
        assert [f.result(5) for f in futures] == ["a", "b", "c"]
        stats = b.stats()
    finally:
        b.shutdown()
    batches = {s.id: s for s in rec.spans("batcher.batch")}
    waits = {s.attrs["request"]: s for s in rec.spans("batcher.queue_wait")}
    wait = waits[request.id]
    assert wait.parent == request.id and wait.attrs["batcher"] == "design"
    rode = [batches[i] for i in wait.attrs["batches"]]
    assert sum(s.attrs["slots"] for s in rode) >= 3 and len(rode) == 2
    assert all(s.attrs["batcher"] == "design" for s in rode)
    assert wait.t1 == rode[-1].t0 and wait.seconds > 0
    assert stats["queue_wait_ms_p95"] >= 1e3 * wait.seconds


def test_engine_stages_nest_under_each_device_batch(params, rec):
    eng = _engine(params)
    gen = torch.Generator().manual_seed(0)
    eng.design_records([_pocket(6, 5, 0), _pocket(7, 9, 1)], generator=gen)
    batch = rec.spans("engine.batch")[0]
    assert batch.attrs == {"kind": "design", "ligand": 16, "receptor": 32,
                           "batch": 4, "slots": 2, "positions": 14}
    for name in ("engine.inputs", "structure.run", "sequence.run",
                 "engine.readback", "engine.results"):
        (span,) = rec.spans(name)
        assert span.parent == batch.id, name
        assert batch.t0 <= span.t0 <= span.t1 <= batch.t1
    assert rec.spans("structure.run")[0].attrs["bucket"] == (4, 16, 32)
    assert eng.stats() == {"buckets": [
        {"kind": "design", "ligand": 16, "receptor": 32, "batch": 4,
         "batches": 1, "slots": 2, "dead_slots": 2,
         "padded_positions": 4 * 16 - 14}]}


def test_prefetch_records_one_data_wait_per_batch(rec):
    batches = [{"x": np.full(3, i, np.float32)} for i in range(5)]
    feed = prefetch_to_device(iter(batches), "cpu", size=2)
    got = [next(feed)["x"][0].item() for _ in range(5)]
    feed.close()
    assert got == [0, 1, 2, 3, 4]
    waits = rec.spans("train.data_wait")
    assert len(waits) == 5
    assert all(0 <= w.attrs["depth"] <= 2 for w in waits)


class _Trainer:
    """A trainer stand-in for the loop: metrics on the CPU, a state that
    saves."""

    mesh = None

    def train_step(self, batch):
        with telemetry.span("train.step"):
            return {"train_loss": torch.tensor(float(batch["x"][0]))}

    def eval_step(self, batch):
        return {"val_loss": torch.tensor(1.0)}

    def full_state_dict(self):
        return {"w": torch.zeros(2)}

    def weights(self):
        return {"w": torch.zeros(2)}

    def ema_weights(self):
        return None


def test_the_loop_record_reads_its_spans(rec, tmp_path):
    history = train_loop(
        _Trainer(), lambda epoch: [{"x": np.ones(2)}] * 4,
        lambda: [{"x": np.ones(2)}] * 2, max_epochs=1, device="cpu",
        ckpt_dir=str(tmp_path), log_fn=lambda s: None, resume=False)
    record = history[0]
    for key in ("epoch", "train_loss", "val_loss", "steps_per_sec",
                "epoch_seconds", "data_wait_seconds", "ckpt_wait_seconds"):
        assert key in record, key
    waits = rec.spans("train.data_wait")
    steps = rec.spans("train.step")
    (evaluation,) = rec.spans("train.eval")
    assert len(steps) == 4
    train_waits = [w for w in waits if w.t1 <= evaluation.t0]
    assert len(train_waits) == 5        # four batches and the epoch's end
    assert record["data_wait_seconds"] == pytest.approx(
        sum(w.seconds for w in train_waits))
    assert record["data_wait_seconds"] <= record["epoch_seconds"]
    (saving,) = rec.spans("train.checkpoint_wait")
    assert record["ckpt_wait_seconds"] == saving.seconds
    assert saving.t0 >= evaluation.t1


@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_a_train_step_span_names_its_model(rec, kind):
    """Each trainer's train step (captured on a card, eager on the CPU)
    runs in a ``train.step`` span naming its model, with the card's time
    where there is a card."""
    from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu_torch.data.prefetch import to_device
    from e3diff_tpu_torch.training.run import PRESETS, build_trainer

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cfg = PRESETS[kind](hidden_size=32, num_heads=4, num_hidden_layers=1,
                        intermediate_size=64, max_seq_len=64, bf16=False)
    trainer = build_trainer(kind, cfg, dev, steps_per_epoch=1)
    ds = LigandBindingSiteData(synthetic_complexes(n=4), None,
                               cfg.max_seq_len, cfg.pocket_ext)
    batch = to_device(next(ds.batches(4)), dev)
    step = trainer.capture(batch) if dev.type == "cuda" else trainer.train_step
    step(batch)
    (span,) = rec.spans("train.step")
    assert span.attrs["model"] == kind == trainer.MODEL
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert span.device_ms > 0
        step.close()
    else:
        assert span.device_ms is None
    trainer.eval_step(batch)
    (span,) = rec.spans("train.eval_step")
    assert span.attrs["model"] == kind


def test_graph_cache_counts_hits_misses_and_evictions():
    closed = []

    class Program:
        def close(self):
            closed.append(self)

    cache = GraphCache(maxsize=1)
    assert cache.stats() == {"hits": 0, "misses": 0, "evictions": 0}
    pin = object()
    assert cache.get("a", pin) is None
    first = Program()
    cache.put("a", first, pin)
    assert cache.get("a", pin) is first
    assert cache.get("a", object()) is None      # another model: a miss
    cache.put("b", Program(), pin)
    assert closed == [first]
    assert cache.stats() == {"hits": 1, "misses": 2, "evictions": 1}


def test_stats_endpoint_keeps_its_keys_and_adds_the_program_s(params, rec):
    server = DesignServer(_engine(params), port=0, max_wait_ms=5.0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    rec_ = _pocket(6, 5, 0)
    body = json.dumps({"pocket": {
        "sequence": "".join(rec_["amino_acid"][:6]),
        "angles": np.asarray(rec_["angle_features"][:6]).tolist(),
        "peptide_length": 5}}).encode()
    try:
        req = urllib.request.Request(base + "/design", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
        deadline = time.monotonic() + 10    # the handler closes its span
        while not rec.total("server.request")[0] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
    assert set(reply) == {"designs", "latency_ms"}
    batcher_keys = {"requests", "batches", "batched_slots", "errors",
                    "rejected", "queue_depth", "max_queue",
                    "mean_batch_occupancy"}
    assert batcher_keys | {"latency_ms_p50", "latency_ms_p95",
                           "latency_ms_p99", "queue_wait_ms_p95",
                           "inverse_fold", "graphs", "engine",
                           "telemetry"} == set(stats)
    assert batcher_keys <= set(stats["inverse_fold"])
    assert stats["graphs"] == {"hits": 0, "misses": 0, "evictions": 0}
    assert stats["engine"]["buckets"][0]["batches"] == 1
    tel = stats["telemetry"]
    for name in ("server.request", "server.featurize", "batcher.queue_wait",
                 "batcher.batch", "engine.batch", "structure.run",
                 "sequence.run"):
        assert tel[name]["count"] >= 1, name
    (request,) = rec.spans("server.request")
    assert request.attrs == {"route": "/design", "slots": 1, "status": 200}
    assert reply["latency_ms"] <= 1e3 * request.seconds
    (wait,) = rec.spans("batcher.queue_wait")
    assert wait.parent == request.id
