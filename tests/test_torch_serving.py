"""The port's serving layer on the CPU: ``MicroBatcher`` and ``DesignServer``
against the JAX package's (tests/test_serving.py's cases that need no
mesh). The batcher cases run on both packages' batchers with the same
assertions: coalescing and order, errors, linger, the bounded queue,
``submit_many`` and the unbounded opt-out. Every server case sends the
same requests to a port server over the tiny engine of
test_torch_engine.py (hidden 32, 4 heads, 2 layers, DDIM-3, D3PM over 6
steps) and to a JAX server over a tiny JAX engine with the same weights,
and holds the two to the same status codes and the same JSON keys (the
same nesting and list lengths, and the same JSON types); ``/config``'s
``experiment`` differs only by the JAX config's ``scan_layers``, which
the port leaves out.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from e3diff_tpu.serving import DesignEngine as JEngine
from e3diff_tpu.serving import DesignServer as JServer
from e3diff_tpu.serving import MicroBatcher as JMicroBatcher
from e3diff_tpu.serving.batcher import QueueFullError as JQueueFullError

from e3diff_tpu_torch.data import synthetic_complexes
from e3diff_tpu_torch.data.dataset import AA_VOCAB
from e3diff_tpu_torch.serving import (
    DesignEngine,
    DesignServer,
    MicroBatcher,
    QueueFullError,
)
from tests.test_torch_engine import (  # noqa: F401  (params: a fixture)
    _engine,
    _jax_engine,
    _pocket,
    params,
)

BATCHERS = [pytest.param((MicroBatcher, QueueFullError), id="port"),
            pytest.param((JMicroBatcher, JQueueFullError), id="jax")]
JAX_ONLY_CONFIG = {"scan_layers"}
# what the port's GET /stats adds to the JAX server's keys: the batcher's
# queue-wait percentile, and the graph cache's, engine's and span
# recorder's counters
PORT_ONLY_STATS = {"queue_wait_ms_p95", "graphs", "engine", "telemetry"}


# ---------------------------------------------------------------- batcher

@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_coalesces_and_orders(kind):
    calls = []

    def run(items):
        calls.append(len(items))
        time.sleep(0.01)
        return [x * 10 for x in items]

    b = kind[0](run, max_batch=8, max_wait_ms=30.0)
    futs = [b.submit(i) for i in range(20)]
    assert [f.result(timeout=5) for f in futs] == [i * 10 for i in range(20)]
    stats = b.stats()
    assert stats["requests"] == 20
    assert stats["batches"] == len(calls) < 20
    assert max(calls) <= 8
    assert stats["mean_batch_occupancy"] > 1.0
    assert stats["latency_ms_p50"] > 0
    b.shutdown()


@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_propagates_errors_and_recovers(kind):
    def run(items):
        if any(x < 0 for x in items):
            raise RuntimeError("boom")
        return items

    b = kind[0](run, max_batch=4, max_wait_ms=5.0)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(-1).result(timeout=5)
    assert b.submit(3).result(timeout=5) == 3   # the worker survived
    assert b.stats()["errors"] == 1
    b.shutdown()
    with pytest.raises(RuntimeError):
        b.submit(1)


@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_linger(kind):
    """A lone request dispatches after one linger gap, not the whole
    window; a back-to-back burst of max_batch still coalesces into one
    batch; a negative linger clamps to 0."""
    mb = kind[0](lambda items: list(items), max_batch=8,
                 max_wait_ms=2000.0, linger_ms=5.0)
    try:
        t0 = time.monotonic()
        assert mb.submit("only").result(timeout=10.0) == "only"
        assert time.monotonic() - t0 < 1.0
    finally:
        mb.shutdown()
    batches = []
    mb = kind[0](lambda items: (batches.append(list(items)), list(items))[1],
                 max_batch=8, max_wait_ms=2000.0, linger_ms=200.0)
    try:
        futs = [mb.submit(i) for i in range(8)]
        assert [f.result(timeout=10.0) for f in futs] == list(range(8))
        assert len(batches) == 1 and len(batches[0]) == 8
    finally:
        mb.shutdown()
    mb = kind[0](lambda items: list(items), max_batch=8, max_wait_ms=100.0,
                 linger_ms=-3.0)
    try:
        assert mb._linger_s == 0.0
        assert mb.submit("x").result(timeout=10.0) == "x"
    finally:
        mb.shutdown()


@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_bounded_queue_rejects_and_recovers(kind):
    batcher, full = kind
    gate = threading.Event()

    def run(items):
        gate.wait(timeout=10)
        return list(items)

    mb = batcher(run, max_batch=2, max_wait_ms=1.0, max_queue=4)
    try:
        first = mb.submit("w")
        time.sleep(0.1)                  # the worker holds it at the gate
        accepted = [mb.submit(i) for i in range(4)]
        with pytest.raises(full) as exc:
            mb.submit("overflow")
        assert exc.value.retry_after_s > 0
        assert mb.stats()["rejected"] == 1
        assert mb.stats()["queue_depth"] <= 4
        gate.set()
        assert first.result(timeout=10) == "w"
        assert [f.result(timeout=10) for f in accepted] == list(range(4))
        assert mb.submit("after").result(timeout=10) == "after"
    finally:
        gate.set()
        mb.shutdown()


@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_submit_many_is_atomic(kind):
    batcher, full = kind
    gate = threading.Event()
    mb = batcher(lambda items: (gate.wait(10), list(items))[1], max_batch=2,
                 max_wait_ms=1.0, max_queue=4)
    try:
        mb.submit("w")
        time.sleep(0.1)
        mb.submit_many([1, 2])
        depth = mb.stats()["queue_depth"]
        with pytest.raises(full):
            mb.submit_many([3, 4, 5])
        assert mb.stats()["queue_depth"] == depth
        assert mb.stats()["rejected"] == 3
        futs = mb.submit_many([6, 7])
        gate.set()
        assert [f.result(timeout=10) for f in futs] == [6, 7]
    finally:
        gate.set()
        mb.shutdown()


@pytest.mark.parametrize("kind", BATCHERS)
def test_microbatcher_unbounded_opt_out(kind):
    mb = kind[0](lambda items: list(items), max_batch=2, max_wait_ms=1.0,
                 max_queue=0)
    try:
        futs = [mb.submit(i) for i in range(64)]
        assert [f.result(timeout=10) for f in futs] == list(range(64))
        assert mb.stats()["rejected"] == 0 and mb.stats()["max_queue"] == 0
    finally:
        mb.shutdown()


def test_concurrent_submitters_lose_no_request():
    """More submitting threads than cores, with a short switch interval:
    every request gets its own answer and the counters add up."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    b = MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=16,
                     max_wait_ms=2.0, max_queue=0)
    out = {}
    try:
        def client(i):
            out[i] = b.submit(i).result(timeout=10)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.shutdown()
    assert out == {i: i + 1 for i in range(64)}
    stats = b.stats()
    assert stats["requests"] == stats["batched_slots"] == 64


# ----------------------------------------------------------------- server

@pytest.fixture(scope="module")
def engines(params):
    """A port engine and a JAX engine with the same weights, batch 4, and
    a CFG-enabled pair; the JAX engines compile once, on first use."""
    return {"plain": (_engine(params), _jax_engine(params)),
            "cfg": (_engine(params, enable_cfg=True),
                    _jax_engine(params, enable_cfg=True))}


def _twins(pair, **kw):
    """Fresh engines over the same models (the JAX one reuses its compiled
    samplers): not warm, with no patched method."""
    eng, jeng = pair
    port = DesignEngine(eng.cfg, eng.structure_model, eng.structure_diffusion,
                        eng.sequence_model, eng.sequence_d3pm, device="cpu",
                        batch_size=eng.batch_size, sampler="ddim",
                        ddim_steps=3, **kw)
    jax_ = JEngine(jeng.cfg, jeng.structure_model, jeng.structure_params,
                   jeng.structure_diffusion, jeng.sequence_model,
                   jeng.sequence_params, jeng.sequence_d3pm,
                   batch_size=jeng.batch_size, sampler="ddim", ddim_steps=3,
                   **kw)
    return port, jax_


def _warm(port, jax_):
    port.warmup(generator=torch.Generator().manual_seed(0))
    jax_.warmup(key=jax.random.PRNGKey(0))


class _Pair:
    """A port server and a JAX server; ``ask`` sends one request to both
    and returns the port's (code, body, headers) after holding its code
    and JSON keys to the JAX server's."""

    def __init__(self, port_engine, jax_engine, **kw):
        self.servers = (DesignServer(port_engine, port=0, **kw),
                        JServer(jax_engine, port=0, **kw))
        for s in self.servers:
            s.start()

    def url(self, i, path):
        return f"http://127.0.0.1:{self.servers[i].port}{path}"

    def ask(self, method, path, payload=None, config=False):
        got = [_http(method, self.url(i, path), payload) for i in (0, 1)]
        (code, body, headers), (jcode, jbody, jheaders) = got
        assert code == jcode, (path, body, jbody)
        if config:
            assert set(body["experiment"]) == (set(jbody["experiment"])
                                               - JAX_ONLY_CONFIG)
            body = dict(body, experiment=None)
            jbody = dict(jbody, experiment=None)
        if path == "/stats":
            assert {"graphs", "engine", "telemetry"} <= set(body)
            body = {k: v for k, v in body.items()
                    if k not in PORT_ONLY_STATS}
            body["inverse_fold"] = {k: v for k, v in
                                    body["inverse_fold"].items()
                                    if k not in PORT_ONLY_STATS}
        assert _schema(body) == _schema(jbody), (path, body, jbody)
        assert ("Retry-After" in headers) == ("Retry-After" in jheaders)
        return code, got[0][1], headers

    def shutdown(self):
        for s in self.servers:
            s.shutdown()


def _schema(obj):
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_schema(v) for v in obj]
    return type(obj).__name__


def _http(method, url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _pocket_payload(n_pocket=6, peptide_length=7, seed=0, **kw):
    rec = _pocket(n_pocket, peptide_length, seed)
    return {"pocket": {"sequence": "".join(rec["amino_acid"][:n_pocket]),
                       "angles": np.asarray(
                           rec["angle_features"][:n_pocket]).tolist(),
                       "peptide_length": peptide_length}, **kw}


def test_server_end_to_end(engines):
    port, jax_ = _twins(engines["plain"])
    pair = _Pair(port, jax_, max_wait_ms=5.0)
    try:
        code, body, _ = pair.ask("GET", "/healthz")
        assert code == 503 and body["ok"] is False
        _warm(port, jax_)
        code, body, _ = pair.ask("GET", "/healthz")
        assert code == 200 and body["ok"] is True
        code, body, _ = pair.ask("POST", "/design", _pocket_payload(
            n_designs=2, return_angles=True))
        assert code == 200 and len(body["designs"]) == 2
        for d in body["designs"]:
            assert len(d["sequence"]) == 7 and set(d["sequence"]) <= set(AA_VOCAB)
            assert d["pdb"].startswith("ATOM")
            assert np.asarray(d["angles"]).shape == (7, 8)
            assert "recovery_rate" not in d
        assert body["latency_ms"] > 0
        code, body, _ = pair.ask("POST", "/design", {"n_designs": 1})
        assert code == 400 and "error" in body
        assert pair.ask("GET", "/nope")[0] == 404
        assert pair.ask("POST", "/nope", {})[0] == 404
        code, body, _ = pair.ask("GET", "/stats")
        assert code == 200 and body["batches"] >= 1
    finally:
        pair.shutdown()


def test_server_invalid_request_is_a_400_not_a_batch_poison(engines):
    pair = _Pair(*_twins(engines["plain"]), max_wait_ms=5.0)
    try:
        code, body, _ = pair.ask("POST", "/design", _pocket_payload(
            peptide_length=40))
        assert code == 400 and "serving shapes" in body["error"]
        code, body, _ = pair.ask("POST", "/design", _pocket_payload())
        assert code == 200 and len(body["designs"][0]["sequence"]) == 7
        assert pair.servers[0].batcher.stats()["errors"] == 0
    finally:
        pair.shutdown()


def test_server_device_failure_is_a_500(engines):
    port, jax_ = _twins(engines["plain"])

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    port.design_slots = jax_.design_slots = broken
    pair = _Pair(port, jax_, max_wait_ms=1.0)
    try:
        code, body, _ = pair.ask("POST", "/design", _pocket_payload())
        assert code == 500 and "device lost" in body["error"]
    finally:
        pair.shutdown()


def test_server_inverse_fold_endpoint(engines):
    pair = _Pair(*_twins(engines["plain"]), max_wait_ms=5.0)
    rec = synthetic_complexes(n=1, seed=8, receptor_len_range=(8, 12),
                              ligand_len_range=(5, 8))[0]
    payload = {"record": {
        "amino_acid": list(rec["amino_acid"]),
        "angle_features": np.asarray(rec["angle_features"]).tolist(),
        "ligand_mask": np.asarray(rec["ligand_mask"]).astype(int).tolist(),
        "pocket_mask": np.asarray(rec["pocket_mask"]).astype(int).tolist(),
    }, "n_samples": 3}
    try:
        code, body, _ = pair.ask("POST", "/inverse_fold", payload)
        assert code == 200 and len(body["sequences"]) == 3
        want_len = int(np.asarray(rec["ligand_mask"]).sum())
        for d in body["sequences"]:
            assert len(d["sequence"]) == want_len
            assert 0.0 <= d["recovery_rate"] <= 1.0
        code, body, _ = pair.ask("GET", "/stats")
        assert body["inverse_fold"]["batches"] >= 1
        code, body, _ = pair.ask("POST", "/inverse_fold",
                                 dict(payload, n_samples=0))
        assert code == 400
    finally:
        pair.shutdown()


def test_server_config_endpoint(engines):
    pair = _Pair(*_twins(engines["plain"]))
    try:
        code, body, _ = pair.ask("GET", "/config", config=True)
        assert code == 200 and body["batch_size"] == 4
        assert body["experiment"]["ligand_max_len"] == 16
        assert body["structure_timesteps"] == 8
        assert body["sequence_timesteps"] == 6
        assert body["cfg_enabled"] == {"structure": False, "sequence": False}
    finally:
        pair.shutdown()


def test_server_per_request_guidance_scale(engines):
    port, jax_ = _twins(engines["cfg"], enable_cfg=True)
    pair = _Pair(port, jax_, max_wait_ms=5.0)
    try:
        _warm(port, jax_)
        code, body, _ = pair.ask("POST", "/design", _pocket_payload(
            guidance_scale=2.5, seq_guidance_scale=1.5, return_pdb=False))
        assert code == 200 and len(body["designs"][0]["sequence"]) == 7
        assert "pdb" not in body["designs"][0]
        code, body, _ = pair.ask("GET", "/config", config=True)
        assert body["cfg_enabled"] == {"structure": True, "sequence": True}
    finally:
        pair.shutdown()


def test_server_guidance_scale_rejected_without_cfg(engines):
    pair = _Pair(*_twins(engines["plain"]), max_wait_ms=5.0)
    try:
        code, body, _ = pair.ask("POST", "/design", _pocket_payload(
            guidance_scale=2.5))
        assert code == 400 and "CFG-enabled" in body["error"]
    finally:
        pair.shutdown()


def _gated(engine, gate):
    real = engine.design_slots

    def gated(slots, **kw):
        gate.wait(timeout=30)
        return real(slots, **kw)

    engine.design_slots = gated


def test_server_overload_returns_429_with_retry_after(engines):
    """A full queue answers at once with 429 and Retry-After; the accepted
    requests all complete; /stats counts the rejection."""
    port, jax_ = _twins(engines["plain"])
    _warm(port, jax_)
    gate = threading.Event()
    for eng in (port, jax_):
        _gated(eng, gate)
    pair = _Pair(port, jax_, max_wait_ms=1.0, max_queue=2)
    payload = _pocket_payload(return_pdb=False)
    results = [[], []]

    def client(i):
        results[i].append(_http("POST", pair.url(i, "/design"), payload)[0])

    try:
        threads = []
        for _ in range(3):    # one held by the worker, two fill the queue
            for i in (0, 1):
                threads.append(threading.Thread(target=client, args=(i,)))
                threads[-1].start()
            time.sleep(0.2)
        t0 = time.monotonic()
        code, body, headers = pair.ask("POST", "/design", payload)
        assert time.monotonic() - t0 < 5.0
        assert code == 429 and int(headers["Retry-After"]) >= 1
        assert "queue full" in body["error"] and body["retry_after_s"] > 0
        code, stats, _ = pair.ask("GET", "/stats")
        assert stats["rejected"] >= 1
        assert stats["queue_depth"] <= stats["max_queue"] == 2
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert results == [[200, 200, 200], [200, 200, 200]]
    finally:
        gate.set()
        pair.shutdown()


def test_server_multi_slot_request_rejects_whole(engines):
    port, jax_ = _twins(engines["plain"])
    gate = threading.Event()
    for eng in (port, jax_):
        _gated(eng, gate)
    pair = _Pair(port, jax_, max_wait_ms=1.0, max_queue=3)
    threads = []

    def send(n):
        for i in (0, 1):
            threads.append(threading.Thread(target=_http, args=(
                "POST", pair.url(i, "/design"),
                _pocket_payload(n_designs=n, return_pdb=False))))
            threads[-1].start()
        time.sleep(0.3)

    try:
        send(1)                            # the worker holds it at the gate
        send(2)                            # 2 of 3 queue slots used
        code, _, _ = pair.ask("POST", "/design",
                              _pocket_payload(n_designs=2, return_pdb=False))
        assert code == 429
        code, stats, _ = pair.ask("GET", "/stats")
        assert stats["queue_depth"] == 2   # the rejected request left none
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        gate.set()
        pair.shutdown()
