"""HTTP front-end for the design engine (counterpart of
e3diff_tpu/serving/server.py: the same routes, JSON schema and status
codes; stdlib only, no web framework).

Endpoints:
  GET  /healthz  -> {"ok": true} once the engine is warm (503 before)
  GET  /stats    -> micro-batcher counters + latency percentiles, and
                    "graphs" (the graph cache's hits, misses and
                    evictions), "engine" (device batches per bucket) and
                    "telemetry" (each span's count, mean and p95 ms)
  GET  /config   -> the engine's configuration and buckets
  POST /design   -> run the design pipeline for one request
  POST /inverse_fold -> sequences for a record's own backbone

POST /design body (JSON):
  {"record": {...}}                 a preprocessing-schema complex record
     or
  {"pocket": {"sequence": "ACDE...",        pocket residues, used verbatim
              "angles": [[8 floats]...],    (already-extended semantics)
              "peptide_length": 12}}
  "n_designs": 1,          independent candidates (parallel batch slots)
  "return_pdb": true,      include NERF-reconstructed backbone PDB text
  "return_angles": false   include raw generated angles

Response: {"designs": [{"sequence", "pdb"?, "angles"?, "recovery_rate"?},
           ...], "latency_ms": ...}; latency_ms is the request's
``server.request`` span so far, from reading the body to the reply.

Concurrency model: the ThreadingHTTPServer thread-per-request front-end
parses JSON and featurizes (and validates) each request; every device
interaction funnels through a MicroBatcher's worker thread (one for
design, one for inverse folding), which packs concurrent requests into
one fixed-shape batch that replays the bucket's captured programs (see
batcher.py and engine.py). Spans (utils/telemetry.py): ``server.request``
on the handler thread around each POST, ``server.featurize`` inside it.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from e3diff_tpu_torch.serving.batcher import MicroBatcher, QueueFullError
from e3diff_tpu_torch.serving.engine import DesignEngine, pocket_record
from e3diff_tpu_torch.utils import telemetry


class _HTTPServer(ThreadingHTTPServer):
    # a micro-batching server EXPECTS batch-sized bursts of simultaneous
    # connects; socketserver's default accept backlog of 5 RSTs the rest
    # (measured: 64 concurrent clients -> ConnectionResetError). Size the
    # backlog to several full batches.
    request_queue_size = 256
    daemon_threads = True


def _record_from_json(payload: dict) -> dict:
    if "record" in payload:
        rec = dict(payload["record"])
        for k in ("angle_features", "numerical_features"):
            if k in rec:
                rec[k] = np.asarray(rec[k], np.float32)
        for k in ("ligand_mask", "pocket_mask"):
            if k in rec:
                rec[k] = np.asarray(rec[k], bool)
        return rec
    if "pocket" in payload:
        p = payload["pocket"]
        return pocket_record(p["sequence"],
                             np.asarray(p["angles"], np.float32),
                             int(p["peptide_length"]))
    raise ValueError("request needs a 'record' or a 'pocket'")


class DesignServer:
    """Owns the engine + batcher and serves HTTP on (host, port)."""

    def __init__(self, engine: DesignEngine, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 25.0,
                 linger_ms: float = 2.0,
                 request_timeout_s: float = 600.0,
                 max_queue: int | None = None):
        self.engine = engine
        self.request_timeout_s = request_timeout_s
        # items are (pre-featurized slot, want_pdb): featurization and
        # its validation run in the HTTP request threads, so an invalid
        # request fails alone (and n_designs featurizes once) instead of
        # poisoning every request coalesced into its batch.
        # max_queue (default 4 x batch) bounds each queue: overload gets
        # an immediate 429 + Retry-After instead of a 600 s timeout.
        self.batcher = MicroBatcher(
            lambda items: engine.design_slots(
                [s for s, _ in items],
                return_pdb=[w for _, w in items]),
            max_batch=engine.batch_size, max_wait_ms=max_wait_ms,
            linger_ms=linger_ms, max_queue=max_queue, name="design")
        # inverse folding runs a different device program (sequence
        # sampler only), so it coalesces in its own queue; the engine's
        # device lock serializes the two programs on the card
        self.if_batcher = MicroBatcher(
            engine.inverse_fold_slots,
            max_batch=engine.batch_size, max_wait_ms=max_wait_ms,
            linger_ms=linger_ms, max_queue=max_queue, name="inverse_fold")
        self._httpd = _HTTPServer((host, port), self._make_handler())
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        """Serve on a background thread (returns immediately)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="e3diff-torch-http")
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self.batcher.shutdown()
        self.if_batcher.shutdown()

    # ------------------------------------------------------------------
    def _handle_design(self, payload: dict, request) -> dict:
        record = _record_from_json(payload)
        n = int(payload.get("n_designs", 1))
        if not 1 <= n <= 4 * self.engine.batch_size:
            raise ValueError(
                f"n_designs must be in [1, {4 * self.engine.batch_size}]")
        request.attrs["slots"] = n
        want_pdb = bool(payload.get("return_pdb", True))
        # featurize (and validate) here, once per request; per-request
        # CFG scales need a CFG-enabled engine (else 400)
        with telemetry.span("server.featurize"):
            slot = self.engine.featurize(
                record, guidance_scale=payload.get("guidance_scale"),
                seq_guidance_scale=payload.get("seq_guidance_scale"))
        futures = self.batcher.submit_many([(slot, want_pdb)] * n)
        results = [f.result(timeout=self.request_timeout_s)
                   for f in futures]
        designs = []
        for r in results:
            d = {"sequence": r.sequence}
            if want_pdb and r.pdb is not None:
                d["pdb"] = r.pdb
            if payload.get("return_angles", False):
                d["angles"] = np.asarray(r.angles).tolist()
            if r.recovery_rate is not None:
                d["recovery_rate"] = r.recovery_rate
            designs.append(d)
        return {"designs": designs,
                "latency_ms": 1e3 * (time.monotonic() - request.t0)}

    def _handle_inverse_fold(self, payload: dict, request) -> dict:
        """Design sequences for the record's OWN backbone angles (no
        structure sampling) — POST /inverse_fold {"record": {...},
        "n_samples": k}. "guidance_scale" here means the SEQUENCE
        sampler's CFG scale (the only sampler this endpoint runs)."""
        record = _record_from_json(payload)
        n = int(payload.get("n_samples", 1))
        if not 1 <= n <= 4 * self.engine.batch_size:
            raise ValueError(
                f"n_samples must be in [1, {4 * self.engine.batch_size}]")
        request.attrs["slots"] = n
        with telemetry.span("server.featurize"):
            slot = self.engine.featurize(
                record, seq_guidance_scale=payload.get("guidance_scale"))
        futures = self.if_batcher.submit_many([slot] * n)
        results = [f.result(timeout=self.request_timeout_s)
                   for f in futures]
        out = []
        for r in results:
            d = {"sequence": r.sequence}
            if r.recovery_rate is not None:
                d["recovery_rate"] = r.recovery_rate
            out.append(d)
        return {"sequences": out,
                "latency_ms": 1e3 * (time.monotonic() - request.t0)}

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet by default
                pass

            def _reply(self, code: int, obj: dict, headers: dict = None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    ok = server.engine.ready
                    self._reply(200 if ok else 503, {"ok": ok})
                elif self.path == "/stats":
                    stats = server.batcher.stats()
                    stats["inverse_fold"] = server.if_batcher.stats()
                    stats["graphs"] = server.engine.graphs.stats()
                    stats["engine"] = server.engine.stats()
                    stats["telemetry"] = telemetry.recorder().summary()
                    self._reply(200, stats)
                elif self.path == "/config":
                    import dataclasses as dc

                    eng = server.engine
                    self._reply(200, {
                        "experiment": dc.asdict(eng.cfg),
                        "batch_size": eng.batch_size,
                        "ligand_buckets": eng.ligand_buckets,
                        "receptor_buckets": eng.receptor_buckets,
                        "batch_buckets": eng.batch_buckets,
                        "guidance_scale": eng.guidance_scale,
                        "seq_guidance_scale": eng.seq_guidance_scale,
                        "cfg_enabled": {"structure": eng._struct_guided,
                                        "sequence": eng._seq_guided},
                        "structure_timesteps":
                            eng.structure_diffusion.timesteps,
                        "sequence_timesteps": eng.sequence_d3pm.timesteps,
                    })
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                routes = {"/design": server._handle_design,
                          "/inverse_fold": server._handle_inverse_fold}
                handler = routes.get(self.path)
                if handler is None:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                with telemetry.span("server.request",
                                    route=self.path) as request:
                    code, body, headers = self._answer(handler, request)
                    request.attrs["status"] = code
                    self._reply(code, body, headers)

            def _answer(self, handler, request):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    return 200, handler(payload, request), None
                except QueueFullError as exc:
                    # overload backpressure: reject fast + retryable
                    # rather than queueing toward a slow timeout
                    return 429, {"error": str(exc),
                                 "retry_after_s": exc.retry_after_s}, {
                        "Retry-After": str(max(1, round(
                            exc.retry_after_s)))}
                except (ValueError, KeyError, TypeError) as exc:
                    return 400, {"error": str(exc)}, None
                except Exception as exc:  # noqa: BLE001 — surface as 500
                    return 500, {"error": str(exc)}, None

        return Handler
