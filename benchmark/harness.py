"""What every cell's run shares: the run's context (its spans, counters,
readings and trace), the card's description, the weights handed to the
program, the profiler window and the result line."""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "e3diff_tpu")


class Run:
    """One run of one cell."""

    def __init__(self, args, t0: float, bench: dict, cell: dict,
                 config: dict, spec: dict, mix: dict, device):
        self.args, self.t0 = args, t0
        self.bench, self.cell, self.config = bench, cell, config
        self.spec, self.mix = spec, mix        # the cell's file, its traffic
        self.device = device
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.control = getattr(args, "control", "none")
        self.spans: dict[str, list[float]] = {}
        self.counters: dict[str, float] = {}
        self.readings: dict[str, dict] = {}
        self.metrics: dict[str, float] = {}
        self.attempted = self.failed = 0
        self.profile: dict | None = None     # tracing.digest of the window
        self.facts: dict = {}                 # shapes and counts readers use
        self.memory_peak = 0
        self.setup_s = math.nan

    def seed_for(self, what: str) -> int:
        """A stream of its own for each use of the run's seed."""
        h = 1469598103934665603
        for ch in f"{self.seed}:{what}":
            h = ((h ^ ord(ch)) * 1099511628211) % (1 << 63)
        return h

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t)

    def read(self, name: str, value: float) -> None:
        """A number compared with the reference, held to the cell's limit
        (a missing limit fails)."""
        limit = self.spec.get("limits", {}).get(name)
        self.readings[name] = {"value": float(value),
                               "limit": None if limit is None else float(limit)}

    def correct(self) -> bool:
        return bool(self.readings) and all(
            r["limit"] is not None and math.isfinite(r["value"])
            and r["value"] <= r["limit"] for r in self.readings.values())


def device_info(torch, device, count: int) -> dict:
    if device.type != "cuda":     # the CPU tests' runs: no device metric
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the kernels' own library already builds into
    e3diff_tpu_torch/_build/)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


class Profiler:
    """torch.profiler over the device and the host between ``start`` and
    ``stop`` (each synchronizes the card first, so ``seconds`` is the
    traced stretch of the window); ``finish``, after the window, writes
    the Chrome trace to TMPDIR, reads it back, deletes it and keeps its
    digest in ``run.profile``. Inert unless the run traces."""

    def __init__(self, run: Run, torch):
        self.run, self.torch, self.prof = run, torch, None
        self.activities = [torch.profiler.ProfilerActivity.CPU,
                           torch.profiler.ProfilerActivity.CUDA]
        self.seconds = 0.0
        self._t = None

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def warm(self):
        """Initialise the profiler's device tracing in set-up, so that
        ``start`` in the window does not pay for it."""
        if not self.run.trace or not self.torch.cuda.is_available():
            return
        t = self.torch
        with t.profiler.profile(activities=self.activities):
            (t.ones(8, device="cuda") * 2).sum().item()

    def start(self):
        if not self.run.trace or self.prof is not None:
            return
        self._sync()
        self.prof = self.torch.profiler.profile(activities=self.activities)
        self.prof.start()
        self._t = time.perf_counter()

    def stop(self):
        if self.prof is None or self._t is None:
            return
        self._sync()
        self.prof.stop()
        self.seconds = time.perf_counter() - self._t
        self._t = None

    def finish(self):
        if self.prof is None:
            return
        import tempfile

        from benchmark import tracing

        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.run.profile = tracing.digest(trace)


def result_line(run: Run, torch, count: int) -> dict:
    from benchmark import tracing

    names = [m for m in (run.bench["end_to_end"] if not run.trace
                         else run.bench["per_layer"])
             if run.cell["name"] in m.get("workloads", [run.cell["name"]])]
    metrics = {m["name"]: {"value": run.metrics[m["name"]], "unit": m["unit"]}
               for m in names if run.metrics.get(m["name"]) is not None}
    device = device_info(torch, run.device, count)
    device["memory_peak_bytes"] = int(run.memory_peak)
    if run.device.type == "cuda":
        device["power"] = power_limit()
    out = {"correct": run.correct(), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": tracing.top_ops(run.profile["ops"]),
                            "idle_gaps": run.profile["gaps"][:10]}
    out["checks"] = run.readings
    return out
