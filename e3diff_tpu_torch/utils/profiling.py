"""Device-time digest of a torch.profiler trace (counterpart of
e3diff_tpu/utils/xplane.py, which decodes jax.profiler's XSpace files).

``utils/timing.py::profiler_trace`` writes the Chrome-trace JSON that
``torch.profiler.profile.export_chrome_trace`` gives; this module reads
that JSON back, so a test can feed it a small hand-written trace:

    with profiler_trace(logdir) as path:
        run_steps()
    trace = load_trace(path)
    totals = device_op_totals(trace)     # {kernel: {"us": ..., "count": ...}}
    bucketize(totals, steps=N)           # {bucket: ms per step}
    roofline(totals, N, gemm_flops(trace))   # eager steps' host GEMM ops
    device_idle_share(trace)

Device work is the complete events ("ph" "X") of the categories in
DEVICE_CATEGORIES: kernels, copies and memsets, whether an eager call or
a CUDA graph's replay launched them.
"""

from __future__ import annotations

import json
import math
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's kernels (e3diff_tpu_torch/csrc), each a bucket of its own
PORT_KERNEL = re.compile(
    r"\b((?:attention|layernorm)_\w*?_kernel|column_sum_kernel"
    r"|table_grad_sum_kernel|dropout_keep_kernel)\b")

# first match wins; the random draws and the copies are launched through
# PyTorch's elementwise templates, so they come before "elementwise"
BUCKET_RULES = (
    ("gemm", re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitKreduce"
                        r"|^aten::(mm|addmm|bmm|baddbmm)$", re.IGNORECASE)),
    ("random", re.compile(r"distribution_|philox|random", re.IGNORECASE)),
    ("foreach", re.compile(r"multi_tensor_apply|lpnorm_cleanup")),
    ("copy_memset", re.compile(r"^Memcpy|^Memset|copy_kernel|FillFunctor"
                               r"|CatArrayBatchedCopy")),
    ("reduction", re.compile(r"reduce_kernel|Reduce|SoftMax|softmax")),
    ("elementwise", re.compile(r"elementwise", re.IGNORECASE)),
)

# the GEMM ops and the positions of their two factors among the operands'
# "Input Dims" (recorded with record_shapes): 2 M N K operations, times
# the batch
_GEMM_OPERANDS = {"aten::mm": (0, 1), "aten::addmm": (1, 2),
                  "aten::bmm": (0, 1), "aten::baddbmm": (1, 2)}


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def device_events(trace: dict) -> list[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def host_self_times(trace: dict) -> list[dict]:
    """The host's ``cpu_op`` events, each as {"name", "dur"} with its self
    time: its span less the spans of the ops it encloses on its thread
    (each microsecond counted once)."""
    by_thread: dict = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for events in by_thread.values():
        events.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []      # [end, self time, name] of the enclosing ops
        for e in events + [None]:
            start = math.inf if e is None else float(e["ts"])
            while stack and start >= stack[-1][0]:
                _, self_us, name = stack.pop()
                out.append({"name": name, "dur": self_us})
            if e is None:
                break
            dur = float(e.get("dur", 0))
            if stack:
                stack[-1][1] -= dur
            stack.append([start + dur, dur, e["name"]])
    return out


def device_op_totals(trace: dict) -> dict[str, dict]:
    """{op name: {"us": microseconds, "count": calls}}, the most expensive
    first: over every device event of the trace, or, where it has none (a
    CPU run, which is no device measurement), over host_self_times."""
    totals: dict[str, dict] = {}
    for e in device_events(trace) or host_self_times(trace):
        slot = totals.setdefault(e["name"], {"us": 0.0, "count": 0})
        slot["us"] += float(e.get("dur", 0.0))
        slot["count"] += 1
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]["us"]))


def bucket_of(name: str) -> str:
    """The bucket of a device op: "port:<kernel>" for the port's kernels,
    else the first of BUCKET_RULES whose pattern it matches, else
    "other"."""
    m = PORT_KERNEL.search(name)
    if m:
        return f"port:{m.group(1)}"
    for bucket, pattern in BUCKET_RULES:
        if pattern.search(name):
            return bucket
    return "other"


def bucketize(totals: dict, steps: int = 1) -> dict[str, float]:
    """Device milliseconds per step of each bucket, the largest first."""
    out: dict[str, float] = {}
    for name, info in totals.items():
        b = bucket_of(name)
        out[b] = out.get(b, 0.0) + info["us"]
    return {k: v / 1e3 / max(steps, 1)
            for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def top_ops(totals: dict, n: int = 15, steps: int = 1) -> list[tuple]:
    """The n most expensive device ops: (name, bucket, ms per step, calls
    per step, us per call)."""
    rows = sorted(totals.items(), key=lambda kv: -kv[1]["us"])[:n]
    s = max(steps, 1)
    return [(name, bucket_of(name), info["us"] / 1e3 / s,
             info["count"] / s, info["us"] / max(info["count"], 1))
            for name, info in rows]


def gemm_flops(trace: dict) -> float:
    """The floating-point operations of the GEMM ops (aten::mm, addmm,
    bmm, baddbmm) the host launched in the trace, from their operands'
    dimensions; 0 where the trace has none (a CUDA graph's replay launches
    no op from the host)."""
    total = 0.0
    for e in trace.get("traceEvents", []):
        at = _GEMM_OPERANDS.get(e.get("name"))
        dims = e.get("args", {}).get("Input Dims")
        if e.get("cat") != "cpu_op" or at is None or not dims:
            continue
        a, b = dims[at[0]], dims[at[1]]
        if len(a) >= 2 and len(b) >= 2:
            total += 2.0 * math.prod(a[:-1]) * a[-1] * b[-1]
    return total


def count_gemm_flops(fn):
    """Call ``fn()`` under torch's FlopCounterMode; returns its result and
    the floating-point operations of its GEMM ops (those of gemm_flops,
    forward and backward), counted as gemm_flops counts them. A CUDA
    graph's replay launches no op from the host, so a trace of replays has
    no GEMM shapes: its steps' count comes from here, taken in an eager
    call of the same step."""
    from torch.utils.flop_counter import FlopCounterMode

    gemms = {name.replace("::", ".") for name in _GEMM_OPERANDS}
    with FlopCounterMode(display=False) as counter:
        out = fn()
    counts = counter.get_flop_counts().get("Global", {})
    return out, float(sum(v for k, v in counts.items() if str(k) in gemms))


def roofline(totals: dict, steps: int = 1, flops: float = 0.0) -> dict:
    """The ops' ms per step (device ms, for a trace with device events),
    the GEMMs' ms per step and, given the GEMMs' ``flops`` over the same
    steps (gemm_flops), their achieved TFLOP/s (None without flops)."""
    s = max(steps, 1)
    total_us = sum(i["us"] for i in totals.values())
    gemm_us = sum(i["us"] for k, i in totals.items() if bucket_of(k) == "gemm")
    return {
        "ms_per_step": total_us / 1e3 / s,
        "gemm_ms_per_step": gemm_us / 1e3 / s,
        "gemm_tflops_per_s": (flops / (gemm_us * 1e-6) / 1e12
                              if flops and gemm_us else None),
    }


def device_idle_share(trace: dict) -> float:
    """1 - (the union of the device events' intervals) / (the trace's
    window, from its first event's start to its last event's end, host
    events included)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and "ts" in e]
    if not spans:
        return math.nan
    window = max(end for _, end in spans) - min(start for start, _ in spans)
    busy = 0.0
    cur_start = cur_end = None
    for start, end in sorted((float(e["ts"]), float(e["ts"])
                              + float(e.get("dur", 0.0)))
                             for e in device_events(trace)):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return 1.0 - busy / window if window > 0 else math.nan


def digest(trace: dict, steps: int, flops: float | None = None) -> dict:
    """What the train loop prints of a profiled epoch: whether the trace
    holds device events, the buckets in ms per step, the roofline and the
    device idle share (None for a CPU run). ``flops``: the GEMMs'
    operations over the trace's steps, where the trace cannot show them (a
    CUDA graph's replays; count_gemm_flops), else gemm_flops(trace)."""
    on_device = bool(device_events(trace))
    totals = device_op_totals(trace)
    if flops is None:
        flops = gemm_flops(trace)
    return {"on_device": on_device,
            "buckets": bucketize(totals, steps),
            "roofline": roofline(totals, steps, flops),
            "device_idle_share": (device_idle_share(trace) if on_device
                                  else None)}
