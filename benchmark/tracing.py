"""Digest of a torch.profiler Chrome trace: device busy time, idle share,
the device operations that took the most time, the longest idle gaps with
what the host was doing, and device time by kernel family.

The arithmetic of device events and their union is a frozen copy of
e3diff_tpu_torch/utils/profiling.py (DEVICE_CATEGORIES, device_events,
device_idle_share), kept here because later changes may edit the program.
"""

from __future__ import annotations

import bisect
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace: dict) -> list[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def digest(trace: dict, t0_us: float | None = None,
           t1_us: float | None = None) -> dict:
    """Busy and window seconds of the device over [t0, t1] (µs on the
    trace's clock; the device events' own extent when None), the idle
    share, the top device operations and the longest idle gaps, each
    gap named by the host operation that ran longest inside it."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in device_events(trace)]
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "gaps": []}
    every = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and "ts" in e]
    lo = min(s for s, _ in every) if t0_us is None else t0_us
    hi = max(e for _, e in every) if t1_us is None else t1_us
    clipped = [(max(s, lo), min(e, hi), n) for s, e, n in dev
               if e > lo and s < hi]
    merged = _union((s, e) for s, e, _ in clipped)
    busy = sum(e - s for s, e in merged)
    ops: dict[str, float] = {}
    for s, e, n in clipped:
        ops[n] = ops.get(n, 0.0) + (e - s)
    gaps = []
    edges = [lo] + [x for se in merged for x in se] + [hi]
    for i in range(0, len(edges) - 1, 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in (
                      "cpu_op", "user_annotation", "python_function",
                      "cuda_runtime", "cuda_driver"))
    starts = [h[0] for h in host]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        # the host op that fills most of the gap; an op that lasts more
        # than twice the gap (an enclosing scope) only where none else is
        over = []
        j = bisect.bisect_left(starts, s - 5e6)
        while j < len(host) and host[j][0] < e:
            hs, he, hn = host[j]
            overlap = min(he, e) - max(hs, s)
            if overlap > 0:
                over.append((he - hs > 2 * (e - s), -overlap, he - hs, hn))
            j += 1
        named.append([min(over)[3] if over else "host idle",
                      (e - s) * 1e-6])
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "ops": ops, "gaps": named}


def top_ops(ops: dict, n: int = 10) -> list:
    return [[name, us * 1e-6] for name, us in
            sorted(ops.items(), key=lambda kv: -kv[1])[:n]]


# the port's hand-written kernels by family (csrc/*.cu); the attention
# backward's table-gradient sum and dropout-bit kernel belong to attention,
# the column sum of the LayerNorm backward to LayerNorm
FAMILIES = {
    "attention": re.compile(r"\battention_\w*kernel\b|\btable_grad_sum_kernel"
                            r"\b|\bdropout_keep_kernel\b"),
    "layernorm": re.compile(r"\blayernorm_\w*kernel\b|\bcolumn_sum_kernel\b"),
}


def family_seconds(ops: dict, family: str) -> float:
    pat = FAMILIES[family]
    return sum(us for name, us in ops.items() if pat.search(name)) * 1e-6


def idle_share(run):
    """The device's idle share of a run's traced window, in %: 1 - the
    union of the device's kernels, copies and memsets over the window's
    length; None without a trace or a device event."""
    p = run.profile
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
