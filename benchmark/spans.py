"""The program's own spans (e3diff_tpu_torch/utils/telemetry.py) over a
run's window, for the per-layer metrics that read them.

The window starts when the timed window does (``run.t0 + run.setup_s``,
time.monotonic, the clock of the program's spans) and ends ``run.seconds``
later; where the traffic mix traces the end of the window (``trace_s``),
it ends where the trace starts, ``trace_end_s + trace_s`` before that
end, since the profiler's start and stop distort the calls around them.
A reader takes the records of one name that lie inside the window, in
the run's own process, once the cell has run. A program that records no
spans gives no record, and every reader then reads None.
"""

from __future__ import annotations

import math
import statistics


def window(run) -> tuple[float, float]:
    lo = run.t0 + run.setup_s
    hi = lo + run.seconds
    if "trace_s" in run.mix:
        hi -= run.mix.get("trace_end_s", 0.0) + run.mix["trace_s"]
    return lo, hi


def records(run, name: str) -> list:
    """The program's spans of ``name`` inside the run's window; none where
    the program has no recorder."""
    try:
        from e3diff_tpu_torch.utils import telemetry
    except ImportError:
        return []
    lo, hi = window(run)
    return telemetry.recorder().spans(name, lo, hi)


def mean_ms(spans) -> float | None:
    return 1e3 * sum(s.seconds for s in spans) / len(spans) if spans else None


def median_ms(spans) -> float | None:
    return 1e3 * statistics.median(s.seconds for s in spans) if spans else None


def p95_ms(spans) -> float | None:
    if not spans:
        return None
    v = sorted(s.seconds for s in spans)
    return 1e3 * v[max(0, math.ceil(0.95 * len(v)) - 1)]


def device_mean_ms(spans) -> float | None:
    """Mean device ms of the spans that timed the card, leaving out the
    calls that captured their program."""
    ms = [s.device_ms for s in spans if not s.attrs.get("captured")]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
