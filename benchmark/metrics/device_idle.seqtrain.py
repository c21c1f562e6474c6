"""The device's idle share of the traced window, in %: 1 - the union of
the device's kernels, copies and memsets over the window's length
(benchmark/tracing.py::idle_share)."""

from benchmark.tracing import idle_share as read  # noqa: F401
