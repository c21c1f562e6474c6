"""The layernorm kernels' share of their roofline in the traced batch, in
%: the least time the card could take for the batch's layernorm calls (the
pocket encoding once, one decode a step) at their shapes (the larger of
operations over 989 TFLOP/s and bytes over 3.35 TB/s), over the device
time of the layernorm kernels in the trace (benchmark/flops.py)."""

from benchmark import flops


def read(run):
    return flops.sample_roofline(run, "layernorm")
