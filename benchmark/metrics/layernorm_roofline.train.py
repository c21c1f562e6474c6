"""The layernorm kernels' share of their roofline in the traced train
steps, in %: the least time the card could take for every layernorm call
of those steps, forward and backward, at their shapes (the larger of
operations over 989 TFLOP/s and bytes over 3.35 TB/s), over the device
time of the layernorm kernels in the trace (benchmark/flops.py)."""

from benchmark import flops


def read(run):
    return flops.train_roofline(run, "layernorm")
