"""The layernorm kernels' share of their roofline in the traced sequence
train steps, in %: the least time the card could take for every
layernorm call of those steps, forward and backward, at their shapes,
over the device time of the layernorm kernels in the trace
(benchmark/flops_seq.py)."""

from benchmark import flops_seq


def read(run):
    return flops_seq.train_roofline(run, "layernorm")
