"""The attention kernels' share of their roofline in the traced sequence
train steps, in %: the least time the card could take for every
attention call of those steps (self-attention with the table,
cross-attention to the receptor memory), forward and backward, at their
shapes, over the device time of the attention kernels in the trace
(benchmark/flops_seq.py)."""

from benchmark import flops_seq


def read(run):
    return flops_seq.train_roofline(run, "attention")
