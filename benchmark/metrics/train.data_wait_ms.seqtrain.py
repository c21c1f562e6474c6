"""Mean host ms a sequence train step of the window waited for its batch
from the prefetch thread (the program's ``train.data_wait`` spans, one
per batch pulled)."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.records(run, "train.data_wait"))
