"""Median host ms of the structure sampler's call per batch of the
window: its draws, copies and 1000 replays enqueued (the program's
``structure.run`` spans); the median keeps the one traced batch out."""

from benchmark import spans


def read(run):
    return spans.median_ms(spans.records(run, "structure.run"))
