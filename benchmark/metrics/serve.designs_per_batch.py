"""Designs per device batch of the serving batcher over the window: the
change of its ``batched_slots`` over the change of its ``batches``
(``MicroBatcher.stats()``, read before and after the window)."""


def read(run):
    c = run.counters
    if not c.get("batches"):
        return None
    return c["batched_slots"] / c["batches"]
