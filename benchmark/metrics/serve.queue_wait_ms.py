"""95th percentile, in ms, of the window's /design requests' waits in the
serving batcher's queue, from the enqueue to the dispatch of the
request's last slot (the program's ``batcher.queue_wait`` spans of the
``design`` batcher)."""

from benchmark import spans


def read(run):
    return spans.p95_ms([s for s in spans.records(run, "batcher.queue_wait")
                         if s.attrs.get("batcher") == "design"])
