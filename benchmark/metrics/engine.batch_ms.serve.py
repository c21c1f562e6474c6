"""Mean host milliseconds of a ``DesignEngine.design_slots`` call in the
window, from the span the benchmark places around each call."""


def read(run):
    spans = run.spans.get("engine.design_slots")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
