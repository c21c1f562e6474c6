"""Mean host ms per device batch that the design engine takes to stack
the slots and copy them to page-locked memory (the program's
``engine.inputs`` spans)."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.records(run, "engine.inputs"))
