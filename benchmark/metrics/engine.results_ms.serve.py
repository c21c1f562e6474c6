"""Mean host ms per device batch that the design engine takes to build
the PDB text and the result records after the read-back (the program's
``engine.results`` spans)."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.records(run, "engine.results"))
