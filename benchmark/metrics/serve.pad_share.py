"""Share, in %, of the window's device-batch ligand positions that no
slot fills: 100 x (1 - the positions used / the batch bucket x the
ligand bucket), summed over the program's ``engine.batch`` spans."""

from benchmark import spans


def read(run):
    batches = spans.records(run, "engine.batch")
    offered = sum(s.attrs["batch"] * s.attrs["ligand"] for s in batches)
    if not offered:
        return None
    used = sum(s.attrs["positions"] for s in batches)
    return 100.0 * (1.0 - used / offered)
