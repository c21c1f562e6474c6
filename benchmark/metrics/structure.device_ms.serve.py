"""Mean device ms of the structure sampler's calls in the window, between
the CUDA events of the program's ``structure.run`` spans; calls that
captured their program are left out."""

from benchmark import spans


def read(run):
    return spans.device_mean_ms(spans.records(run, "structure.run"))
