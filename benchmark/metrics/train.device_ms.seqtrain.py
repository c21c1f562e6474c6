"""Mean device ms of the window's sequence train steps, between the CUDA
events of the program's ``train.step`` spans whose ``model`` is
``sequence``; None where the spans name no model or time no card."""

from benchmark import spans


def read(run):
    return spans.device_mean_ms(
        [s for s in spans.records(run, "train.step")
         if s.attrs.get("model") == "sequence"])
