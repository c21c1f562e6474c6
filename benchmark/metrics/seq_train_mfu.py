"""Share of the H100's bf16 peak (989 TFLOP/s) that a sequence train
step's model operations take at the window's mean step time: 3 forwards
of the sequence denoiser at the padded batch (benchmark/flops_seq.py)."""

from benchmark import flops, flops_seq


def read(run):
    f = run.facts
    if not f.get("step_s"):
        return None
    s = flops_seq.shape_of(run.config["sequence"])
    work = flops_seq.train_step_flops(s, f["batch"], f["length"], f["length"])
    return 100.0 * work / f["step_s"] / flops.PEAK_BF16_FLOPS
