"""Share of the H100's bf16 peak (989 TFLOP/s) that a train step's model
operations take at the window's mean step time: 3 forwards of the
structure denoiser at the padded batch (benchmark/flops.py)."""

from benchmark import flops


def read(run):
    f = run.facts
    if not f.get("step_s"):
        return None
    s = flops.shape_of(run.config["structure"] | {
        "num_heads": run.config["structure"]["num_attention_heads"]})
    work = flops.train_step_flops(s, f["batch"], f["length"], f["length"])
    return 100.0 * work / f["step_s"] / flops.PEAK_BF16_FLOPS
