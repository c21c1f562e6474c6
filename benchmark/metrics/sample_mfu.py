"""Share of the H100's bf16 peak (989 TFLOP/s) that a batch's model
operations take at the window's mean batch time: the pocket encoding
and cross K/V once, then one decode a step (benchmark/flops.py)."""

from benchmark import flops


def read(run):
    f = run.facts
    if not f.get("batch_s"):
        return None
    part = {**run.config["structure"], **run.config["sample"]}
    s = flops.shape_of(part | {"num_heads": part["num_attention_heads"]})
    work = flops.sample_batch_flops(s, f["batch"], f["ligand_len"],
                                    f["receptor_len"], f["steps"])
    return 100.0 * work / f["batch_s"] / flops.PEAK_BF16_FLOPS
