"""Whole batches through the program's structure sampler,
``sampling/structure.py::sample_structure_batches``, the path of the
sample_structure and run_pipeline command lines: final angles only.

Set-up builds the model with the benchmark's weights and hands the
sampler a stream of batches whose first one captures the bucket's
programs. Once it has been sampled the window opens: the stream yields
batches until ``--seconds`` have passed, and the rate is the structures
of the window's batches over the seconds from the window's start to the
return of the sampler, which waits for the last of them.

Correctness: the window's batches must all come back, and a seeded one
of its sampler calls is followed step by step (benchmark/follow.py) at
a seeded set of steps, the first and the last among them: driven again
with its draws, it must return bit for bit the structures the window
returned for that batch, and the reference takes each followed step
from the program's state.
"""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np

from benchmark import generate


def batches_of(mix: dict, conf: dict, seed: int, index: int) -> dict:
    """Batch ``index`` of the stream: the mix's batch of pocket requests
    (the same sizes for every seed, in an order and with contents drawn
    from it), featurized by the benchmark: the ligand padded to
    ``ligand_len``, the pocket (used as given) to max_seq_len."""
    b = mix["batch_size"]
    reqs = generate.pocket_requests(mix, b, seed * 1000003 + index)
    rows = []
    for r in reqs:
        n_pocket, n_pep = len(r["sequence"]), r["peptide_length"]
        total = n_pocket + n_pep
        lig = np.zeros(total, bool)
        lig[n_pocket:] = True
        rec = {"amino_acid": list(r["sequence"] + "A" * n_pep),
               "angle_features": np.concatenate(
                   [r["angles"], np.zeros((n_pep, 8), np.float32)]),
               "ligand_mask": lig, "pocket_mask": ~lig}
        rows.append(generate.complex_arrays(rec, conf["max_seq_len"], 0,
                                            mix["ligand_len"]))
    return generate.stack(rows)


def run(r):
    import torch

    from benchmark import compare, program
    from benchmark.follow import (Recorder, follow_structure,
                                  structure_follower)
    from benchmark.harness import Profiler
    from e3diff_tpu_torch.sampling.structure import sample_structure_batches
    from e3diff_tpu_torch.utils import builders

    conf, mix, dev = r.config, r.mix, r.device
    part = {**conf["structure"], **conf["sample"]}
    sconf = {**conf, "structure": part}
    cfg = program.experiment(sconf, "structure")
    model = program.structure_model(
        cfg, program.weights(sconf, "structure", r.seed_for("w.s"), dev), dev)
    params = "int8_matmul" if r.control == "int8" else conf["params_dtype"]
    program.store(model, params)
    diff = builders.build_structure_diffusion(cfg, device=dev)
    rec = Recorder(r.seed_for("follow"), keep=1)
    rec.watch_draws(diff)
    prof = Profiler(r, torch)
    prof.warm()
    cuda = dev.type == "cuda"
    state = {"t0": None, "window": 0, "traced": None}
    trace_at = mix.get("trace_batch", 2)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def stream():
        yield batches_of(mix, part, r.seed, 0)          # captures
        sync()
        state["t0"] = time.perf_counter()
        r.setup_s = time.monotonic() - r.t0
        rec.active = True
        i = 1
        while time.perf_counter() - state["t0"] < r.seconds:
            if r.trace and i == trace_at:
                sync()
                prof.start()
                state["traced"] = "on"
            elif state["traced"] == "on":
                prof.stop()
                state["traced"] = "done"
            yield batches_of(mix, part, r.seed, i)
            state["window"] += 1
            i += 1

    outs = sample_structure_batches(
        model, diff, stream(), device=dev, seed=r.seed_for("noise"),
        first_batch_only=False, return_trajectory=False,
        sampler=part["sampler"], step=1)
    sync()
    t1 = time.perf_counter()
    prof.finish()
    rec.active = False
    elapsed = t1 - state["t0"]
    # the traced batch ran under the profiler: the batch time of the
    # per-layer metrics leaves it out
    steady = ((elapsed - prof.seconds) / (state["window"] - 1)
              if r.trace and state["window"] > 1
              else elapsed / max(state["window"], 1))
    b = mix["batch_size"]
    n = state["window"] * b
    window_outs = outs[b:]
    r.attempted = n
    r.failed = sum(1 for o in window_outs if not np.isfinite(o).all())
    r.metrics["structures_per_s"] = n / elapsed
    r.metrics["setup_s"] = r.setup_s
    r.facts.update(batch_s=steady, batch=b,
                   ligand_len=mix["ligand_len"], receptor_len=part[
                       "max_seq_len"], steps=part["timesteps"],
                   traced_batches=1)
    r.memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print(f"sample: {state['window']} batches of {b} in {elapsed:.3f} s "
          f"({elapsed / max(state['window'], 1):.4f} s a batch)",
          file=sys.stderr)

    # the window's batch i (from 1) is its sampler call i - 1
    call = rec.kept["structure"][0]
    index = call["n"] + 1
    call["batch"] = batches_of(mix, part, r.seed, index)
    got = outs[index * b:(index + 1) * b]
    steps = part["timesteps"]
    pick = random.Random(r.seed_for("steps")).sample(
        range(1, steps - 1), min(steps - 2, r.spec["steps_followed"]))
    follower = structure_follower(model, diff, sampler=part["sampler"])
    final, states, table = follow_structure(follower, call,
                                            {0, steps - 1, *pick})
    final = final.float().cpu().numpy()
    unmatched = sum(1 for i, row in enumerate(got)
                    if not np.array_equal(final[i, :len(row)], row))
    unmatched += abs(len(rec.calls["structure"]) * b - len(window_outs))
    replay = max((float(np.abs(final[i, :len(row)] - row).max())
                  for i, row in enumerate(got)), default=math.inf)
    rec.detach()
    del model, outs, window_outs, got, follower
    rec.calls = None
    program.free()

    from benchmark.reference import nets
    from benchmark.reference.diffusion import Gaussian

    nets.set_exact_float32()
    ctx = nets.Ctx(program.weights(sconf, "structure", r.seed_for("w.s"),
                                   dev),
                   part["num_attention_heads"], part["max_seq_len"],
                   t_dtype={"bf16": torch.bfloat16,
                            "f32": torch.float32}[conf["compute_dtype"]])
    err2, ref2, worst, read = compare.structure_steps(
        ctx, Gaussian(steps, dev), call["batch"], states, table,
        call["draws"][1], ddim=False, eta=1.0, max_gain=r.spec["max_gain"],
        device=dev)
    r.read("answers_unmatched", unmatched)
    r.read("replay_gap", replay)
    r.read("struct_eps_rel", math.sqrt(err2 / ref2) if read else math.inf)
    print(f"sample check: {read} of {len(states)} followed steps read, "
          f"the worst step's eps error {worst!r}", file=sys.stderr)
