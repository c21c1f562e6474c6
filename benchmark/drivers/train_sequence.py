"""The program's captured train step of the sequence denoiser
(``training/sequence.py::SequenceTrainer`` through ``Trainer.capture``),
built as ``training/run.py::build_trainer("sequence", ...)`` builds it
and fed as ``training/run.py`` feeds ``train_loop``.

Set-up builds the model with the benchmark's weights, its D3PM with the
BLOSUM transition (``builders.build_sequence_diffusion``), AdamW and the
trainer with its generator seeded from the run's seed and no
conditioning dropout. It makes the mix's pool of complexes from the
run's seed and featurizes it once with the program's dataset
(``data/dataset.py``); batches are drawn from it in a shuffled order
each pass (seed: the run's seed plus the pass, the last partial batch
dropped) and stream through the program's prefetch thread. The step is
captured on the first batch before that thread starts (its warm-up steps
run inside ``Trainer.restored()``); the same captured step then runs the
first steps on the feed's first batches, reading what the check
compares: each step's loss, the first gradient as the optimizer got it
(its first moment after one step, over 1 - b1), the parameters' change
over the steps, and each step's noised classes as the step itself drew
them (what the diffusion's ``apply_aa_noise`` returned, wrapped on this
instance: under capture, the graph's own output, which every replay
rewrites).
The window then runs steps until ``--seconds`` have passed; the rate is
64 samples times the steps over the seconds from the window's start to
the end of its last step.

The reference (benchmark/reference/train_sequence.py) follows the first
steps on the same complexes, featurized on its own, with the same draws
and each forward's weights rounded to bf16, as the program's bf16
compute over float32 master weights rounds them.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from benchmark import generate
from benchmark.drivers.train import job_of


def run(r):
    import torch

    from benchmark import program
    from benchmark.harness import Profiler
    from e3diff_tpu_torch.data.dataset import LigandBindingSiteData
    from e3diff_tpu_torch.data.prefetch import prefetch_to_device, to_device
    from e3diff_tpu_torch.training import AdamW, SequenceTrainer
    from e3diff_tpu_torch.utils import builders

    conf, mix, dev = r.config, r.mix, r.device
    part = conf["sequence"]
    cfg = program.experiment(conf, "sequence")
    job = job_of(conf)
    model = program.sequence_model(
        cfg, program.weights(conf, "sequence", r.seed_for("w.q"), dev), dev)
    opt = AdamW(dict(model.named_parameters()), base_lr=job["lr"],
                weight_decay=job["weight_decay"],
                max_epochs=job["max_epochs"],
                steps_per_epoch=job["steps_per_epoch"],
                grad_clip=job["grad_clip"], mu_dtype=conf["training"][
                    "mu_dtype"])
    gen_seed = r.seed_for("trainer")
    diffusion = builders.build_sequence_diffusion(
        cfg, part["transition"], device=dev)
    # the noised one-hots of the newest call; the capture's call is the
    # last before the replays, and its tensor lives in the graph's pool
    noised_out = []
    apply_aa_noise = diffusion.apply_aa_noise

    def apply_kept(*args, **kwargs):
        noised_out[:] = [apply_aa_noise(*args, **kwargs)]
        return noised_out[0]

    diffusion.apply_aa_noise = apply_kept
    trainer = SequenceTrainer(
        model, diffusion, opt,
        cond_dropout=conf["training"]["cond_dropout"],
        generator=torch.Generator(device=dev).manual_seed(gen_seed))
    b = mix["batch_size"]
    first = mix["first_steps"]
    pool = generate.synthetic_complexes(mix, mix["pool"], r.seed_for("pool"))
    ds = LigandBindingSiteData(pool, None, max_len=part["max_seq_len"],
                               pocket_ext=part["pocket_ext"])
    first_ids: list[list[str]] = []

    def source():
        p = 0
        while True:
            for batch in ds.batches(b, shuffle=True, seed=r.seed + p,
                                    drop_last=True):
                if len(first_ids) < first:
                    first_ids.append([s["pdb_id"]
                                      for s in batch["structure_ids"]])
                yield batch
            p += 1

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # captured on the feed's first batch before the prefetch thread
    # starts, so that none of the thread's allocations and copies land
    # among the capture's: on an H100, processes whose capture raced the
    # thread ran 2.4% apart in train_samples_per_s, against 1.1% without
    batch = to_device(next(ds.batches(b, shuffle=True, seed=r.seed,
                                      drop_last=True)), dev)
    step = trainer.capture(batch) if cuda else trainer.train_step
    sync()
    feed = prefetch_to_device(source(), dev, size=2)
    batch = next(feed)
    names = opt.names
    with torch.no_grad():
        p0 = [p.detach().clone() for p in opt.params]
    losses, grad_norms, noised = [], None, []
    for k in range(first):
        if k:
            batch = next(feed)
        metrics = step(batch)
        losses.append(float(metrics["train_loss"]))
        if k == 0:
            grad_norms = [float(m.float().norm() / (1 - 0.9))
                          for m in opt.mu]
        noised.append(noised_out[0].argmax(-1).cpu())
    with torch.no_grad():
        change = [float((p.detach() - q).float().norm())
                  for p, q in zip(opt.params, p0)]
    del p0
    sync()
    r.setup_s = time.monotonic() - r.t0
    prof = Profiler(r, torch)
    prof.warm()
    traced = mix.get("trace_steps", 8)
    n, t0 = 0, time.perf_counter()
    while True:
        batch = next(feed)
        if r.trace and n == 20:
            prof.start()
        metrics = step(batch)
        n += 1
        if r.trace and n == 20 + traced:
            prof.stop()
        if n % 10 == 0 and time.perf_counter() - t0 >= r.seconds:
            break
        if n % 30 == 0:     # the loop's log line reads the loss as often
            float(metrics["train_loss"])
    last = float(metrics["train_loss"])
    sync()
    elapsed = time.perf_counter() - t0
    feed.close()
    prof.finish()
    # the traced steps ran under the profiler: the step time of the
    # per-layer metrics leaves them out
    steady = ((elapsed - prof.seconds) / (n - traced) if r.trace
              and n > traced else elapsed / n)
    r.attempted = n
    r.failed = 0 if math.isfinite(last) else 1
    r.metrics["train_samples_per_s"] = b * n / elapsed
    r.metrics["setup_s"] = r.setup_s
    r.facts.update(step_s=steady, batch=b, length=part["max_seq_len"],
                   traced_steps=traced)
    r.memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    print(f"train_sequence: {n} steps in {elapsed:.3f} s "
          f"({elapsed / n * 1e3:.3f} ms a step); first losses {losses}",
          file=sys.stderr)
    if cuda:
        step.close()
    del trainer, model, opt, step, metrics, batch, diffusion, noised_out
    program.free()
    by_id = {rec["structure_ids"]["pdb_id"]: rec for rec in pool}
    _check(r, conf, job, losses, dict(zip(names, grad_norms)),
           dict(zip(names, change)), noised,
           [[by_id[i] for i in ids] for ids in first_ids], gen_seed, torch)


def _check(r, conf, job, losses, grad_norms, change, noised, records,
           gen_seed, torch):
    """The reference follows the first steps on the same complexes, with
    its own featurization and the same draws."""
    from benchmark import program
    from benchmark.reference import nets
    from benchmark.reference.train_sequence import train_steps

    nets.set_exact_float32()
    dev, part = r.device, conf["sequence"]
    batches = []
    for recs in records:
        rows = [generate.complex_arrays(rec, part["max_seq_len"],
                                        part["pocket_ext"]) for rec in recs]
        batches.append({k: torch.as_tensor(v, device=dev)
                        for k, v in generate.stack(rows).items()})
    w = program.weights(conf, "sequence", r.seed_for("w.q"), dev)
    # bf16 compute over float32 master weights: each forward computes with
    # the weights' bf16 copy, which an update under half a bf16 step of a
    # weight leaves as it was
    matmul = (nets.int8_matmul if r.control == "int8"
              else nets.bf16_weight_matmul if conf["compute_dtype"] == "bf16"
              else nets.f32_matmul)
    ref_losses, ref_grads, ref_params, ref_noised = train_steps(
        w, batches, job, program.reference_cfg(conf, "sequence"),
        gen_seed, dev, matmul=matmul,
        t_dtype={"bf16": torch.bfloat16,
                 "f32": torch.float32}[conf["compute_dtype"]])
    g_ref = {k: float(v.norm()) for k, v in ref_grads.items()}
    d_ref = {k: float((ref_params[k] - w[k]).norm()) for k in ref_params}
    med_g = float(np.median(list(g_ref.values())))
    med_d = float(np.median(list(d_ref.values())))
    # leaves whose reference gradient is nought to rounding (the key
    # biases: softmax does not see them) move under Adam by round-off
    # alone: left out by the rule below, not by name
    live = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    loss_gaps = [abs(a - c) / abs(c) for a, c in zip(losses, ref_losses)]
    grad_gap = max(abs(grad_norms[k] - g_ref[k]) / max(g_ref[k], med_g)
                   for k in live)
    change_gaps = sorted(abs(change[k] - d_ref[k]) / max(d_ref[k], med_d)
                         for k in live)
    lig = torch.stack([b["ligand_attn_mask"] for b in batches]).bool().cpu()
    ref_cls = torch.stack([c.cpu() for c in ref_noised])
    # a step that noised other rows than the batch's matches none
    unmatched = (float(((torch.stack(noised) != ref_cls) & lig).sum()
                       / lig.sum().clamp(min=1))
                 if all(c.shape == ref_cls.shape[1:] for c in noised)
                 else 1.0)
    r.read("loss_rel", loss_gaps[0])
    r.read("later_loss_rel", max(loss_gaps[1:]))
    r.read("grad_norm_rel", grad_gap)
    r.read("change_norm_rel", change_gaps[-1])
    r.read("noised_unmatched", unmatched)
    print(f"train_sequence check: losses {losses} against {ref_losses} "
          f"(gaps {loss_gaps}); change gap worst leaf {change_gaps[-1]!r}; "
          f"noised unmatched {unmatched!r}; {len(g_ref) - len(live)} leaves "
          f"left out", file=sys.stderr)
