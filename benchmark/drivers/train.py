"""The program's captured train step (``training/trainer.py::
Trainer.capture`` -> ``CapturedStep``), fed batch after batch through
``data/prefetch.py`` as ``training/loop.py`` feeds it.

Set-up builds the model with the benchmark's weights, AdamW and the
structure trainer with its generator seeded from the run's seed,
captures the step on the first batch (its warm-up steps run inside
``Trainer.restored()``, so the trainer's state is as it was), then drives
the same captured step through its first steps on the stream's first
batches, reading what the check compares: each step's loss, the first
gradient as the optimizer got it (its first moment after one step, over
1 - b1) and the parameters' change over the steps; the reference follows
them with each forward's weights rounded to bf16, as the program's bf16
compute over float32 master weights rounds them. The window then runs
steps until ``--seconds`` have passed; the rate is 64 samples times the
steps over the seconds from the window's start to the end of its last
step. Complexes come from the mix's generator, are featurized by the
program's dataset (``data/dataset.py``) and stream through the program's
prefetch thread; every batch holds other complexes.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from benchmark import generate


def job_of(conf: dict) -> dict:
    t = conf["training"]
    return {"lr": t["lr"], "weight_decay": t["l2_norm"],
            "grad_clip": t["gradient_clip"], "b1": 0.9, "b2": 0.999,
            "eps": 1e-8, "max_epochs": t["max_epochs"],
            "steps_per_epoch": t["steps_per_epoch"]}


def run(r):
    import torch

    from benchmark import program
    from benchmark.harness import Profiler
    from e3diff_tpu_torch.data.dataset import LigandBindingSiteData
    from e3diff_tpu_torch.data.prefetch import prefetch_to_device
    from e3diff_tpu_torch.training import AdamW, StructureTrainer
    from e3diff_tpu_torch.utils import builders

    conf, mix, dev = r.config, r.mix, r.device
    part = conf["structure"]
    cfg = program.experiment(conf, "structure")
    job = job_of(conf)
    model = program.structure_model(
        cfg, program.weights(conf, "structure", r.seed_for("w.s"), dev), dev)
    opt = AdamW(dict(model.named_parameters()), base_lr=job["lr"],
                weight_decay=job["weight_decay"],
                max_epochs=job["max_epochs"],
                steps_per_epoch=job["steps_per_epoch"],
                grad_clip=job["grad_clip"], mu_dtype=conf["training"][
                    "mu_dtype"])
    gen_seed = r.seed_for("trainer")
    trainer = StructureTrainer(
        model, builders.build_structure_diffusion(cfg, device=dev), opt,
        generator=torch.Generator(device=dev).manual_seed(gen_seed))
    b = mix["batch_size"]
    first = mix["first_steps"]

    def source():
        i = 0
        while True:
            recs = generate.synthetic_complexes(mix, b,
                                                r.seed * 1000003 + i)
            ds = LigandBindingSiteData(recs, None,
                                       max_len=part["max_seq_len"],
                                       pocket_ext=part["pocket_ext"])
            yield next(ds.batches(b))
            i += 1

    feed = prefetch_to_device(source(), dev, size=2)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    batch = next(feed)
    step = trainer.capture(batch) if cuda else trainer.train_step
    names = opt.names
    with torch.no_grad():
        p0 = [p.detach().clone() for p in opt.params]
    losses, grad_norms = [], None
    for k in range(first):
        if k:
            batch = next(feed)
        metrics = step(batch)
        losses.append(float(metrics["train_loss"]))
        if k == 0:
            grad_norms = [float(m.float().norm() / (1 - 0.9))
                          for m in opt.mu]
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
    print(f"train: {n} steps in {elapsed:.3f} s ({elapsed / n * 1e3:.3f} ms "
          f"a step); first losses {losses}", file=sys.stderr)
    if cuda:
        step.close()
    del trainer, model, opt, step, metrics, batch
    program.free()
    _check(r, conf, job, losses, dict(zip(names, grad_norms)),
           dict(zip(names, change)), gen_seed, torch)


def _check(r, conf, job, losses, grad_norms, change, gen_seed, torch):
    """The reference follows the first steps on the same complexes, with
    its own featurization and the same draws."""
    from benchmark import program
    from benchmark.reference import nets
    from benchmark.reference.train import train_steps

    nets.set_exact_float32()
    dev, mix, part = r.device, r.mix, conf["structure"]
    b = mix["batch_size"]
    batches = []
    for k in range(mix["first_steps"]):
        recs = generate.synthetic_complexes(mix, b, r.seed * 1000003 + k)
        rows = [generate.complex_arrays(rec, part["max_seq_len"],
                                        part["pocket_ext"])
                for rec in generate.dataset_order(recs)]
        batches.append({k2: torch.as_tensor(v, device=dev)
                        for k2, v in generate.stack(rows).items()})
    w = program.weights(conf, "structure", r.seed_for("w.s"), dev)
    # bf16 compute over float32 master weights: each forward computes with
    # the weights' bf16 copy, which an update under half a bf16 step of a
    # weight leaves as it was
    matmul = (nets.int8_matmul if r.control == "int8"
              else nets.bf16_weight_matmul if conf["compute_dtype"] == "bf16"
              else nets.f32_matmul)
    ref_losses, ref_grads, ref_params = train_steps(
        w, batches, job, program.reference_cfg(conf, "structure"),
        gen_seed, dev, matmul=matmul,
        t_dtype={"bf16": torch.bfloat16,
                 "f32": torch.float32}[conf["compute_dtype"]])
    g_ref = {k: float(v.norm()) for k, v in ref_grads.items()}
    d_ref = {k: float((ref_params[k] - w[k]).norm()) for k in ref_params}
    med_g = float(np.median(list(g_ref.values())))
    med_d = float(np.median(list(d_ref.values())))
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out by the rule below, not by name
    live = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
    loss_gaps = [abs(a - c) / abs(c) for a, c in zip(losses, ref_losses)]
    grad_gap = max(abs(grad_norms[k] - g_ref[k]) / max(g_ref[k], med_g)
                   for k in live)
    change_gaps = sorted(abs(change[k] - d_ref[k]) / max(d_ref[k], med_d)
                         for k in live)
    r.read("loss_rel", loss_gaps[0])
    r.read("later_loss_rel", max(loss_gaps[1:]))
    r.read("grad_norm_rel", grad_gap)
    r.read("change_norm_rel", change_gaps[-1])
    print(f"train check: losses {losses} against {ref_losses} (gaps "
          f"{loss_gaps}); change gap worst leaf {change_gaps[-1]!r}; "
          f"{len(g_ref) - len(live)} leaves left out", file=sys.stderr)
