"""The port's sequence train step (training/sequence.py::SequenceTrainer
with the BLOSUM D3PM) against the benchmark's plain reference
(benchmark/reference/train_sequence.py) on the CPU, at a tiny size in
float32 on seeded random weights: the loss, every leaf's gradient, the
parameters after two AdamW steps and the noised classes; the reference's
BLOSUM Q_bar against ops/transitions.py at every step; and the
benchmark's sequence train cell run on the CPU with no module of JAX
loaded."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generate, program
from benchmark.reference import blosum
from benchmark.reference.train_sequence import train_steps
from e3diff_tpu_torch.diffusion.d3pm import sample_gumbel
from e3diff_tpu_torch.ops.schedules import DiscreteNoiseSchedule
from e3diff_tpu_torch.ops.transitions import BlosumTransition
from e3diff_tpu_torch.training import AdamW, SequenceTrainer
from e3diff_tpu_torch.utils import builders

ROOT = Path(__file__).resolve().parent.parent
T = 50
CONF = {"compute_dtype": "f32", "sequence": {
    "hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
    "intermediate_size": 96, "position_embedding_type": "relative_key",
    "timesteps": T, "max_seq_len": 48, "pocket_ext": 4, "dropout_p": 0.1}}
JOB = {"lr": 5e-5, "weight_decay": 0.1, "grad_clip": 1.0, "b1": 0.9,
       "b2": 0.999, "eps": 1e-8, "max_epochs": 9, "steps_per_epoch": 250}
MIX = {"base_seed": 15, "receptor_len": [18, 40], "peptide_len": [5, 15],
       "pocket_frac": 0.4}
B, GEN_SEED = 4, 2 ** 31 + 5


def _batches(n_steps: int) -> list[dict]:
    recs = generate.synthetic_complexes(MIX, B * n_steps, 99)
    out = []
    for k in range(n_steps):
        rows = [generate.complex_arrays(r, 48, 4)
                for r in recs[B * k:B * (k + 1)]]
        out.append({name: torch.as_tensor(v)
                    for name, v in generate.stack(rows).items()})
    return out


def test_q_bar_matches_the_blosum_transition_at_every_step():
    ref = blosum.q_bar_table(T, "cpu")
    ab = torch.from_numpy(DiscreteNoiseSchedule.cosine(T).alphas_bar)
    trans = BlosumTransition(device="cpu")
    diffusion = builders.build_sequence_diffusion(
        program.experiment(CONF, "sequence"), "blosum", device="cpu")
    for t in range(T + 1):
        got = trans.get_Qt_bar(ab[t:t + 1])[0]
        torch.testing.assert_close(got, ref[t], rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(diffusion.q_bar[t], ref[t], rtol=1e-6,
                                   atol=1e-7)
    # Q3: t = 0 is near uniform, t = T near the identity
    assert ref[0].diagonal().mean() < 0.2 < 0.99 < ref[T].diagonal().mean()


@pytest.mark.parametrize("t", [0, 23, T, None],
                         ids=["t0", "t23", "tT", "drawn"])
def test_the_train_step_follows_the_reference(t):
    torch.manual_seed(0)
    dev = torch.device("cpu")
    w = program.weights(CONF, "sequence", 7, dev)
    model = program.sequence_model(program.experiment(CONF, "sequence"),
                                   w, dev)
    opt = AdamW(dict(model.named_parameters()), base_lr=JOB["lr"],
                weight_decay=JOB["weight_decay"],
                max_epochs=JOB["max_epochs"],
                steps_per_epoch=JOB["steps_per_epoch"],
                grad_clip=JOB["grad_clip"])
    diffusion = builders.build_sequence_diffusion(
        program.experiment(CONF, "sequence"), "blosum", device=dev)
    gen = torch.Generator().manual_seed(GEN_SEED)
    trainer = SequenceTrainer(model, diffusion, opt, generator=gen)
    batches = _batches(2)
    t_fixed = None if t is None else torch.full((B,), t)
    losses, grads, noised = [], None, []
    for k, batch in enumerate(batches):
        g = torch.Generator()
        g.set_state(gen.get_state())
        t_int = (torch.randint(0, T + 1, (B,), generator=g)
                 if t is None else t_fixed)
        gumbel = sample_gumbel(tuple(batch["ligand_seq"].shape), generator=g,
                               device=dev)
        noised.append(diffusion.apply_aa_noise(
            batch["ligand_seq"], t_int, gumbel=gumbel).argmax(-1))
        draws = {} if t is None else {"t_int": t_fixed}
        losses.append(float(trainer.train_step(batch, **draws)["train_loss"]))
        if k == 0:
            grads = {n: m / (1 - JOB["b1"]) for n, m in zip(opt.names,
                                                            opt.mu)}
    ref_losses, ref_grads, ref_params, ref_noised = train_steps(
        w, batches, JOB, program.reference_cfg(CONF, "sequence"), GEN_SEED,
        dev, t_fixed=t_fixed)
    for a, c in zip(noised, ref_noised):
        assert torch.equal(a, c)
    lig = torch.stack([b["ligand_attn_mask"] for b in batches]).bool()
    share = float((torch.stack(noised) != torch.stack(
        [b["ligand_seq"].argmax(-1) for b in batches]))[lig].float().mean())
    assert share > 0.5 if t == 0 else share < 0.05 if t == T else share > 0
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-6)
    med = float(np.median([float(v.norm()) for v in ref_grads.values()]))
    for name, g_ref in ref_grads.items():
        # in norm: an element's round-off is not its leaf's error
        assert float((grads[name] - g_ref).norm()) <= 1e-4 * max(
            float(g_ref.norm()), 1e-2 * med), name
    params = dict(model.named_parameters())
    for name, p_ref in ref_params.items():
        # Adam scales each element's update by its own gradient's size, so
        # an element (or, for the key biases that softmax does not see, a
        # whole leaf) of nought gradient moves by normalised round-off, up
        # to lr a step on either side; a live leaf's change agrees in norm
        got = params[name].detach()
        torch.testing.assert_close(got, p_ref, rtol=0, atol=2 * 2 * JOB["lr"],
                                   msg=name)
        if float(ref_grads[name].norm()) >= 1e-3 * med:
            d_ref = p_ref - w[name]
            assert float((got - p_ref).norm()) <= 1e-3 * float(
                d_ref.norm()), name


def test_the_cell_runs_on_the_cpu_without_jax():
    """The benchmark's sequence train cell at tiny widths, traced, in a
    fresh interpreter: its readings are made, every per-layer reader of
    the cell returns a number or None, and no module of JAX, flax or the
    JAX package is loaded."""
    code = f"""
import sys, json, importlib
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark import harness, run
from benchmark.tests import tiny
r = tiny.cell("sequence-61m.train-b64", seconds=0.5,
              mix={{"batch_size": 2, "pool": 6, "trace_steps": 2}},
              config={{"compute_dtype": "f32"}})
r.trace = True
importlib.import_module("benchmark.drivers.train_sequence").run(r)
values = {{}}
for m in r.bench["per_layer"]:
    if r.cell["name"] in m.get("workloads", []):
        spec = importlib.util.spec_from_file_location(
            "m", run.ROOT / "benchmark" / "metrics" / (m["name"] + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        values[m["name"]] = mod.read(r)
print("READ", json.dumps({{"values": values, "checks": sorted(r.readings),
                          "found": harness.forbidden_modules()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("READ "))
    got = json.loads(line[5:])
    assert got["found"] == []
    assert got["checks"] == ["change_norm_rel", "grad_norm_rel",
                             "later_loss_rel", "loss_rel", "noised_unmatched"]
    assert len(got["values"]) == 6
    assert all(v is None or isinstance(v, float)
               for v in got["values"].values())
    assert got["values"]["seq_train_mfu"] > 0
    assert got["values"]["train.data_wait_ms.seqtrain"] >= 0
