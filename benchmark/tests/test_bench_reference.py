"""The plain reference against the program at a tiny size on the CPU.

The drivers run each cell's timed path at tiny widths in float32 compute,
where the program and the reference must agree to rounding; the NERF and
PDB check against the program's own geometry."""

import importlib

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import geometry
from benchmark.tests import tiny

SAMPLE = dict(mix={"batch_size": 3, "ligand_len": 16, "pocket_len": [8, 20],
                   "peptide_len": [5, 16]},
              config={"compute_dtype": "f32",
                      "sample": {"max_seq_len": 32, "pocket_ext": 0,
                                 "sampler": "ddpm", "timesteps": 40}},
              spec={"steps_followed": 16}, seconds=1.0)
SERVE = dict(mix={"rate_rps": 3}, config={"compute_dtype": "f32"},
             seconds=3.0)
TRAIN = dict(mix={"batch_size": 4}, config={"compute_dtype": "f32"},
             seconds=0.5)


def drive(name, **kw):
    torch.set_num_threads(2)
    r = tiny.cell(name, **kw)
    importlib.import_module("benchmark.drivers." + r.spec["driver"]).run(r)
    return {k: v["value"] for k, v in r.readings.items()}


def test_sample_cell_follows_the_program():
    got = drive("structure-146m.sample-ddpm1000-b64", **SAMPLE)
    assert got["answers_unmatched"] == 0 and got["replay_gap"] == 0
    assert got["struct_eps_rel"] < 1e-4


def test_serve_cell_follows_the_program():
    got = drive("design-146m-61m.serve-steady", **SERVE)
    assert got["answers_unmatched"] == 0 and got["replay_gap"] == 0
    assert got["struct_eps_rel"] < 1e-4 and got["seq_logit_rel"] < 1e-4
    assert got["seq_draw_miss"] < 1e-3
    # float32 NERF over random angles lies up to 0.05 Å off float64 where
    # placements are nearly collinear; which angles are served depends on
    # how the batcher grouped the requests
    assert got["pdb_gap_A"] < 0.05


def test_train_cell_follows_the_program():
    got = drive("structure-146m.train-b64", **TRAIN)
    assert got["loss_rel"] < 1e-5 and got["grad_norm_rel"] < 1e-4
    assert got["change_norm_rel"] < 1e-4


def test_nerf_and_pdb_against_the_program():
    from e3diff_tpu_torch.geometry.nerf import nerf_build_backbone_batch
    from e3diff_tpu_torch.geometry.pdb import backbone_pdb_text

    rng = np.random.default_rng(3)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, (12, 4)),
                          rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (12, 4))],
                         axis=1).astype(np.float32)
    xyz = nerf_build_backbone_batch(torch.from_numpy(ang)[None])[0].numpy()
    text = backbone_pdb_text(xyz - xyz.mean(0))
    assert compare.pdb_gap(text, ang) < 2e-3
    ref = geometry.backbone(ang)
    assert np.abs(geometry.pdb_coordinates(text) - ref).max() < 2e-3
    # a wrong angle moves atoms by far more
    bad = ang.copy()
    bad[5, 1] += 0.1
    assert compare.pdb_gap(text, bad) > 0.1


def test_exact_gap():
    a = torch.arange(6.0)
    assert compare.exact_gap(a, a.clone()) == 0.0
    assert compare.exact_gap(a, a + 1e-6) > 0
    assert compare.exact_gap(a, a[:3]) == float("inf")


@pytest.mark.parametrize("name,kw", [
    ("structure-146m.sample-ddpm1000-b64", SAMPLE),
    ("design-146m-61m.serve-steady", SERVE),
])
def test_the_int8_control_moves_the_readings(name, kw):
    """The control path (the program's int8 weights) reads far above the
    program's own float32 path at the same size."""
    base = drive(name, **kw)
    ctl = drive(name, control="int8", **kw)
    assert ctl["struct_eps_rel"] > 100 * max(base["struct_eps_rel"], 1e-7)
