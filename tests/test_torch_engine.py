"""The port's DesignEngine and CLIs against the JAX package, on the CPU, at
a small size (hidden 32, 4 heads, 2 layers, max_seq_len 32, ligand
buckets 8 and 16, receptor buckets 8 and 32): request records and
featurization equal JAX's array for array, bucket routing and scale
validation raise as JAX's do, inverse folding with injected draws gives
JAX's sequences (dead batch slots included), and the whole design path,
the checkpoint loader and both CLIs run and write their outputs.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion import D3PMDiffusion as JD3PM
from e3diff_tpu.diffusion import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.models import SequenceDenoiser as JSequence
from e3diff_tpu.models import StructureDenoiser as JStructure
from e3diff_tpu.models import TransformerConfig as JConfig
from e3diff_tpu.ops import UniformTransition as JUniform
from e3diff_tpu.sampling.sequence import make_sequence_sampler as j_seq_sampler
from e3diff_tpu.serving import DesignEngine as JEngine
from e3diff_tpu.serving.engine import pocket_record as j_pocket_record
from e3diff_tpu.utils.presets import ExperimentConfig as JExperimentConfig
from e3diff_tpu.utils.torch_port import (
    export_sequence_state_dict,
    export_structure_state_dict,
)

from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
from e3diff_tpu_torch.data.dataset import AA_VOCAB
from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.geometry.chain import backbone_coords_from_angles
from e3diff_tpu_torch.models import (
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.ops.transitions import UniformTransition
from e3diff_tpu_torch.serving import DesignEngine, pocket_record
from e3diff_tpu_torch.utils.presets import ExperimentConfig
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

MAXLEN, LIG, T_STRUCT, T_SEQ = 32, 16, 8, 6
CFG = dict(pocket_ext=1, max_seq_len=MAXLEN, ligand_max_len=LIG,
           timesteps=T_STRUCT, bf16=False)
ENGINE = dict(sampler="ddim", ddim_steps=3)


def _tiny(cls, cross, init_style):
    return cls(hidden_size=32, num_heads=4, num_layers=2, intermediate_size=64,
               max_position_embeddings=MAXLEN, add_cross_attention=cross,
               init_style=init_style)


@pytest.fixture(scope="module")
def params():
    """Seeded random weights in both tiny models' JAX trees (shapes from
    jax.eval_shape): N(0, 0.2^2), LayerNorm scales 1 + N(0, 0.05^2)."""
    z = jnp.zeros
    b, lig, rec = 2, LIG, MAXLEN
    s = jax.eval_shape(
        JStructure(_tiny(JConfig, False, "torch_default"),
                   _tiny(JConfig, True, "torch_default")).init,
        jax.random.PRNGKey(0), z((b,), jnp.int32), z((b, lig, 8)), z((b, lig)),
        z((b, rec, 20)), z((b, rec, 8)), z((b, rec)))["params"]
    q = jax.eval_shape(
        JSequence(_tiny(JConfig, False, "xavier_all"),
                  _tiny(JConfig, True, "xavier_all")).init,
        jax.random.PRNGKey(1), z((b, 1)), z((b, lig, 20)), z((b, lig, 8)),
        z((b, lig)), z((b, rec, 20)), z((b, rec, 8)), z((b, rec)))["params"]
    rng = np.random.default_rng(2)

    def draw(path, x):
        noise = rng.normal(size=x.shape).astype(np.float32)
        return (1 + 0.05 * noise if path[-1].key == "scale" else 0.2 * noise)

    return tuple(jax.tree_util.tree_map_with_path(draw, p) for p in (s, q))


def _jax_engine(params, batch_size=4, **kw):
    sparams, qparams = params
    return JEngine(
        JExperimentConfig(**CFG),
        JStructure(_tiny(JConfig, False, "torch_default"),
                   _tiny(JConfig, True, "torch_default")),
        jax.tree.map(jnp.asarray, sparams), JDiffusion.cosine(T_STRUCT),
        JSequence(_tiny(JConfig, False, "xavier_all"),
                  _tiny(JConfig, True, "xavier_all")),
        jax.tree.map(jnp.asarray, qparams),
        JD3PM.create(JUniform(20), timesteps=T_SEQ), batch_size=batch_size,
        **ENGINE, **kw)


def _engine(params, batch_size=4, **kw):
    sparams, qparams = params
    smodel = StructureDenoiser(_tiny(TransformerConfig, False, "torch_default"),
                               _tiny(TransformerConfig, True, "torch_default"),
                               device="cpu", seed=None)
    smodel.load_state_dict(structure_state_dict_from_jax(sparams), strict=True)
    qmodel = SequenceDenoiser(_tiny(TransformerConfig, False, "xavier_all"),
                              _tiny(TransformerConfig, True, "xavier_all"),
                              device="cpu", seed=None)
    qmodel.load_state_dict(sequence_state_dict_from_jax(qparams), strict=True)
    return DesignEngine(
        ExperimentConfig(**CFG), smodel,
        GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu"), qmodel,
        D3PMDiffusion.create(UniformTransition(20), timesteps=T_SEQ,
                             device="cpu"),
        device="cpu", batch_size=batch_size, **ENGINE, **kw)


def _pocket(n_pocket, peptide_length, seed=0):
    rng = np.random.default_rng(seed)
    seq = "".join(AA_VOCAB[i] for i in rng.integers(0, 20, n_pocket))
    angles = rng.uniform(-np.pi, np.pi, (n_pocket, 8)).astype(np.float32)
    return pocket_record(seq, angles, peptide_length)


def _records():
    """Pocket records that route to every (ligand, receptor) bucket pair,
    and real records (pocket extension 1)."""
    return ([_pocket(6, 5, 0), _pocket(12, 5, 1), _pocket(6, 12, 2),
             _pocket(20, 16, 3)]
            + synthetic_complexes(n=3, seed=13, receptor_len_range=(8, 12),
                                  ligand_len_range=(5, 8)))


BUCKETS = dict(ligand_buckets=[8, 16], receptor_buckets=[8, MAXLEN],
               batch_buckets=[2, 4])


def test_pocket_record_matches_jax():
    for args in (("ACDW", np.ones((4, 8), np.float32), 6),):
        ours, ref = pocket_record(*args), j_pocket_record(*args)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]))
    for bad in (("AXZ", np.zeros((3, 8), np.float32), 5),
                ("ACD", np.zeros((2, 8), np.float32), 5),
                ("ACD", np.zeros((3, 8), np.float32), 0)):
        with pytest.raises(ValueError) as ours:
            pocket_record(*bad)
        with pytest.raises(ValueError) as ref:
            j_pocket_record(*bad)
        assert str(ours.value) == str(ref.value)


def test_featurize_matches_jax(params):
    eng, jeng = _engine(params, **BUCKETS), _jax_engine(params, **BUCKETS)
    for rec in _records():
        ours, ref = eng.featurize(rec), jeng.featurize(rec)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]))
    assert ({(eng.featurize(r)["_bucket"], eng.featurize(r)["_rbucket"])
             for r in _records()[:4]} == {(8, 8), (8, 32), (16, 8), (16, 32)})
    assert eng._bucket_groups([eng.featurize(r) for r in _records()]) == \
        jeng._bucket_groups([jeng.featurize(r) for r in _records()])


def _raises_alike(ours, ref):
    with pytest.raises(ValueError) as got:
        ours()
    with pytest.raises(ValueError) as want:
        ref()
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    return str(got.value)


def test_routing_and_scale_validation_raise_as_jax(params):
    for kw in (dict(ligand_buckets=[8, MAXLEN * 2]),
               dict(receptor_buckets=[MAXLEN * 2]),
               dict(batch_buckets=[8])):
        msg = _raises_alike(lambda: _engine(params, **kw),
                            lambda: _jax_engine(params, **kw))
        assert "outside" in msg
    eng = _engine(params, receptor_buckets=[8])
    jeng = _jax_engine(params, receptor_buckets=[8])
    for rec in (_pocket(6, 40), _pocket(12, 5), _pocket(MAXLEN + 8, 5)):
        assert "serving shapes" in _raises_alike(lambda: eng.featurize(rec),
                                                 lambda: jeng.featurize(rec))
    plain, cfg = _engine(params), _engine(params, enable_cfg=True)
    jplain = _jax_engine(params)
    rec = _pocket(6, 7)
    for kw in (dict(guidance_scale=2.0), dict(seq_guidance_scale=2.0)):
        with pytest.raises(ValueError, match="CFG-enabled"):
            plain.featurize(rec, **kw)
        with pytest.raises(ValueError, match="CFG-enabled"):
            jplain.featurize(rec, **kw)
    assert plain.featurize(rec, guidance_scale=1.0)["_guidance_scale"] == 1.0
    with pytest.raises(ValueError, match="finite"):
        cfg.featurize(rec, guidance_scale=float("nan"))
    assert cfg.featurize(rec, seq_guidance_scale=3.0)["_seq_guidance_scale"] == 3.0


def test_inverse_fold_slots_match_a_jax_d3pm_loop(params):
    """Three real records in batch bucket 4 (one dead slot): the engine's
    sequences and recovery rates, fed the JAX sampler's own x_init and
    Gumbel draws, equal a JAX D3PM loop over the same padded batch."""
    kw = dict(ligand_buckets=[8, 16], batch_buckets=[2, 4])
    eng, jeng = _engine(params, **kw), _jax_engine(params, **kw)
    recs = synthetic_complexes(n=3, seed=13, receptor_len_range=(8, 12),
                               ligand_len_range=(5, 8))
    slots = [eng.featurize(r) for r in recs]
    assert {(s["_bucket"], s["_rbucket"]) for s in slots} == {(8, 32)}
    batch = jeng._stack_slots([jeng.featurize(r) for r in recs],
                              [k for k in slots[0] if not k.startswith("_")])
    assert batch["ligand_attn_mask"].shape[0] == 4
    assert not batch["ligand_attn_mask"][3].any()      # the dead slot
    key = jax.random.PRNGKey(21)
    run = j_seq_sampler(jeng.sequence_model, jeng.sequence_d3pm)
    pred = np.asarray(run(jeng.sequence_params,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          key)).argmax(-1)
    key_init, k = jax.random.split(key)
    shape = batch["ligand_seq"].shape
    x_init = jax.nn.one_hot(jax.random.randint(key_init, shape[:2], 0, 20), 20)
    gumbel = []
    for _ in range(len(eng.sequence_d3pm.step_pairs(None))):
        k, k_step = jax.random.split(k)
        gumbel.append(np.asarray(jax.random.gumbel(k_step, shape, jnp.float32)))
    noise = [{"x_init": torch.from_numpy(np.array(x_init)),
              "gumbel": torch.from_numpy(np.stack(gumbel))}]
    out = eng.inverse_fold_slots(slots, noise=noise)
    for i, (res, rec) in enumerate(zip(out, recs)):
        n = int(np.asarray(rec["ligand_mask"]).sum())
        assert res.sequence == "".join(AA_VOCAB[j] for j in pred[i, :n])
        true = batch["ligand_seq"][i, :n].argmax(-1)
        assert res.recovery_rate == float((pred[i, :n] == true).sum() / n)
        np.testing.assert_array_equal(res.angles, batch["ligand_angles"][i, :n])


def test_design_path_runs_with_dead_slots_and_mixed_buckets(params):
    """Every bucket pair, a partial batch (dead slots), per-slot PDB
    choice; the device NERF's PDBs against the float64 chain.py
    reconstruction of the same angles (the PDB keeps 3 decimals)."""
    eng = _engine(params, **BUCKETS)
    recs = _records()
    slots = [eng.featurize(r) for r in recs]
    want_pdb = [i % 2 == 0 for i in range(len(slots))]
    gen = torch.Generator().manual_seed(0)
    out = eng.design_slots(slots, generator=gen, return_pdb=want_pdb)
    for res, rec, pdb in zip(out, recs, want_pdb):
        n = int(np.asarray(rec["ligand_mask"]).sum())
        assert len(res.sequence) == n and set(res.sequence) <= set(AA_VOCAB)
        assert res.angles.shape == (n, 8) and np.isfinite(res.angles).all()
        assert (res.recovery_rate is None) == bool(rec.get("synthetic_ligand"))
        assert (res.pdb is not None) == pdb
        if pdb:
            assert res.pdb.count("\nATOM") + 1 == 4 * n
            got = np.array([[float(l[30:38]), float(l[38:46]), float(l[46:54])]
                            for l in res.pdb.splitlines() if l.startswith("ATOM")])
            np.testing.assert_allclose(got, backbone_coords_from_angles(res.angles),
                                       atol=2e-3)
    assert eng.design_records([]) == []
    again = eng.design_slots(slots, generator=torch.Generator().manual_seed(0),
                             return_pdb=want_pdb)
    assert [r.sequence for r in again] == [r.sequence for r in out]


def test_guided_engine_takes_per_request_scales(params):
    eng = _engine(params, enable_cfg=True, batch_size=4)
    rec = _pocket(6, 7, seed=9)
    slots = [eng.featurize(rec, guidance_scale=w, seq_guidance_scale=w)
             for w in (1.0, 4.0, 1.0)]
    out = eng.design_slots(slots, generator=torch.Generator().manual_seed(3),
                           return_pdb=False)
    base = eng.design_slots([eng.featurize(rec)] * 3,
                            generator=torch.Generator().manual_seed(3),
                            return_pdb=False)
    np.testing.assert_allclose(out[0].angles, base[0].angles, atol=1e-6)
    assert not np.allclose(out[1].angles, base[1].angles)
    eng.warmup(generator=torch.Generator().manual_seed(4))
    assert eng.ready


def test_from_checkpoints_reads_the_jax_export(params, tmp_path):
    """The two .pt state_dicts the JAX package exports, with config.json
    sidecars beside them."""
    sparams, qparams = params
    scfg = JExperimentConfig(**CFG, num_heads=4, hidden_size=32,
                             num_hidden_layers=2, intermediate_size=64)
    qcfg = dataclasses.replace(scfg, timesteps=T_SEQ, num_hidden_layers=2)
    paths = []
    for name, sd, cfg in (
            ("structure", export_structure_state_dict(sparams), scfg),
            ("sequence", export_sequence_state_dict(qparams, timesteps=T_SEQ),
             qcfg)):
        d = tmp_path / name
        d.mkdir()
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                   d / "model.pt")
        (d / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        paths.append(str(d / "model.pt"))
    eng = DesignEngine.from_checkpoints(*paths, device="cpu", batch_size=2,
                                        params_dtype="int8_matmul", **ENGINE)
    assert eng.cfg.max_seq_len == MAXLEN and eng.cfg.ligand_max_len == LIG
    assert eng.sequence_d3pm.timesteps == T_SEQ
    assert eng.sequence_model.decoder_normalize.adaLN_modulation[0] \
        .weight.dtype == torch.int8
    out = eng.design(_pocket(6, 7), n_designs=2,
                     generator=torch.Generator().manual_seed(5))
    assert [len(r.sequence) for r in out] == [7, 7]
    (tmp_path / "sequence" / "config.json").write_text(json.dumps(
        dataclasses.asdict(dataclasses.replace(qcfg, max_seq_len=64))))
    with pytest.raises(ValueError, match="disagree on max_seq_len"):
        DesignEngine.from_checkpoints(*paths, device="cpu")


TINY_FLAGS = ["--synthetic", "--device", "cpu", "--hidden_size", "32",
              "--num_heads", "4", "--num_hidden_layers", "1",
              "--intermediate_size", "64", "--max_seq_len", "64",
              "--ligand_max_len", "16", "--batch_size", "4"]


def test_sequence_cli_writes_its_results_on_cpu(tmp_path):
    from e3diff_tpu_torch.cli.sample_sequence import main

    out = tmp_path / "seq.pkl"
    results = main(TINY_FLAGS + ["--timesteps", "4", "--skip_steps", "2",
                                 "--output", str(out)])
    with open(out, "rb") as f:
        loaded = pickle.load(f)
    assert loaded == results
    ds = LigandBindingSiteData(synthetic_complexes(n=32), "test", 64, 0, 16)
    assert [len(s) for s in loaded["predict_sequence"]] == \
        ds.arrays["ligand_length"].tolist()
    assert all(0.0 <= r <= 1.0 for r in loaded["recovery_rate"])


def test_pipeline_cli_writes_pdbs_and_results_on_cpu(tmp_path):
    from e3diff_tpu_torch.cli.run_pipeline import main

    results = main(TINY_FLAGS + ["--timesteps", "4", "--sampler", "ddim",
                                 "--ddim_steps", "2", "--sequence_timesteps",
                                 "4", "--sequence_layers", "1",
                                 "--outdir", str(tmp_path)])
    with open(tmp_path / "results.pkl", "rb") as f:
        loaded = pickle.load(f)
    assert loaded["predict_sequence"] == results["predict_sequence"]
    lengths = [len(s) for s in results["predict_sequence"]]
    assert [a.shape for a in loaded["generated_angles"]] == [(n, 8) for n in lengths]
    for path, n in zip(results["pdb_paths"], lengths):
        text = open(path).read()
        assert text.count("\nATOM") + 1 == 4 * n and text.endswith("END\n")
