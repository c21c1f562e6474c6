"""The port's full ``bf16`` storage, its builders and its six new CLIs
against the JAX package, on the CPU, at hidden 32.

* ``cast_inference_params(model, "bf16")`` stores every floating leaf
  bf16; a structure DDIM step and a sequence forward through the stored
  weights agree with the JAX package's ``cast_inference_params(params,
  "bf16")`` (weights carried across, the noise injected) to atol 1e-4, as
  the other storage modes do (tests/test_torch_structure.py).
* utils/builders.py builds the models the JAX builders do (the same
  state_dict keys and shapes), the same schedules and datasets.
* cli/create_pdb.py writes the PDB text of scripts/create_pdb.py,
  cli/evaluate.py prints what scripts/evaluate.py prints,
  cli/sample_by_generated_angles.py pads and clamps a short supply as
  scripts/sample_by_generated_angles.py does and runs on the CPU,
  cli/prune_ckpt.py and cli/convert_data.py follow their scripts' rules on
  the port's layout.
"""

import dataclasses
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.data.dataset import load_complexes as j_load_complexes
from e3diff_tpu.data.synthetic import synthetic_complexes
from e3diff_tpu.diffusion.gaussian import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.utils import builders as j_builders
from e3diff_tpu.utils.params_io import cast_inference_params as j_cast
from e3diff_tpu.utils.presets import ExperimentConfig as JExperimentConfig
from e3diff_tpu.utils.torch_port import (
    port_sequence_state_dict,
    port_structure_state_dict,
)

from e3diff_tpu_torch.data.dataset import load_complexes, save_complexes
from e3diff_tpu_torch.utils import builders
from e3diff_tpu_torch.utils.params_io import (
    PARAMS_DTYPES,
    cast_inference_params,
)
from e3diff_tpu_torch.utils.presets import ExperimentConfig, save_config
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

SMALL = dict(pocket_ext=1, max_seq_len=16, ligand_max_len=8, timesteps=20,
             num_heads=4, hidden_size=32, num_hidden_layers=2,
             intermediate_size=64, bf16=False)
B, L_REC, L_LIG = 3, 16, 8


def _cfgs(**kw):
    return (ExperimentConfig(**{**SMALL, **kw}),
            JExperimentConfig(**{**SMALL, **kw}))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    rec = np.ones((B, L_REC), np.float32)
    rec[0, 11:] = 0
    lig = np.ones((B, L_LIG), np.float32)
    lig[1, 5:] = 0
    return {
        "ligand_seq": np.eye(20, dtype=np.float32)[rng.integers(0, 20, (B, L_LIG))],
        "ligand_angles": rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)).astype(np.float32),
        "ligand_attn_mask": lig,
        "receptor_seq": np.eye(20, dtype=np.float32)[rng.integers(0, 20, (B, L_REC))],
        "receptor_angles": rng.uniform(-np.pi, np.pi, (B, L_REC, 8)).astype(np.float32),
        "receptor_attn_mask": rec,
    }


def _perturbed(model):
    """The model's seeded weights, every one perturbed (the
    zero-initialised adaLN layers would otherwise cut the conditioning out
    of the comparison): the port's state_dict and its numpy copy."""
    gen = torch.Generator().manual_seed(1)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in model.state_dict().items()}
    return sd, {k: v.numpy() for k, v in sd.items()}


STRUCT_KEYS = ("ligand_angles", "ligand_attn_mask", "receptor_seq",
               "receptor_angles", "receptor_attn_mask")
SEQ_KEYS = ("ligand_seq",) + STRUCT_KEYS


@pytest.fixture(scope="module")
def structure_pair():
    """(cfg, the JAX model, its params, the JAX batch, the port's
    state_dict): one set of weights, carried to JAX by its own torch
    checkpoint loader."""
    cfg, jcfg = _cfgs()
    sd, np_sd = _perturbed(builders.build_structure_model(cfg, device="cpu",
                                                          seed=0))
    params = port_structure_state_dict(np_sd, cfg.num_hidden_layers,
                                       cfg.num_hidden_layers)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    return cfg, j_builders.build_structure_model(jcfg), params, jb, sd


@pytest.fixture(scope="module")
def sequence_pair():
    cfg, jcfg = _cfgs(timesteps=10)
    sd, np_sd = _perturbed(builders.build_sequence_model(cfg, device="cpu",
                                                         seed=0))
    params = port_sequence_state_dict(np_sd, cfg.num_hidden_layers)
    jb = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    return cfg, j_builders.build_sequence_model(jcfg), params, jb, sd


# ------------------------------------------------------------ bf16 storage

def _all_bf16(model):
    leaves = [*model.parameters(), *(b for b in model.buffers()
                                     if b is not None)]
    return leaves and all(t.dtype == torch.bfloat16 for t in leaves
                          if t.is_floating_point())


def test_bf16_storage_structure_ddim_step_matches_jax(structure_pair):
    cfg, jmodel, params, jb, sd = structure_pair
    model = builders.build_structure_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    cast_inference_params(model, "bf16")
    assert _all_bf16(model)
    jp = j_cast(jax.tree.map(jnp.asarray, params), "bf16")
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(jp))

    rng = np.random.default_rng(3)
    x_t = rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)).astype(np.float32)
    t, t_prev = np.full(B, 12, np.int32), np.full(B, 6, np.int32)
    key = jax.random.PRNGKey(4)
    jd = JDiffusion.cosine(cfg.timesteps)
    eps = jax.jit(jmodel.apply)({"params": jp}, jnp.asarray(t),
                                jnp.asarray(x_t), *(jb[k] for k in STRUCT_KEYS[1:]))
    want = jd.ddim_step(key, jnp.asarray(x_t), eps, jnp.asarray(t),
                        jnp.asarray(t_prev), 1.0)
    z = np.array(jax.random.normal(key, x_t.shape, jnp.float32))

    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with torch.no_grad():
        got_eps = model(torch.from_numpy(t), torch.from_numpy(x_t),
                        *(tb[k] for k in STRUCT_KEYS[1:]))
    diffusion = builders.build_structure_diffusion(cfg, device="cpu")
    got = diffusion.ddim_step(torch.from_numpy(x_t), got_eps,
                              torch.from_numpy(t).long(),
                              torch.from_numpy(t_prev).long(), 1.0,
                              torch.from_numpy(z))
    np.testing.assert_allclose(got_eps.numpy(), np.asarray(eps), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bf16_storage_sequence_forward_matches_jax(sequence_pair):
    cfg, jmodel, params, jb, sd = sequence_pair
    model = builders.build_sequence_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    cast_inference_params(model, "bf16")
    assert _all_bf16(model)
    jp = j_cast(jax.tree.map(jnp.asarray, params), "bf16")
    t = np.array([[9.0], [1.0], [4.0]], np.float32)
    want = jax.jit(jmodel.apply)({"params": jp}, jnp.asarray(t),
                                 *(jb[k] for k in SEQ_KEYS))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with torch.no_grad():
        got = model(torch.from_numpy(t), *(tb[k] for k in SEQ_KEYS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bf16_storage_with_bf16_compute_runs_and_refuses_a_second_cast(
        structure_pair):
    cfg, _, _, jb, sd = structure_pair
    model = builders.build_structure_model(dataclasses.replace(cfg, bf16=True),
                                           device="cpu")
    model.load_state_dict(sd, strict=True)
    cast_inference_params(model, "bf16")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with torch.no_grad():
        out = model(torch.tensor([3, 7, 19]), *(tb[k] for k in STRUCT_KEYS))
    assert out.dtype == torch.bfloat16 and out.isfinite().all()
    with pytest.raises(ValueError, match="already cast"):
        cast_inference_params(model, "bf16")
    assert "bf16" in PARAMS_DTYPES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_with_bf16_stored_affine_matches_flax(dtype):
    """The LayerNorm kernel upcasts a bf16-stored weight and bias to f32
    (ops/kernels.py); flax's LayerNorm promotes them the same way: exact
    in bf16 compute, f32 rounding (7e-7 measured) in f32 compute."""
    import flax.linen as nn

    from e3diff_tpu_torch.ops.kernels import layernorm

    rng = np.random.default_rng(9)
    x = (rng.normal(size=(64, 96)) * 3 + 0.5).astype(np.float32)
    w = jnp.asarray(1 + 0.3 * rng.normal(size=96), jnp.bfloat16)
    b = jnp.asarray(0.2 * rng.normal(size=96), jnp.bfloat16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = nn.LayerNorm(epsilon=1e-12, dtype=jdt).apply(
        {"params": {"scale": w, "bias": b}}, jnp.asarray(x).astype(jdt))
    got = layernorm(torch.from_numpy(x).to(tdt),
                    torch.from_numpy(np.asarray(w, np.float32)).bfloat16(),
                    torch.from_numpy(np.asarray(b, np.float32)).bfloat16(),
                    eps=1e-12)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-6 if dtype == "float32" else 0)


def test_every_cli_and_the_engine_accept_bf16(tmp_path):
    from e3diff_tpu_torch.cli import (
        run_pipeline,
        sample_by_generated_angles,
        sample_sequence,
        sample_structure,
        serve,
    )
    from e3diff_tpu_torch.serving.engine import DesignEngine

    for mod, extra in ((sample_structure, []), (sample_sequence, []),
                       (run_pipeline, []), (sample_by_generated_angles,
                                            ["--ckpt", "x.pt"]),
                       (serve, ["--structure_ckpt", "s", "--sequence_ckpt",
                                "q"])):
        args = mod.build_parser().parse_args(["--params_dtype", "bf16",
                                              *extra])
        assert args.params_dtype == "bf16"
    cfg, _ = _cfgs(max_seq_len=64, ligand_max_len=16, pocket_ext=0)
    paths = {}
    for kind, build in (("structure", builders.build_structure_model),
                        ("sequence", builders.build_sequence_model)):
        kcfg = dataclasses.replace(cfg, timesteps=20 if kind == "structure"
                                   else 10)
        save_config(kcfg, str(tmp_path / kind))
        paths[kind] = str(tmp_path / kind / "final.pt")
        torch.save(build(kcfg, device="cpu", seed=0).state_dict(),
                   paths[kind])
    eng = DesignEngine.from_checkpoints(paths["structure"], paths["sequence"],
                                        params_dtype="bf16", device="cpu",
                                        batch_size=4)
    assert _all_bf16(eng.structure_model) and _all_bf16(eng.sequence_model)


# ------------------------------------------------------------ builders

def test_builders_match_jax_builders(structure_pair, sequence_pair, tmp_path):
    for pair, build, to_sd, keys, t in (
            (structure_pair, builders.build_structure_model,
             structure_state_dict_from_jax, STRUCT_KEYS,
             jnp.zeros((B,), jnp.int32)),
            (sequence_pair, builders.build_sequence_model,
             sequence_state_dict_from_jax, SEQ_KEYS, jnp.zeros((B, 1)))):
        cfg, jmodel, _, jb, _ = pair
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), t,
                                *(jb[k] for k in keys))["params"]
        got = build(cfg, device="cpu", seed=0).state_dict()
        want = to_sd(jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                                  shapes))
        assert sorted((k, tuple(v.shape)) for k, v in got.items()) == \
            sorted((k, tuple(v.shape)) for k, v in want.items())
    cfg, jcfg = _cfgs()
    got = builders.build_structure_diffusion(cfg, device="cpu")
    want = j_builders.build_structure_diffusion(jcfg)
    for k, v in want.terms.items():
        np.testing.assert_array_equal(got.terms[k].numpy(), np.asarray(v))
    for transition in ("blosum", "uniform"):
        got = builders.build_sequence_diffusion(cfg, transition, device="cpu")
        want = j_builders.build_sequence_diffusion(jcfg, transition)
        assert got.timesteps == want.timesteps == cfg.timesteps
        assert type(got.transition).__name__ == type(want.transition).__name__
        np.testing.assert_array_equal(got.alphas_bar.numpy(),
                                      np.asarray(want.alphas_bar))
    path = str(tmp_path / "data.pkl")
    save_complexes(synthetic_complexes(n=20, seed=2), path)
    cfg, jcfg = _cfgs(max_seq_len=64, ligand_max_len=16)
    for split in ("train", "test", None):
        got = builders.build_dataset(cfg, path, split)
        want = j_builders.build_dataset(jcfg, path, split)
        assert got.arrays.keys() == want.arrays.keys()
        for k in want.arrays:
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k])


# ------------------------------------------------------------ the CLIs

def _run_script(name, argv, monkeypatch):
    import importlib

    monkeypatch.setattr(sys, "argv", [name, *argv])
    importlib.import_module(f"scripts.{name}").main()


def _angle_pickles(tmp_path, data):
    """A trajectory-shaped sample list, and a flat one per test complex
    with every other sample the wrong length (unpaired)."""
    from e3diff_tpu.data.dataset import LigandBindingSiteData

    test = LigandBindingSiteData(data, "test", 64, 0, 16)
    rng = np.random.default_rng(7)
    flat = []
    for i in range(len(test)):
        n = int(test[i]["ligand_length"]) + (i % 2)
        flat.append(np.concatenate(
            [rng.uniform(-np.pi, np.pi, (n, 4)),
             rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (n, 4))],
            axis=1).astype(np.float32))
    traj = [np.stack([s, s[::-1], s * 0.5]) for s in flat]
    paths = {}
    for name, obj in (("flat", flat), ("traj", traj), ("nested", [flat])):
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)
    return paths


def _folder_texts(folder):
    return {f: open(os.path.join(folder, f)).read()
            for f in sorted(os.listdir(folder))}


def test_create_pdb_cli_writes_the_scripts_text(tmp_path, monkeypatch):
    from e3diff_tpu_torch.cli.create_pdb import main

    paths = _angle_pickles(tmp_path, synthetic_complexes(n=40, seed=5))
    for name, extra in (("traj", []), ("traj", ["--traj_index", "1"]),
                        ("flat", []), ("nested", ["--reference_indexing"])):
        jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
        for d in (jdir, tdir):
            if os.path.isdir(d):
                for f in os.listdir(d):
                    os.unlink(os.path.join(d, f))
        argv = ["--input", paths[name], *extra]
        _run_script("create_pdb", [*argv, "--outdir", jdir], monkeypatch)
        written = main([*argv, "--outdir", tdir])
        assert all(written) and len(written) == 4
        assert _folder_texts(tdir) == _folder_texts(jdir)


def test_evaluate_cli_prints_the_scripts_numbers(tmp_path, monkeypatch,
                                                 capsys):
    from e3diff_tpu_torch.cli.evaluate import main

    data = synthetic_complexes(n=40, seed=5)
    data_file = str(tmp_path / "data.pkl")
    save_complexes(data, data_file)
    paths = _angle_pickles(tmp_path, data)
    seqs = str(tmp_path / "seqs.pkl")
    with open(seqs, "wb") as f:
        pickle.dump({"recovery_rate": [0.25, 0.5, 1.0, 0.0, 0.4]}, f)
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "config.json").write_text(json.dumps(
        {"pocket_ext": 1, "max_seq_len": 64, "ligand_max_len": 16}))
    for argv in (["--angles", paths["traj"], "--geometry",
                  "--sequences", seqs, "--ligand_max_len", "16"],
                 ["--angles", paths["flat"], "--config", str(run_dir)],
                 ["--sequences", seqs]):
        argv = ["--data_file", data_file, *argv]
        _run_script("evaluate", argv, monkeypatch)
        want = capsys.readouterr().out
        main(argv)
        got = capsys.readouterr().out
        assert got == want
        assert got.strip()


def _sequence_ckpt(tmp_path, cfg):
    run = tmp_path / "seq_run"
    save_config(cfg, str(run))
    path = str(run / "final.pt")
    torch.save(builders.build_sequence_model(cfg, device="cpu",
                                             seed=0).state_dict(), path)
    return path


def test_sample_by_generated_angles_clamps_a_short_supply_as_jax(
        tmp_path, monkeypatch, capsys):
    import e3diff_tpu.sampling as j_sampling
    import scripts.sample_by_generated_angles as j_script

    from e3diff_tpu_torch.cli.sample_by_generated_angles import (
        generated_batches,
        main,
    )
    from e3diff_tpu_torch.data import LigandBindingSiteData

    data_file = str(tmp_path / "data.pkl")
    save_complexes(synthetic_complexes(n=60, seed=6), data_file)
    rng = np.random.default_rng(8)
    generated = [rng.uniform(-np.pi, np.pi, (int(n), 8)).astype(np.float32)
                 for n in rng.integers(5, 15, 5)]
    gen_file = str(tmp_path / "gen.pkl")
    with open(gen_file, "wb") as f:
        pickle.dump(generated, f)
    flags = ["--data_file", data_file, "--batch_size", "4",
             "--max_seq_len", "48", "--ligand_max_len", "16",
             "--pocket_ext", "1", "--hidden_size", "32", "--num_heads", "4",
             "--num_hidden_layers", "1", "--intermediate_size", "64",
             "--timesteps", "10", "--bf16", "false"]

    seen = {}

    def capture(params, model, d3pm, batches, rng, **kw):
        seen["batches"], seen["gen"] = batches, kw["generated_angles"]
        return {"recovery_rate": [0.0]}

    monkeypatch.setattr(j_script, "load_params", lambda *a, **k: None)
    monkeypatch.setattr(j_sampling, "sample_sequence_batches", capture)
    _run_script("sample_by_generated_angles",
                [*flags, "--ckpt", "none", "--generated", gen_file,
                 "--output", str(tmp_path / "j.pkl")], monkeypatch)
    want_out = capsys.readouterr().out

    test_ds = LigandBindingSiteData(load_complexes(data_file), "test", 48, 1,
                                    16)
    batches, gen = generated_batches(test_ds, generated, 4)
    assert "restricting to 2 batches (5 designs)" in capsys.readouterr().out
    assert "restricting to 2 batches (5 designs)" in want_out
    assert len(batches) == len(seen["batches"]) == 2
    for got, want in zip(batches, seen["batches"]):
        assert got.keys() == want.keys()
        assert got["num_valid"] == want["num_valid"]
        assert got["structure_ids"] == want["structure_ids"]
        for k in got:
            if k not in ("num_valid", "structure_ids"):
                np.testing.assert_array_equal(got[k], want[k])
    assert [int(b["num_valid"]) for b in batches] == [4, 1]
    for got, want in zip(gen, seen["gen"]):
        np.testing.assert_array_equal(got, want)

    cfg = ExperimentConfig(**{**SMALL, "max_seq_len": 48,
                              "ligand_max_len": 16, "timesteps": 10,
                              "num_hidden_layers": 1})
    ckpt = _sequence_ckpt(tmp_path, cfg)
    out = str(tmp_path / "t.pkl")
    results = main([*flags, "--ckpt", ckpt, "--generated", gen_file,
                    "--output", out, "--device", "cpu"])
    assert len(results["recovery_rate"]) == 5
    # one sequence a covered test complex, as long as its peptide
    assert [len(s) for s in results["predict_sequence"]] == \
        [int(test_ds[i]["ligand_length"]) for i in range(5)]
    with open(out, "rb") as f:
        assert pickle.load(f)["predict_sequence"] == \
            results["predict_sequence"]


def test_sample_by_generated_angles_defaults_to_the_card(tmp_path):
    from e3diff_tpu_torch.cli.sample_by_generated_angles import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--synthetic", "--ckpt", str(tmp_path / "x.pt"),
              "--generated", str(tmp_path / "g.pkl")])


def test_prune_ckpt_cli_on_the_port_layout(tmp_path, capsys):
    from e3diff_tpu_torch.cli.prune_ckpt import main

    run = tmp_path / "run"
    run.mkdir()
    for name in ("last", "final", "best_val_model", "final_ema"):
        torch.save({"w": torch.zeros(1000)}, run / f"{name}.pt")
    leftovers = [".last.k2j4x9.tmp", ".final.q8w1zz.tmp"]
    for f in leftovers + ["config.json", "history.json", "notes.txt"]:
        (run / f).write_text("{}")
    main([str(run), "--dry_run"])
    assert "would remove" in capsys.readouterr().out
    assert (run / "last.pt").is_file()
    freed = main([str(run)])
    assert freed > 4000
    assert sorted(os.listdir(run)) == sorted([
        "best_val_model.pt", "config.json", "final.pt", "final_ema.pt",
        "history.json", "notes.txt"])
    main([str(run), "--keep", "final"])
    assert sorted(os.listdir(run)) == sorted([
        "config.json", "final.pt", "history.json", "notes.txt"])
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "last.pt").write_text("x")
    with pytest.raises(SystemExit, match="NO usable weights"):
        main([str(empty)])
    assert (empty / "last.pt").is_file()


def test_convert_data_cli_matches_the_script(tmp_path, monkeypatch):
    from e3diff_tpu_torch.cli.convert_data import main

    complexes = synthetic_complexes(n=6, seed=9)
    as_torch = [{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                 for k, v in c.items()} for c in complexes]
    src = str(tmp_path / "biolip.pt")
    torch.save(as_torch, src)
    main(["--input", src, "--output", str(tmp_path / "t.pkl")])
    _run_script("convert_data", ["--input", src, "--output",
                                 str(tmp_path / "j.pkl")], monkeypatch)
    got = load_complexes(str(tmp_path / "t.pkl"))
    want = j_load_complexes(str(tmp_path / "j.pkl"))
    assert len(got) == len(want) == len(complexes)
    for g, w, c in zip(got, want, complexes):
        assert list(g) == list(w) == list(c)
        for k in c:
            if isinstance(c[k], np.ndarray):
                np.testing.assert_array_equal(g[k], c[k])
                np.testing.assert_array_equal(w[k], c[k])
            else:
                assert g[k] == w[k] == c[k]
