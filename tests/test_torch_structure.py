"""The port's structure sampler slice (e3diff_tpu_torch) against the JAX
package, on the CPU, at a small size: hidden 64, 4 heads, 2 layers,
max_pos 16, B=2, receptor 16, ligand 8.

JAX ``model.init`` weights (perturbed, so that no zero-initialised layer
hides a path) cross through ``structure_state_dict_from_jax`` and
``load_state_dict(strict=True)``. Tolerances: the f32 forwards agree to
atol 1e-4; sampler steps, fed JAX's own noise draws, agree in wrapped
angular distance to 1e-3 each and 5e-3 over a whole run (see
test_sampler_matches_jax_with_injected_noise).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.data.dataset import LigandBindingSiteData as JData
from e3diff_tpu.data.synthetic import synthetic_complexes as j_synthetic
from e3diff_tpu.diffusion.gaussian import (
    GaussianAngleDiffusion as JDiffusion,
    sample_wrapped_noise as j_wrapped_noise,
)
from e3diff_tpu.models.blocks import GaussianFourierProjection as JFourier
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.config import structure_model_configs as j_configs
from e3diff_tpu.models.structure import StructureDenoiser as JModel
from e3diff_tpu.ops import angles as j_angles
from e3diff_tpu.ops import schedules as j_schedules
from e3diff_tpu.sampling.structure import make_structure_sampler as j_sampler
from e3diff_tpu.utils.params_io import cast_inference_params as j_cast
from e3diff_tpu.utils.quant import dequantize_params, quantize_params_int8

from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.gaussian import (
    GaussianAngleDiffusion,
    ddim_timesteps,
)
from e3diff_tpu_torch.models.blocks import GaussianFourierProjection
from e3diff_tpu_torch.models.config import (
    TransformerConfig,
    sequence_model_configs,
    structure_model_configs,
)
from e3diff_tpu_torch.models.sequence import SequenceDenoiser
from e3diff_tpu_torch.models.structure import (
    StructureDenoiser,
    state_dict_numel,
)
from e3diff_tpu_torch.ops import angles, schedules
from e3diff_tpu_torch.ops.transitions import UniformTransition
from e3diff_tpu_torch.sampling.pipeline import run_pipeline
from e3diff_tpu_torch.sampling.sequence import sample_sequence_batches
from e3diff_tpu_torch.sampling.structure import (
    make_denoise_fn,
    make_structure_sampler,
    sample_structure_batches,
)
from e3diff_tpu_torch.serving.engine import DesignEngine
from e3diff_tpu_torch.utils.params_io import cast_inference_params
from e3diff_tpu_torch.utils.quant import dequantize, quantize_int8
from e3diff_tpu_torch.utils.weights import structure_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L_REC, L_LIG, T_STEPS = 2, 16, 8, 20
SMALL = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
             max_position_embeddings=16)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    rec_mask = np.zeros((B, L_REC), np.float32)
    rec_mask[0, :12] = 1
    rec_mask[1, :] = 1
    lig_mask = np.zeros((B, L_LIG), np.float32)
    lig_mask[0, :6] = 1
    lig_mask[1, :] = 1
    return {
        "ligand_angles": rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)).astype(np.float32),
        "ligand_attn_mask": lig_mask,
        "receptor_seq": np.eye(20, dtype=np.float32)[rng.integers(0, 20, (B, L_REC))],
        "receptor_angles": rng.uniform(-np.pi, np.pi, (B, L_REC, 8)).astype(np.float32),
        "receptor_attn_mask": rec_mask,
    }


def _models(dtype=jnp.float32):
    jenc = JConfig(**SMALL, dtype=dtype)
    jmodel = JModel(jenc, dataclasses.replace(jenc, add_cross_attention=True))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tenc = TransformerConfig(**SMALL, dtype=tdtype)
    tmodel = StructureDenoiser(
        tenc, dataclasses.replace(tenc, add_cross_attention=True),
        device="cpu", seed=None)
    return jmodel, tmodel


@pytest.fixture(scope="module")
def setup():
    jmodel, tmodel = _models()
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((B,), jnp.int32), jb["ligand_angles"],
        jb["ligand_attn_mask"], jb["receptor_seq"], jb["receptor_angles"],
        jb["receptor_attn_mask"])["params"]
    rng = np.random.default_rng(1)
    # perturb every leaf: the zero-initialised adaLN layer would otherwise
    # cut the conditioning path out of the comparison
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        params)
    tmodel.load_state_dict(structure_state_dict_from_jax(params), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, tmodel, params, jb, tb


def _encode(jmodel, params, jb):
    return jmodel.apply({"params": params}, jb["receptor_seq"],
                        jb["receptor_angles"], jb["receptor_attn_mask"],
                        method=jmodel.encode_receptor)


def test_encode_receptor_and_cross_kv_match_jax(setup):
    jmodel, tmodel, params, jb, tb = setup
    j_enc = _encode(jmodel, params, jb)
    t_enc = tmodel.encode_receptor(tb["receptor_seq"], tb["receptor_angles"],
                                   tb["receptor_attn_mask"])
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), atol=1e-4)
    j_kv = jmodel.apply({"params": params}, j_enc,
                        method=jmodel.precompute_cross_kv)
    t_kv = tmodel.precompute_cross_kv(torch.from_numpy(np.array(j_enc)))
    assert len(t_kv) == len(j_kv) == SMALL["num_layers"]
    for (jk, jv), (tk, tv) in zip(j_kv, t_kv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk).reshape(tk.shape), atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv).reshape(tv.shape), atol=1e-4)


@pytest.mark.parametrize("cached", [False, True])
def test_decode_matches_jax(setup, cached):
    jmodel, tmodel, params, jb, tb = setup
    j_enc = _encode(jmodel, params, jb)
    t = np.array([999, 3], np.int32)
    kw = {}
    if cached:
        kw["cross_kv"] = jmodel.apply({"params": params}, j_enc,
                                      method=jmodel.precompute_cross_kv)
    want = jmodel.apply({"params": params}, jnp.asarray(t), jb["ligand_angles"],
                        jb["ligand_attn_mask"], j_enc, jb["receptor_attn_mask"],
                        method=jmodel.decode, **kw)
    t_enc = torch.from_numpy(np.array(j_enc))
    got = tmodel.decode(
        torch.from_numpy(t), tb["ligand_angles"], tb["ligand_attn_mask"], t_enc,
        tb["receptor_attn_mask"],
        cross_kv=tmodel.precompute_cross_kv(t_enc) if cached else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_bf16_within_stated_tolerance(setup):
    """bf16 compute: the kernels add residuals and take the softmax in f32
    where the JAX path does both in bf16 (a stated difference), so the two
    agree only to bf16 rounding through two layers: atol 0.1 on outputs
    of magnitude ~1."""
    _, _, params, jb, tb = setup
    jmodel, tmodel = _models(jnp.bfloat16)
    tmodel.load_state_dict(structure_state_dict_from_jax(params), strict=True)
    t = np.array([999, 3], np.int32)
    want = jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(t), jb["ligand_angles"],
        jb["ligand_attn_mask"], jb["receptor_seq"], jb["receptor_angles"],
        jb["receptor_attn_mask"])
    got = tmodel(torch.from_numpy(t), tb["ligand_angles"], tb["ligand_attn_mask"],
                 tb["receptor_seq"], tb["receptor_angles"],
                 tb["receptor_attn_mask"]).detach()
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.1)


def _jax_noise(key, shape, n_steps):
    """The draws of e3diff_tpu's sampler, redrawn with its key splits
    (sampling/structure.py:74, diffusion/gaussian.py:123,194)."""
    key_init, k = jax.random.split(key)
    x_init = j_wrapped_noise(key_init, shape, jnp.float32)
    zs = []
    for _ in range(n_steps):
        k, k_step = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(k_step, shape, jnp.float32)))
    return {"x_init": torch.from_numpy(np.array(x_init)),
            "z": torch.from_numpy(np.stack(zs))}


def _wrapped_dist(a, b):
    return np.abs(np.asarray(angles.wrap_angle(torch.from_numpy(a - b))))


# Each reverse step, fed JAX's own x_t, agrees to 1e-3. The whole run is
# held to 5e-3: the cosine schedule clips the last beta to 0.9999, so the
# first DDPM step multiplies the network's ~1e-6 f32 rounding by
# 1/sqrt(1 - beta) = 100 (DDIM's x0 prediction divides by
# sqrt(alpha_bar_19) ~ 1e-3), and later steps carry that error on
# (measured: the same-input eps difference stays ~1e-6 at every step, the
# whole-run difference reaches ~3e-3).
@pytest.mark.parametrize("sampler,n_steps,scale", [
    ("ddpm", T_STEPS, 1.0), ("ddim", 5, 1.0), ("ddim", 5, 1.5)])
def test_sampler_matches_jax_with_injected_noise(setup, sampler, n_steps,
                                                 scale):
    jmodel, tmodel, params, jb, tb = setup
    key = jax.random.PRNGKey(7)
    jrun = j_sampler(jmodel, JDiffusion.cosine(T_STEPS),
                     return_trajectory=True, sampler=sampler,
                     ddim_steps=n_steps, guidance_scale=scale)
    want, j_traj = jrun(params, jb, key)
    j_traj = np.asarray(j_traj)
    diffusion = GaussianAngleDiffusion.cosine(T_STEPS, device="cpu")
    noise = _jax_noise(key, (B, L_LIG, 8), n_steps)
    got, traj = make_structure_sampler(
        tmodel, diffusion, return_trajectory=True, sampler=sampler,
        ddim_steps=n_steps, guidance_scale=scale)(tb, noise=noise)
    assert traj.shape == j_traj.shape == (n_steps, B, L_LIG, 8)
    assert torch.equal(traj[-1], got)
    assert _wrapped_dist(got.numpy(), np.asarray(want)).max() <= 5e-3

    denoise = make_denoise_fn(tmodel, tb, guided=scale != 1.0, scale=scale)
    if sampler == "ddpm":
        ladder = [(t, None) for t in reversed(range(T_STEPS))]
    else:
        ladder = list(zip(*ddim_timesteps(T_STEPS, n_steps)))
    x_in = noise["x_init"]
    for i, (t, t_prev) in enumerate(ladder):
        t_vec = torch.full((B,), int(t))
        eps = denoise(t_vec, x_in)
        if sampler == "ddpm":
            x_out = diffusion.p_step(x_in, eps, t_vec, noise["z"][i])
        else:
            x_out = diffusion.ddim_step(x_in, eps, t_vec,
                                        torch.full((B,), int(t_prev)), 1.0,
                                        noise["z"][i])
        assert _wrapped_dist(x_out.numpy(), j_traj[i]).max() <= 1e-3, i
        x_in = torch.from_numpy(j_traj[i].copy())


def test_per_example_guidance_scale_matches_scalar(setup):
    _, tmodel, _, _, tb = setup
    diffusion = GaussianAngleDiffusion.cosine(T_STEPS, device="cpu")
    noise = _jax_noise(jax.random.PRNGKey(3), (B, L_LIG, 8), 3)
    run = make_structure_sampler(tmodel, diffusion, sampler="ddim",
                                 ddim_steps=3, guided=True,
                                 return_trajectory=False)
    scalar, _ = run(tb, noise=noise, scale=1.5)
    vector, _ = run(tb, noise=noise, scale=torch.tensor([1.5, 1.5]))
    torch.testing.assert_close(scalar, vector, atol=0, rtol=0)


def test_ddim_ladder_matches_jax_formula():
    ts, t_prev = ddim_timesteps(1000, 25)
    want = np.round(np.linspace(0, 999, 25)).astype(np.int32)[::-1]
    np.testing.assert_array_equal(ts, want)
    np.testing.assert_array_equal(t_prev, np.concatenate([want[1:], [-1]]))
    assert ddim_timesteps(1000, 1)[0].tolist() == [999]


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_fourier_projection_matches_jax(dtype):
    """The timestep is cast to the compute dtype before the projection
    (blocks.py:416): in bf16, t=999 becomes 1000."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(32,)) * 2 * np.pi).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    jcfg = JConfig(hidden_size=64, dtype=dtype)
    want = JFourier(jcfg).apply({"params": {"W": jnp.asarray(w)}}, jnp.asarray(t))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    mod = GaussianFourierProjection(TransformerConfig(hidden_size=64, dtype=tdtype))
    mod.W.copy_(torch.from_numpy(w))
    got = mod(torch.from_numpy(t))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-3)
    t_seen = 1000.0 if dtype == jnp.bfloat16 else 999.0
    proj = np.float32(t_seen) * w * np.float32(2) * np.float32(np.pi)
    np.testing.assert_allclose(got[3, :32].float().numpy(), np.sin(proj), atol=2e-3)


def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(5)
    kernel = rng.normal(size=(48, 24)).astype(np.float32)     # flax (in, out)
    kernel[:, 3] = 0.0                                        # amax == 0 column
    table = rng.normal(size=(31, 16)).astype(np.float32)
    jq = quantize_params_int8({"dense": {"kernel": jnp.asarray(kernel)},
                               "emb": {"embedding": jnp.asarray(table)}})
    q, s = quantize_int8(torch.from_numpy(kernel.T.copy()), axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq["dense"]["kernel"]["__q8__"]).T)
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(jq["dense"]["kernel"]["__q8_scale__"], np.float32).T)
    q, s = quantize_int8(torch.from_numpy(table), axis=-2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq["emb"]["embedding"]["__q8__"]))
    jdq = np.asarray(jq["emb"]["embedding"]["__q8__"]).astype(jnp.bfloat16) \
        * np.asarray(jq["emb"]["embedding"]["__q8_scale__"])
    np.testing.assert_array_equal(dequantize(q, s).float().numpy(),
                                  np.asarray(jdq, np.float32))


@pytest.mark.parametrize("params_dtype", ["bf16_matmul", "int8_matmul"])
def test_storage_modes_decode_matches_jax(setup, params_dtype):
    jmodel, _, params, jb, tb = setup
    _, tmodel = _models()
    tmodel.load_state_dict(structure_state_dict_from_jax(params), strict=True)
    cast_inference_params(tmodel, params_dtype)
    jp = dequantize_params(
        j_cast(jax.tree.map(jnp.asarray, params), params_dtype))
    t = np.array([10, 500], np.int32)
    want = jax.jit(jmodel.apply)(
        {"params": jp}, jnp.asarray(t), jb["ligand_angles"],
        jb["ligand_attn_mask"], jb["receptor_seq"], jb["receptor_angles"],
        jb["receptor_attn_mask"])
    got = tmodel(torch.from_numpy(t), tb["ligand_angles"], tb["ligand_attn_mask"],
                 tb["receptor_seq"], tb["receptor_angles"], tb["receptor_attn_mask"]).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_schedules_match_jax_exactly():
    for t in (20, 1000):
        a = schedules.cosine_beta_schedule(t)
        np.testing.assert_array_equal(a, j_schedules.cosine_beta_schedule(t))
        ja, ta = j_schedules.compute_alphas(a), schedules.compute_alphas(a)
        assert ja.keys() == ta.keys()
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k])


def test_wrap_angle_matches_jax():
    v = np.random.default_rng(6).uniform(-20, 20, 1000).astype(np.float32)
    v[:4] = [-np.pi, np.pi, 0.0, 3 * np.pi]
    got = angles.wrap_angle(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_angles.wrap_angle(jnp.asarray(v))),
                               atol=2e-6)
    assert got.min() >= -np.pi and got.max() <= np.pi


def test_full_size_param_count_matches_jax():
    enc, dec = structure_model_configs(max_seq_len=64)
    model = StructureDenoiser(enc, dec, device="meta", seed=None)
    jenc, jdec = j_configs(max_seq_len=64)
    jmodel = JModel(jenc, jdec)
    z = jnp.zeros
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), z((1,), jnp.int32), z((1, 16, 8)),
        z((1, 16)), z((1, 64, 20)), z((1, 64, 8)), z((1, 64)))["params"]
    j_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert state_dict_numel(model) == j_count
    assert 146.0e6 < j_count < 146.8e6


def test_dataset_matches_jax():
    complexes = synthetic_complexes(n=20, seed=3)
    assert pickle.dumps(complexes) == pickle.dumps(j_synthetic(n=20, seed=3))
    for split in ("train", "test"):
        ours = LigandBindingSiteData(complexes, split, 64, 1, 16)
        ref = JData(complexes, split, 64, 1, 16)
        assert ours.structure_ids == ref.structure_ids
        for k in ref.arrays:
            np.testing.assert_array_equal(ours.arrays[k], ref.arrays[k])
        for a, b in zip(ours.batches(3), ref.batches(3)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import e3diff_tpu_torch\n"
        "for m in pkgutil.walk_packages(e3diff_tpu_torch.__path__, 'e3diff_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import e3diff_tpu_torch.cli.sample_structure\n"
        "import e3diff_tpu_torch.cli.sample_sequence\n"
        "import e3diff_tpu_torch.cli.run_pipeline\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'e3diff_tpu')]\n"
        "assert not bad, bad\n"
        "for cli in ('sample_structure', 'sample_sequence', 'run_pipeline'):\n"
        "    assert 'e3diff_tpu_torch.cli.' + cli in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def _cli(name, *argv):
    return lambda: __import__(f"e3diff_tpu_torch.cli.{name}",
                              fromlist=["main"]).main(["--synthetic", *argv])


def _cuda_entry_points():
    enc, dec = structure_model_configs(num_layers=1)
    qenc, qdec = sequence_model_configs(num_layers=1)
    return {
        "model": lambda: StructureDenoiser(enc, dec),
        "diffusion": lambda: GaussianAngleDiffusion.cosine(10),
        "sampler": lambda: sample_structure_batches(None, None, []),
        "cli": _cli("sample_structure", "--timesteps", "2"),
        "sequence_model": lambda: SequenceDenoiser(qenc, qdec),
        "d3pm": lambda: D3PMDiffusion.create(UniformTransition(20), 10),
        "sequence_sampler": lambda: sample_sequence_batches(None, None, []),
        "pipeline": lambda: run_pipeline(None, None, None),
        "engine": lambda: DesignEngine(None, None, None, None, None),
        "sequence_cli": _cli("sample_sequence", "--timesteps", "2"),
        "pipeline_cli": _cli("run_pipeline", "--timesteps", "2"),
    }


@pytest.mark.parametrize("entry", [
    "model", "diffusion", "sampler", "cli", "sequence_model", "d3pm",
    "sequence_sampler", "pipeline", "engine", "sequence_cli",
    "pipeline_cli"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _cuda_entry_points()[entry]()


def test_cli_writes_output_pkl_on_cpu(tmp_path):
    from e3diff_tpu_torch.cli.sample_structure import main

    out = tmp_path / "output.pkl"
    results = main(["--synthetic", "--device", "cpu", "--timesteps", "4",
                    "--hidden_size", "64", "--num_heads", "4",
                    "--num_hidden_layers", "1", "--intermediate_size", "64",
                    "--max_seq_len", "64", "--ligand_max_len", "16",
                    "--batch_size", "4", "--output", str(out)])
    with open(out, "rb") as f:
        loaded = pickle.load(f)
    ds = LigandBindingSiteData(synthetic_complexes(n=32), "test", 64, 0, 16)
    lengths = ds.arrays["ligand_length"][:4]
    assert [a.shape for a in loaded] == [(4, n, 8) for n in lengths]
    for a, b in zip(loaded, results):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(a).all() and a.min() >= -np.pi and a.max() < np.pi
               for a in loaded)
