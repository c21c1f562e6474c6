"""The port's sequence D3PM slice (e3diff_tpu_torch) against the JAX
package, on the CPU, at a small size: hidden 64, 4 heads, 2 layers,
max_pos 16, B=3 (the last batch row a dead slot with all-zero masks),
receptor 16, ligand 8, T=6.

JAX ``model.init`` weights (perturbed, so that no zero-initialised adaLN
hides a path) cross through ``sequence_state_dict_from_jax`` and
``load_state_dict(strict=True)``. Tolerances: schedules and the BLOSUM
ladder exact; transition matrices and posterior probabilities 1e-6 (f32
softmax and sums taken in another order); the f32 forward 1e-4, as the
structure model's; the sampler, fed JAX's own x_init and Gumbel draws,
identical class indices at every step and at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion.d3pm import D3PMDiffusion as JD3PM
from e3diff_tpu.diffusion.guidance import concat_cond_uncond as j_concat
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.config import sequence_model_configs as j_seq_configs
from e3diff_tpu.models.config import structure_model_configs as j_configs
from e3diff_tpu.models.restack import params_to_scan
from e3diff_tpu.models.sequence import SequenceDenoiser as JModel
from e3diff_tpu.models.structure import StructureDenoiser as JStructure
from e3diff_tpu.ops import schedules as j_schedules
from e3diff_tpu.ops import transitions as j_transitions
from e3diff_tpu.sampling.sequence import make_sequence_sampler as j_sampler
from e3diff_tpu.utils.params_io import cast_inference_params as j_cast
from e3diff_tpu.utils.quant import dequantize_params
from e3diff_tpu.utils.torch_port import export_sequence_state_dict

from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.guidance import concat_cond_uncond
from e3diff_tpu_torch.models.config import (
    TransformerConfig,
    sequence_model_configs,
)
from e3diff_tpu_torch.models.sequence import SequenceDenoiser
from e3diff_tpu_torch.models.structure import state_dict_numel
from e3diff_tpu_torch.ops import schedules, transitions
from e3diff_tpu_torch.sampling.sequence import make_sequence_sampler
from e3diff_tpu_torch.utils.params_io import (
    cast_inference_params,
    load_sequence_checkpoint,
)
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

B, L_REC, L_LIG, T_STEPS, K = 3, 16, 8, 6, 20
SMALL = dict(hidden_size=64, num_heads=4, num_layers=2, intermediate_size=128,
             max_position_embeddings=16)


def _batch(seed=0):
    """Ragged masks; batch row 2 is a dead slot (all-zero masks and
    features), as the engine pads a partial batch."""
    rng = np.random.default_rng(seed)
    rec_mask = np.zeros((B, L_REC), np.float32)
    rec_mask[0, :12] = 1
    rec_mask[1, :] = 1
    lig_mask = np.zeros((B, L_LIG), np.float32)
    lig_mask[0, :6] = 1
    lig_mask[1, :] = 1
    batch = {
        "ligand_seq": np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, L_LIG))],
        "ligand_angles": rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)).astype(np.float32),
        "ligand_attn_mask": lig_mask,
        "receptor_seq": np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, L_REC))],
        "receptor_angles": rng.uniform(-np.pi, np.pi, (B, L_REC, 8)).astype(np.float32),
        "receptor_attn_mask": rec_mask,
    }
    for k in batch:
        batch[k][2] = 0.0
    return batch


def _configs(dtype):
    jenc = JConfig(**SMALL, init_style="xavier_all", dtype=dtype)
    tenc = TransformerConfig(
        **SMALL, init_style="xavier_all",
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    return ((jenc, dataclasses.replace(jenc, add_cross_attention=True)),
            (tenc, dataclasses.replace(tenc, add_cross_attention=True)))


def _models(params, dtype=jnp.float32):
    (jenc, jdec), (tenc, tdec) = _configs(dtype)
    tmodel = SequenceDenoiser(tenc, tdec, device="cpu", seed=None)
    tmodel.load_state_dict(sequence_state_dict_from_jax(params), strict=True)
    return JModel(jenc, jdec), tmodel


def _forward_args(b):
    return (b["ligand_seq"], b["ligand_angles"], b["ligand_attn_mask"],
            b["receptor_seq"], b["receptor_angles"], b["receptor_attn_mask"])


@pytest.fixture(scope="module")
def setup():
    (jenc, jdec), _ = _configs(jnp.float32)
    jmodel = JModel(jenc, jdec)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((B, 1)), *_forward_args(jb))["params"]
    rng = np.random.default_rng(1)
    # perturb every leaf: decoder_normalize's zeroed adaLN would otherwise
    # cut the timestep out of its branch
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(np.float32),
        params)
    jmodel, tmodel = _models(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jmodel, tmodel, params, jb, tb


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("timesteps", [T_STEPS, 50, 500])
def test_discrete_schedule_matches_jax_exactly(timesteps):
    np.testing.assert_array_equal(
        schedules.cosine_beta_schedule_discrete(timesteps),
        j_schedules.cosine_beta_schedule_discrete(timesteps))
    ours = schedules.DiscreteNoiseSchedule.cosine(timesteps)
    ref = j_schedules.DiscreteNoiseSchedule.cosine(timesteps)
    for name in ("betas", "alphas", "alphas_bar"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))


def test_blosum_asset_and_ladder_match_jax_exactly():
    ours, ref = transitions.load_blosum_asset(), j_transitions.load_blosum_asset()
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    for n in (501, 51, 500):
        np.testing.assert_array_equal(
            transitions.interpolate_linear_align_corners(ref["Qt_temperature"], n),
            j_transitions.interpolate_linear_align_corners(ref["Qt_temperature"], n))


@pytest.mark.parametrize("kind", ["uniform", "blosum"])
def test_transitions_match_jax(kind):
    """get_Qt_bar at the schedule's alpha_bar (Q3) and get_Qt, (B,) and
    (B, 1) arguments, within 1e-6."""
    ab = j_schedules.DiscreteNoiseSchedule.cosine(50).alphas_bar
    vals = np.concatenate([ab, [0.0, 0.5, 1.0]]).astype(np.float32)
    if kind == "uniform":
        ours, ref = transitions.UniformTransition(K), j_transitions.UniformTransition(K)
    else:
        ours = transitions.BlosumTransition(device="cpu")
        ref = j_transitions.BlosumTransition()
    for arg in (vals, vals[:, None]):
        for fn in ("get_Qt_bar", "get_Qt"):
            got = getattr(ours, fn)(torch.from_numpy(arg))
            want = np.asarray(getattr(ref, fn)(jnp.asarray(arg)))
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -------------------------------------------------------------------- model

def test_sequence_forward_matches_jax(setup):
    """f32, raw integer steps as the sampler feeds them (Q9), the dead
    slot included."""
    jmodel, tmodel, params, jb, tb = setup
    t = np.array([[49.0], [3.0], [0.0]], np.float32)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(t),
                                 *_forward_args(jb))
    got = tmodel(torch.from_numpy(t), *_forward_args(tb))
    assert got.shape == (B, L_LIG, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sequence_forward_bf16_within_stated_tolerance(setup):
    """bf16 compute: the kernels' plain versions add residuals and take
    the softmax in f32 where JAX does both in bf16 (a stated difference),
    so the logits agree only to bf16 rounding through two layers: atol
    0.1, the structure model's bound, on logits of magnitude ~3."""
    _, _, params, jb, tb = setup
    jmodel, tmodel = _models(params, jnp.bfloat16)
    t = np.array([[49.0], [3.0], [0.0]], np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(t), *_forward_args(jb)), np.float32)
    got = tmodel(torch.from_numpy(t), *_forward_args(tb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.1)


@pytest.mark.parametrize("params_dtype", ["bf16_matmul", "int8_matmul"])
def test_storage_modes_forward_matches_jax(setup, params_dtype):
    jmodel, _, params, jb, tb = setup
    _, tmodel = _models(params)
    cast_inference_params(tmodel, params_dtype)
    jp = dequantize_params(j_cast(jax.tree.map(jnp.asarray, params), params_dtype))
    t = np.array([[10.0], [1.0], [5.0]], np.float32)
    want = jax.jit(jmodel.apply)({"params": jp}, jnp.asarray(t),
                                 *_forward_args(jb))
    got = tmodel(torch.from_numpy(t), *_forward_args(tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_full_size_param_count_matches_jax():
    """The 61M model at max_seq_len 64, without the dead
    receptor_feature_emb (Q7)."""
    enc, dec = sequence_model_configs(max_seq_len=64)
    model = SequenceDenoiser(enc, dec, device="meta", seed=None)
    jenc, jdec = j_seq_configs(max_seq_len=64)
    z = jnp.zeros
    shapes = jax.eval_shape(
        JModel(jenc, jdec).init, jax.random.PRNGKey(0), z((1, 1)),
        z((1, 16, 20)), z((1, 16, 8)), z((1, 16)), z((1, 64, 20)),
        z((1, 64, 8)), z((1, 64)))["params"]
    j_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert state_dict_numel(model) == j_count == 60_990_100
    assert not any(k.startswith("receptor_feature_emb")
                   for k in model.state_dict())


def test_xavier_init_keeps_the_shared_fuse_adaln():
    """xavier_all draws every Linear, zeroes every bias, and re-zeroes
    only decoder_normalize's first adaLN Linear."""
    enc, dec = sequence_model_configs(max_seq_len=16, num_layers=1)
    small = dict(hidden_size=64, num_heads=4, intermediate_size=64)
    model = SequenceDenoiser(dataclasses.replace(enc, **small),
                             dataclasses.replace(dec, **small), device="cpu")
    sd = model.state_dict()
    assert sd["ligand_feature_emb.adaLN_modulation.0.weight"].abs().sum() > 0
    assert sd["decoder_normalize.adaLN_modulation.0.weight"].abs().sum() == 0
    w = sd["decoder.layer.0.intermediate.dense.weight"]
    assert w.abs().max() <= np.sqrt(6.0 / (64 + 64))
    assert all(v.abs().sum() == 0 for k, v in sd.items()
               if k.endswith(".bias") and "LayerNorm" not in k)


# --------------------------------------------------------------- weights

@pytest.mark.parametrize("model", ["structure", "sequence"])
def test_scan_layer_layout_crosses_as_the_per_layer_one(setup, model):
    """A scan_layers tree (``layers/layer`` with a leading layer axis)
    gives the same state_dict as its per-layer form."""
    if model == "sequence":
        params, convert = setup[2], sequence_state_dict_from_jax
    else:
        jenc, jdec = j_configs(max_seq_len=16, num_layers=2)
        jenc = dataclasses.replace(jenc, **SMALL)
        jdec = dataclasses.replace(jdec, **SMALL)
        z = jnp.zeros
        shapes = jax.eval_shape(
            JStructure(jenc, jdec).init, jax.random.PRNGKey(2),
            z((1,), jnp.int32), z((1, 8, 8)), z((1, 8)), z((1, 16, 20)),
            z((1, 16, 8)), z((1, 16)))["params"]
        rng = np.random.default_rng(2)
        params = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), shapes)
        convert = structure_state_dict_from_jax
    scanned = params_to_scan(params)
    assert "layers" in scanned["decoder"]
    want, got = convert(params), convert(scanned)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_load_sequence_checkpoint_drops_only_the_dead_keys(setup, tmp_path):
    _, tmodel, params, _, _ = setup
    sd = export_sequence_state_dict(params, timesteps=T_STEPS)
    assert any(k.startswith("receptor_feature_emb.") for k in sd)
    path = tmp_path / "seq.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    _, fresh = _models(jax.tree.map(np.zeros_like, params))
    load_sequence_checkpoint(str(path), fresh, timesteps=T_STEPS)
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, atol=0, rtol=0)
    with pytest.raises(ValueError, match="schedule"):
        load_sequence_checkpoint(str(path), fresh, timesteps=50)


def test_concat_cond_uncond_matches_jax(setup):
    _, _, _, jb, tb = setup
    for drop in (False, True):
        want = j_concat(jb, drop_ligand_angles=drop)
        got = concat_cond_uncond(tb, drop_ligand_angles=drop)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------- D3PM

def _d3pms(kind):
    if kind == "uniform":
        ours, ref = transitions.UniformTransition(K), j_transitions.UniformTransition(K)
    else:
        ours = transitions.BlosumTransition(device="cpu")
        ref = j_transitions.BlosumTransition()
    return (D3PMDiffusion.create(ours, timesteps=T_STEPS, device="cpu"),
            JD3PM.create(ref, timesteps=T_STEPS))


@pytest.mark.parametrize("kind", ["uniform", "blosum"])
def test_posterior_probs_match_jax(kind):
    """Every (s, t) pair of the full and a skip ladder, with padded
    (all-zero) x_t rows that take the 1e-6 / 1e-5 guards."""
    d3pm, jd3pm = _d3pms(kind)
    rng = np.random.default_rng(3)
    x_t = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, L_LIG))]
    x_t[0, 6:] = 0.0
    x_t[2] = 0.0
    logits = (3 * rng.normal(size=(B, L_LIG, K))).astype(np.float32)
    pairs = d3pm.step_pairs(None) + d3pm.step_pairs(3)
    for s, t in pairs:
        want = np.asarray(jd3pm.posterior_probs(
            jnp.asarray(x_t), jnp.asarray(logits), s, t_int=t))
        got = d3pm.posterior_probs(torch.from_numpy(x_t),
                                   torch.from_numpy(logits), s, t_int=t)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_step_pairs_match_jax_ladder():
    d3pm = D3PMDiffusion.create(transitions.UniformTransition(K), 50, device="cpu")
    assert d3pm.step_pairs(None) == [(s, s + 1) for s in range(49, 0, -1)]
    ladder = np.round(np.linspace(49, 1, 10)).astype(int).tolist()
    assert d3pm.step_pairs(10) == list(zip(ladder, [50] + ladder[:-1]))
    assert len(d3pm.step_pairs(10)) + 1 == 11   # forwards per run


def _jax_draws(key, shape, n_pairs):
    """The draws of e3diff_tpu's sequence sampler, redrawn with its key
    splits (sampling/sequence.py:58-61, diffusion/d3pm.py:168-171): the
    one-hot x_init and each step's Gumbel noise, which
    jax.random.categorical adds to the log-probabilities."""
    key_init, k = jax.random.split(key)
    b, length, k_classes = shape
    x_init = jax.nn.one_hot(jax.random.randint(key_init, (b, length), 0, k_classes),
                            k_classes, dtype=jnp.float32)
    gumbel = []
    for _ in range(n_pairs):
        k, k_step = jax.random.split(k)
        gumbel.append(np.asarray(jax.random.gumbel(k_step, shape, jnp.float32)))
    return {"x_init": torch.from_numpy(np.array(x_init)),
            "gumbel": torch.from_numpy(np.stack(gumbel))}


@pytest.mark.parametrize("diverse,n_steps,scale,kind", [
    (False, None, 1.0, "uniform"), (True, None, 1.0, "uniform"),
    (True, 3, 1.0, "uniform"), (True, None, 1.5, "uniform"),
    (False, 3, 1.5, "blosum"), (True, None, 1.0, "blosum")])
def test_sampler_matches_jax_with_injected_draws(setup, diverse, n_steps,
                                                 scale, kind):
    """Full ladder, skip ladder and guided w=1.5, f32: the same x_init and
    Gumbel draws give identical final class indices on every valid token
    (the dead slot included)."""
    jmodel, tmodel, params, jb, tb = setup
    d3pm, jd3pm = _d3pms(kind)
    key = jax.random.PRNGKey(11)
    want = np.asarray(j_sampler(jmodel, jd3pm, diverse=diverse, n_steps=n_steps,
                                guidance_scale=scale)(params, jb, key))
    noise = _jax_draws(key, (B, L_LIG, K), len(d3pm.step_pairs(n_steps)))
    got = make_sequence_sampler(tmodel, d3pm, diverse=diverse, n_steps=n_steps,
                                guidance_scale=scale)(tb, noise=noise)
    assert got.shape == want.shape == (B, L_LIG, K)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_sampler_bf16_agreement_rate(setup):
    """bf16 compute, argmax sampling: near-ties in bf16 logits may flip a
    class and then the chain, so the final indices are held to a stated
    agreement rate with JAX's bf16 run, 0.75 of the tokens."""
    _, _, params, jb, tb = setup
    jmodel, tmodel = _models(params, jnp.bfloat16)
    d3pm, jd3pm = _d3pms("uniform")
    key = jax.random.PRNGKey(12)
    want = np.asarray(j_sampler(jmodel, jd3pm, diverse=False)(params, jb, key),
                      np.float32).argmax(-1)
    noise = _jax_draws(key, (B, L_LIG, K), len(d3pm.step_pairs(None)))
    got = make_sequence_sampler(tmodel, d3pm, diverse=False)(
        tb, noise={"x_init": noise["x_init"]}).float().argmax(-1).numpy()
    assert (got == want).mean() >= 0.75


def test_sampler_draws_from_a_generator(setup):
    _, tmodel, _, _, tb = setup
    d3pm, _ = _d3pms("uniform")
    run = make_sequence_sampler(tmodel, d3pm, n_steps=3)
    a = run(tb, generator=torch.Generator().manual_seed(0))
    b = run(tb, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="generator"):
        run(tb)
