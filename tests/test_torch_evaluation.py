"""The port's evaluation module (e3diff_tpu_torch/utils/evaluation.py)
against the JAX package's, on the CPU, and the by-distribution check the
ROADMAP's North star asks for.

Every evaluation function takes the same seeded inputs in both packages
(numpy arrays, and CPU tensors on the port's side) and agrees to 1e-12,
``geometry_summary`` too.

The distribution check: one small structure model (hidden 32, one layer,
its head's output bias set apart per feature so that each feature's
sampled distribution is distinct), carried across, samples DDPM-20 in each
package with that package's own RNG; the port's ``histogram_distance``
compares the pooled samples. A model with the head's outputs permuted
across features is the control that must land above the bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion.gaussian import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.structure import StructureDenoiser as JModel
from e3diff_tpu.sampling.structure import make_structure_sampler as j_sampler
from e3diff_tpu.utils import evaluation as j_eval
from e3diff_tpu.utils.torch_port import port_structure_state_dict

from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion
from e3diff_tpu_torch.models.config import TransformerConfig
from e3diff_tpu_torch.models.structure import StructureDenoiser
from e3diff_tpu_torch.sampling.structure import make_structure_sampler
from e3diff_tpu_torch.utils import evaluation

TOL = 1e-12


def _angle_sets(seed, n=12):
    """Per-sample (len_i, 8) angle matrices like real backbones' (dihedrals
    uniform, bond angles near their means), one too short for geometry."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = 2 if i == 0 else int(rng.integers(4, 15))
        out.append(np.concatenate(
            [rng.uniform(-np.pi, np.pi, (k, 4)),
             rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (k, 4))], axis=1))
    return out


def _assert_close(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_close(got[k], want[k])
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_elementwise_scores_match_jax(as_tensor):
    rng = np.random.default_rng(0)
    wrap = torch.from_numpy if as_tensor else (lambda x: x)
    pred, true = rng.integers(0, 20, 64), rng.integers(0, 20, 64)
    mask = rng.integers(0, 2, 64)
    _assert_close(evaluation.recovery_rate(wrap(pred), wrap(true), wrap(mask)),
                  j_eval.recovery_rate(pred, true, mask))
    _assert_close(evaluation.recovery_rate(pred, true, np.zeros(64)),
                  j_eval.recovery_rate(pred, true, np.zeros(64)))
    a, b = rng.uniform(-4, 4, (50, 8)), rng.uniform(-4, 4, (50, 8))
    _assert_close(evaluation.mean_wrapped_angle_error(wrap(a), wrap(b)),
                  j_eval.mean_wrapped_angle_error(a, b))
    pooled = rng.uniform(-np.pi, np.pi, (700, 8))
    other = np.clip(rng.normal(0.5, 1.0, (500, 8)), -np.pi, np.pi)
    for bins in (12, 36):
        _assert_close(evaluation.angle_histograms(wrap(pooled), bins),
                      j_eval.angle_histograms(pooled, bins))
        _assert_close(evaluation.histogram_distance(wrap(pooled), other, bins),
                      j_eval.histogram_distance(pooled, other, bins))
    for i, j in ((0, 1), (2, 3)):
        _assert_close(
            evaluation.joint_histogram_distance(wrap(pooled), wrap(other), i, j),
            j_eval.joint_histogram_distance(pooled, other, i, j))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_backbone_scores_match_jax(as_tensor):
    from e3diff_tpu.geometry.chain import backbone_coords_from_angles

    wrap = torch.from_numpy if as_tensor else (lambda x: x)
    for s in _angle_sets(1):
        coords = backbone_coords_from_angles(s)
        _assert_close(evaluation.backbone_clash_fraction(wrap(coords)),
                      j_eval.backbone_clash_fraction(coords))
        _assert_close(evaluation.backbone_clash_fraction(wrap(coords), 3.5),
                      j_eval.backbone_clash_fraction(coords, 3.5))
        _assert_close(evaluation.radius_of_gyration(wrap(coords)),
                      j_eval.radius_of_gyration(coords))
    bad = np.full((16, 3), np.nan)
    _assert_close(evaluation.backbone_clash_fraction(bad),
                  j_eval.backbone_clash_fraction(bad))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_summaries_match_jax(as_tensor):
    sampled, reference = _angle_sets(2), _angle_sets(3, n=9)
    # a folded-through chain: the clash fraction must read it
    sampled.append(np.tile([0.0, 0.0, np.pi, 0.0, 1.94, 2.03, 2.13, 2.1],
                           (14, 1)))
    wrap = ((lambda xs: [torch.from_numpy(x) for x in xs]) if as_tensor
            else (lambda xs: xs))
    _assert_close(evaluation.summarize_samples(wrap(sampled), wrap(reference)),
                  j_eval.summarize_samples(sampled, reference))
    got = evaluation.geometry_summary(wrap(sampled))
    want = j_eval.geometry_summary(sampled)
    assert got["clash_fraction_mean"] > 0
    _assert_close(got, want)
    nan_set = [np.full((5, 8), np.nan)]
    _assert_close(evaluation.geometry_summary(nan_set),
                  j_eval.geometry_summary(nan_set))


# ------------------------------------------------------------ by distribution

N_SAMPLES, L_LIG, L_REC, T_STEPS = 1024, 8, 8, 20
SMALL = dict(hidden_size=32, num_heads=4, num_layers=1, intermediate_size=64,
             max_position_embeddings=16)
# the head's output bias per feature: each feature drifts to its own place
HEAD_BIAS = torch.tensor([-1.2, -0.8, -0.4, 0.0, 0.4, 0.8, 1.2, 1.6])
# bound on the per-feature TV between the two packages' pooled samples
# (8192 residues a side, 36 bins). Measured on the CPU: the two packages
# differ by 0.028-0.041 per feature (their RNGs' noise), the permuted
# control by 0.29-0.58 on every feature but the one whose swapped bias is
# nearest its own (0.069)
TV_BOUND = 0.1


def _dist_batch():
    rng = np.random.default_rng(11)
    return {
        "ligand_angles": np.zeros((N_SAMPLES, L_LIG, 8), np.float32),
        "ligand_attn_mask": np.ones((N_SAMPLES, L_LIG), np.float32),
        "receptor_seq": np.eye(20, dtype=np.float32)[
            rng.integers(0, 20, (N_SAMPLES, L_REC))],
        "receptor_angles": rng.uniform(
            -np.pi, np.pi, (N_SAMPLES, L_REC, 8)).astype(np.float32),
        "receptor_attn_mask": np.ones((N_SAMPLES, L_REC), np.float32),
    }


def _model(state_dict=None):
    tenc = TransformerConfig(**SMALL)
    model = StructureDenoiser(
        tenc, dataclasses.replace(tenc, add_cross_attention=True),
        device="cpu", seed=None if state_dict else 0)
    if state_dict:
        model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def distribution_samples():
    """Pooled (N_SAMPLES * L_LIG, 8) samples of the JAX package and of the
    port from one model, and of the port from the permuted control. The
    weights are the port's seeded ones, perturbed (the zero-initialised
    adaLN layer would otherwise cut the timestep out), carried to JAX by
    its own torch-checkpoint loader."""
    gen = torch.Generator().manual_seed(1)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in _model().state_dict().items()}
    sd["angles_predictor.dense2.bias"] = HEAD_BIAS.clone()
    perm = torch.arange(7, -1, -1)
    permuted = dict(sd)
    for k in ("angles_predictor.dense2.weight",
              "angles_predictor.dense2.bias"):
        permuted[k] = sd[k][perm]
    batch = _dist_batch()

    jenc = JConfig(**SMALL)
    jmodel = JModel(jenc, dataclasses.replace(jenc, add_cross_attention=True))
    params = port_structure_state_dict(
        {k: v.numpy() for k, v in sd.items()}, 1, 1)
    jrun = j_sampler(jmodel, JDiffusion.cosine(T_STEPS),
                     return_trajectory=False, sampler="ddpm")
    j_out, _ = jrun(jax.tree.map(jnp.asarray, params),
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(3))

    diffusion = GaussianAngleDiffusion.cosine(T_STEPS, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ports = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers at once
    try:
        for name, weights in (("model", sd), ("permuted", permuted)):
            run = make_structure_sampler(_model(weights), diffusion,
                                         sampler="ddpm",
                                         return_trajectory=False)
            out, _ = run(tb, generator=torch.Generator().manual_seed(5))
            ports[name] = out.numpy().reshape(-1, 8)
    finally:
        torch.set_num_threads(threads)
    return np.asarray(j_out).reshape(-1, 8), ports


def test_samples_match_jax_by_distribution(distribution_samples):
    jax_pool, ports = distribution_samples
    same = evaluation.histogram_distance(ports["model"], jax_pool)
    control = evaluation.histogram_distance(ports["permuted"], jax_pool)
    print(f"per-feature TV: port against JAX {same.round(4).tolist()}, "
          f"permuted control {control.round(4).tolist()}")
    assert same.max() <= TV_BOUND, same
    assert control.max() > TV_BOUND, control
    # the features' distributions differ, so a swap of features is seen
    assert control.mean() > 2 * same.mean(), (same, control)
