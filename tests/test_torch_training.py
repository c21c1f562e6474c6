"""The port's training slice (e3diff_tpu_torch.training and the training
ops it calls) against the JAX package, on the CPU, at a small size: hidden
128, 4 heads, 2 layers, max_pos 16, dropout 0 where gradients are compared.

Seeded random weights in the JAX models' trees (no zero-initialised layer
hides a path) cross through ``utils/weights.py``; a JAX gradient tree
crosses the same way. Tolerances: the losses and the forward noising in
f32 to 1e-6 (the same formulas, one rounding apart); the categorical draws
and conditioning dropout exactly (the same Gumbel noise and drop vector);
a model's loss to 1e-5 and each parameter's gradient to 1e-4 in relative
L2 norm (sums over 2 layers, 4 heads and the batch taken in other orders;
see _grad_rel_l2 for the gradients that are zero);
an AdamW update to 1e-6 absolute (updates of size ~lr = 1e-2); a trained
``final.pt`` read back by the JAX package gives its forward to 1e-4, as
the f32 forwards of tests/test_torch_structure.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from e3diff_tpu.diffusion.d3pm import D3PMDiffusion as JD3PM
from e3diff_tpu.diffusion.gaussian import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.diffusion.guidance import drop_conditioning as j_drop
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.sequence import SequenceDenoiser as JSequence
from e3diff_tpu.models.structure import StructureDenoiser as JStructure
from e3diff_tpu.ops import angles as j_angles
from e3diff_tpu.ops import transitions as j_transitions
from e3diff_tpu.ops.elbo import elbo_loss as j_elbo
from e3diff_tpu.training import optim as j_optim
from e3diff_tpu.training.sequence import sequence_losses as j_sequence_losses
from e3diff_tpu.training.structure import (
    structure_loss_terms as j_structure_loss_terms,
)
from e3diff_tpu.utils.torch_port import (
    port_sequence_state_dict,
    port_structure_state_dict,
)

from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
from e3diff_tpu_torch.data.prefetch import prefetch_to_device
from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.diffusion.guidance import drop_conditioning
from e3diff_tpu_torch.models import (
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.models.blocks import Dropout
from e3diff_tpu_torch.ops import angles
from e3diff_tpu_torch.ops.elbo import elbo_loss
from e3diff_tpu_torch.ops.transitions import BlosumTransition, UniformTransition
from e3diff_tpu_torch.serving import DesignEngine, pocket_record
from e3diff_tpu_torch.training import (
    AdamW,
    SequenceTrainer,
    StructureTrainer,
)
from e3diff_tpu_torch.training.checkpoint import BestTracker, CheckpointManager
from e3diff_tpu_torch.training.loop import train_loop
from e3diff_tpu_torch.training.optim import accumulated_grads, ema_update
from e3diff_tpu_torch.utils.params_io import cast_inference_params
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

B, L_REC, L_LIG, K = 3, 16, 8, 20
T_STRUCT, T_SEQ = 50, 6
SMALL = dict(hidden_size=128, num_heads=4, num_layers=2, intermediate_size=256,
             max_position_embeddings=16)


def _batch(seed=0):
    """Ragged masks; batch row 2 a dead slot, as the engine pads."""
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
    batch["ligand_seq"][lig_mask == 0] = 0.0
    return batch


def _random_params(init, seed, *args):
    """Seeded random weights in the model's JAX tree (shapes from
    jax.eval_shape, no compile): N(0, 0.05^2), about the spread of the
    reference's initialisation at this width, and LayerNorm scales
    1 + N(0, 0.05^2)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        noise = rng.normal(size=x.shape).astype(np.float32)
        return (1 if path[-1].key == "scale" else 0) + 0.05 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _configs(init_style):
    jenc = JConfig(**SMALL, init_style=init_style, dropout=0.0,
                   attention_dropout=0.0)
    tenc = TransformerConfig(**SMALL, init_style=init_style, dropout=0.0,
                             attention_dropout=0.0)
    return ((jenc, dataclasses.replace(jenc, add_cross_attention=True)),
            (tenc, dataclasses.replace(tenc, add_cross_attention=True)))


def _grad_rel_l2(trainer, loss, jgrads_sd):
    """Each parameter's L2 gradient error against the JAX gradient tree
    (by the port's parameter names), relative to the gradient's norm plus
    1e-2: the key biases' gradients are zero in exact arithmetic (a
    softmax does not see a constant added to a row), ~1e-9 in both
    packages, and differ by their whole size."""
    grads = torch.autograd.grad(loss, trainer.optimizer.params)
    errs = {}
    for name, g in zip(trainer.optimizer.names, grads):
        want = jgrads_sd[name]
        errs[name] = ((g - want).norm() / (want.norm() + 1e-2)).item()
    return errs


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("masked", [False, True])
def test_radian_losses_match_jax(masked):
    rng = np.random.default_rng(0)
    x = rng.uniform(-3 * np.pi, 3 * np.pi, (4, 7, 8)).astype(np.float32)
    y = rng.uniform(-np.pi, np.pi, (4, 7, 8)).astype(np.float32)
    mask = (rng.random((4, 7, 8)) < 0.6) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        angles.radian_l1_loss(tx, ty, mask=tm).item(),
        float(j_angles.radian_l1_loss(x, y, mask=mask)), atol=1e-6)
    for beta, penalty in ((np.pi / 10, 0.0), (1.0, 0.5)):
        np.testing.assert_allclose(
            angles.radian_smooth_l1_loss(tx, ty, beta=beta,
                                         circle_penalty=penalty,
                                         mask=tm).item(),
            float(j_angles.radian_smooth_l1_loss(
                x, y, beta=beta, circle_penalty=penalty, mask=mask)),
            atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_elbo_loss_matches_jax(masked):
    """Q11 kept: the one-hot target softmaxed, the prediction's entropy as
    the NLL term, torch's batchmean KL."""
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(3, 8, K)).astype(np.float32) * 3
    target = np.eye(K, dtype=np.float32)[rng.integers(0, K, (3, 8))]
    mask = rng.random((3, 8)) < 0.5 if masked else None
    got = elbo_loss(torch.from_numpy(pred), torch.from_numpy(target),
                    mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(j_elbo(pred, target, mask=mask)),
                               atol=1e-6)


def test_structure_loss_terms_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(B, L_LIG, 8)).astype(np.float32) * 2
    noise = rng.normal(size=(B, L_LIG, 8)).astype(np.float32)
    mask = _batch()["ligand_attn_mask"]
    from e3diff_tpu_torch.training.structure import structure_loss_terms

    got = structure_loss_terms(torch.from_numpy(pred), torch.from_numpy(noise),
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_structure_loss_terms(pred, noise, mask)), atol=1e-6)


# ------------------------------------------------------------ forward noising

def test_q_sample_and_noise_batch_match_jax():
    x0 = _batch()["ligand_angles"]
    rng = np.random.default_rng(3)
    t = rng.integers(0, T_STRUCT, B).astype(np.int32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    want = np.asarray(JDiffusion.cosine(T_STRUCT).q_sample(x0, t, noise))
    diff = GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu")
    tt, tn = torch.from_numpy(t).long(), torch.from_numpy(noise)
    got = diff.q_sample(torch.from_numpy(x0), tt, tn)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    t2, n2, x_t = diff.noise_batch(torch.from_numpy(x0), t=tt, noise=tn)
    assert t2 is tt and n2 is tn
    torch.testing.assert_close(x_t, got, atol=0, rtol=0)
    # drawn: t in [0, T), eps wrapped, reproducible from the generator
    draws = [diff.noise_batch(torch.from_numpy(x0),
                              generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    torch.testing.assert_close(draws[0][2], draws[1][2], atol=0, rtol=0)
    assert 0 <= draws[0][0].min() and draws[0][0].max() < T_STRUCT
    assert draws[0][1].abs().max() <= np.pi


@pytest.mark.parametrize("kind", ["uniform", "blosum"])
def test_apply_aa_noise_matches_jax_given_its_gumbel_draws(kind):
    """JAX's categorical draw is argmax(logits + gumbel(key)): the port,
    handed the same Gumbel noise, gives identical one-hots (padding rows
    to class 0)."""
    batch = _batch()
    lig = batch["ligand_seq"]
    t_int = np.array([0, 3, T_SEQ], np.int32)
    if kind == "uniform":
        jd, td = (JD3PM.create(j_transitions.UniformTransition(K), T_SEQ),
                  D3PMDiffusion.create(UniformTransition(K), T_SEQ, device="cpu"))
    else:
        jd = JD3PM.create(j_transitions.BlosumTransition(), T_SEQ)
        td = D3PMDiffusion.create(BlosumTransition(device="cpu"), T_SEQ,
                                  device="cpu")
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jd.apply_aa_noise(key, jnp.asarray(lig), t_int))
        gumbel = np.array(jax.random.gumbel(key, lig.shape))
        got = td.apply_aa_noise(torch.from_numpy(lig), torch.from_numpy(t_int),
                                gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(
            td.aa_noise_probs(torch.from_numpy(lig), torch.from_numpy(t_int)).numpy(),
            np.asarray(jd.aa_noise_probs(jnp.asarray(lig), t_int)), atol=1e-6)
    assert (got[2].argmax(-1) == 0).all() and (got[2].sum(-1) == 1).all()


@pytest.mark.parametrize("drop_ligand_angles", [False, True])
def test_drop_conditioning_matches_jax_given_the_drop_vector(drop_ligand_angles):
    batch = _batch()
    key = jax.random.PRNGKey(7)
    want = j_drop(key, 0.5, {k: jnp.asarray(v) for k, v in batch.items()},
                  drop_ligand_angles=drop_ligand_angles)
    drop = np.array(jax.random.bernoulli(key, 0.5, (B,)))
    got = drop_conditioning(0.5, {k: torch.from_numpy(v) for k, v in batch.items()},
                            drop=torch.from_numpy(drop),
                            drop_ligand_angles=drop_ligand_angles)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ----------------------------------------------------------- loss, gradients

@pytest.fixture(scope="module")
def structure_setup():
    (jenc, jdec), (tenc, tdec) = _configs("torch_default")
    jmodel = JStructure(jenc, jdec)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _random_params(
        jmodel.init, 1, jnp.zeros((B,), jnp.int32), jb["ligand_angles"],
        jb["ligand_attn_mask"], jb["receptor_seq"], jb["receptor_angles"],
        jb["receptor_attn_mask"])
    return jmodel, (tenc, tdec), params, batch


def _structure_trainer(cfgs, params, **kw):
    model = StructureDenoiser(*cfgs, device="cpu", seed=None)
    model.load_state_dict(structure_state_dict_from_jax(params), strict=True)
    opt = AdamW(dict(model.named_parameters()), base_lr=1e-2, max_epochs=1,
                steps_per_epoch=1)
    return StructureTrainer(model, GaussianAngleDiffusion.cosine(
        T_STRUCT, device="cpu"), opt, generator=torch.Generator().manual_seed(0),
        **kw)


def test_structure_loss_and_gradients_match_jax(structure_setup):
    """Dropout 0, injected t and noise: the loss, its 8 terms and every
    parameter's gradient against jax.value_and_grad."""
    jmodel, cfgs, params, batch = structure_setup
    rng = np.random.default_rng(4)
    t = np.array([3, T_STRUCT - 1, 17], np.int32)
    noise = rng.normal(size=(B, L_LIG, 8)).astype(np.float32)
    jdiff = JDiffusion.cosine(T_STRUCT)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        x_t = jdiff.q_sample(jb["ligand_angles"], t, noise)
        pred = jmodel.apply({"params": p}, jnp.asarray(t), x_t,
                            jb["ligand_attn_mask"], jb["receptor_seq"],
                            jb["receptor_angles"], jb["receptor_attn_mask"])
        terms = j_structure_loss_terms(pred, noise, jb["ligand_attn_mask"])
        return jnp.mean(terms), terms

    (want, want_terms), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    trainer = _structure_trainer(cfgs, params)
    trainer.model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = trainer.loss(tb, t=torch.from_numpy(t).long(),
                             noise=torch.from_numpy(noise))
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    np.testing.assert_allclose(aux["terms"].detach().numpy(),
                               np.asarray(want_terms), atol=1e-5)
    errs = _grad_rel_l2(trainer, loss, structure_state_dict_from_jax(jgrads))
    assert len(errs) == len(list(trainer.model.parameters()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


@pytest.fixture(scope="module")
def sequence_setup():
    (jenc, jdec), (tenc, tdec) = _configs("xavier_all")
    jmodel = JSequence(jenc, jdec)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _random_params(
        jmodel.init, 2, jnp.zeros((B, 1)), jb["ligand_seq"],
        jb["ligand_angles"], jb["ligand_attn_mask"], jb["receptor_seq"],
        jb["receptor_angles"], jb["receptor_attn_mask"])
    return jmodel, (tenc, tdec), params, batch


@pytest.mark.parametrize("cond_dropout", [0.0, 0.5])
def test_sequence_loss_and_gradients_match_jax(sequence_setup, cond_dropout):
    """Dropout 0, injected t in {0..T} and JAX's own Gumbel draws (and,
    with conditioning dropout, JAX's drop vector): the total loss, every
    logged metric and every parameter's gradient against
    jax.value_and_grad of the JAX trainer's loss."""
    jmodel, cfgs, params, batch = sequence_setup
    t_int = np.array([T_SEQ, 2, 0], np.int32)
    key = jax.random.PRNGKey(11)
    jd = JD3PM.create(j_transitions.BlosumTransition(), T_SEQ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = {}
    if cond_dropout:
        key_cfg = jax.random.PRNGKey(3)
        jb = j_drop(key_cfg, cond_dropout, jb, drop_ligand_angles=True)
        drop = np.array(jax.random.bernoulli(key_cfg, cond_dropout, (B,)))
        assert drop[:2].any() and not drop[:2].all()  # live rows both ways
        draws["cond_drop"] = torch.from_numpy(drop)
    noised = jd.apply_aa_noise(key, jb["ligand_seq"], t_int)
    t_norm = (t_int.astype(np.float32) / T_SEQ)[:, None]

    def jloss(p):
        pred = jmodel.apply({"params": p}, jnp.asarray(t_norm), noised,
                            jb["ligand_angles"], jb["ligand_attn_mask"],
                            jb["receptor_seq"], jb["receptor_angles"],
                            jb["receptor_attn_mask"])
        return j_sequence_losses(pred, noised, jb["ligand_seq"],
                                 jb["ligand_attn_mask"])

    (want, want_metrics), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    model = SequenceDenoiser(*cfgs, device="cpu", seed=None)
    model.load_state_dict(sequence_state_dict_from_jax(params), strict=True)
    trainer = SequenceTrainer(
        model, D3PMDiffusion.create(BlosumTransition(device="cpu"), T_SEQ,
                                    device="cpu"),
        AdamW(dict(model.named_parameters())), cond_dropout=cond_dropout,
        generator=torch.Generator().manual_seed(0))
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gumbel = np.array(jax.random.gumbel(key, batch["ligand_seq"].shape))
    loss, metrics = trainer.loss(tb, t_int=torch.from_numpy(t_int).long(),
                                 gumbel=torch.from_numpy(gumbel), **draws)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(metrics["avg_timestep"].item(), t_int.mean())
    errs = _grad_rel_l2(trainer, loss, sequence_state_dict_from_jax(jgrads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, (worst, errs[worst])


def _tiny_structure(dtype=torch.float32, **kw):
    """A 1-layer, hidden-64 StructureDenoiser with seeded weights."""
    enc = TransformerConfig(hidden_size=64, num_heads=4, num_layers=1,
                            intermediate_size=64, max_position_embeddings=16,
                            dtype=dtype, **kw)
    return StructureDenoiser(enc, dataclasses.replace(
        enc, add_cross_attention=True), device="cpu", seed=0)


def test_train_and_eval_steps_and_dropout():
    """train_step returns the metrics of JAX's names, grad_norm before
    clipping, and moves the weights (lr > 0 in epoch 0 with max_epochs 1);
    eval_step neither draws dropout nor moves them; dropout under train()
    draws from the trainer's generator, reproducibly."""
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    runs = []
    for _ in range(2):
        model = _tiny_structure(dropout=0.1, attention_dropout=0.1)
        trainer = StructureTrainer(
            model, GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu"),
            AdamW(dict(model.named_parameters()), base_lr=1e-2, max_epochs=1,
                  steps_per_epoch=1),
            ema_decay=0.9, generator=torch.Generator().manual_seed(0))
        before = [p.detach().clone() for p in trainer.optimizer.params]
        m = trainer.train_step(tb)
        runs.append(m)
        assert set(m) == {f"train_loss_{n}" for n in (
            "phi", "psi", "omega", "dihedral_o", "tau", "CA:C:1N",
            "1C:N:CA", "CA:C:O")} | {"train_loss", "grad_norm"}
        assert all(v.isfinite() for v in m.values())
        assert any(not torch.equal(b, p) for b, p in
                   zip(before, trainer.optimizer.params))
        # EMA: 0.9 before + 0.1 after
        torch.testing.assert_close(
            trainer.ema[0], 0.9 * before[0] + 0.1 * trainer.optimizer.params[0])
    for k in runs[0]:
        torch.testing.assert_close(runs[0][k], runs[1][k], atol=0, rtol=0)
    after = [p.detach().clone() for p in trainer.optimizer.params]
    v = trainer.eval_step(tb, t=torch.tensor([1, 2, 3]),
                          noise=torch.zeros(B, L_LIG, 8))
    assert "val_loss" in v and "val_loss_phi" in v
    assert all(torch.equal(a, p) for a, p in zip(after, trainer.optimizer.params))
    assert not trainer.model.training
    with pytest.raises(TypeError, match="unknown injected"):
        trainer.train_step(tb, gumbel=torch.zeros(1))


def test_structure_trainer_dropout_reproduces_from_one_seed():
    """Three train steps at dropout 0.1 (the attention dropout drawn from a
    seed per call, the hidden Dropout modules by torch.rand, all from the
    trainer's generator) give the same losses for two runs from one
    generator seed, and other losses from another seed."""
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def losses(seed):
        model = _tiny_structure(dropout=0.1, attention_dropout=0.1)
        trainer = StructureTrainer(
            model, GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu"),
            AdamW(dict(model.named_parameters()), base_lr=1e-3,
                  max_epochs=1, steps_per_epoch=3),
            generator=torch.Generator().manual_seed(seed))
        return [trainer.train_step(tb)["train_loss"].item() for _ in range(3)]

    first = losses(0)
    assert np.isfinite(first).all()
    assert losses(0) == first
    assert losses(1) != first


def test_dropout_module_and_storage_guard():
    d = Dropout(0.25)
    d.generator = torch.Generator().manual_seed(0)
    x = torch.ones(4, 1000)
    d.eval()
    assert d(x) is x
    d.train()
    y = d(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < kept.float().mean().item() < 0.8
    model = _tiny_structure()
    cast_inference_params(model, "int8_matmul")
    model.train()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(RuntimeError, match="do not train"):
        model(torch.zeros(B, dtype=torch.long), b["ligand_angles"],
              b["ligand_attn_mask"], b["receptor_seq"], b["receptor_angles"],
              b["receptor_attn_mask"])


def test_bf16_train_step_keeps_f32_master_weights():
    model = _tiny_structure(torch.bfloat16)
    trainer = StructureTrainer(
        model, GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu"),
        AdamW(dict(model.named_parameters()), base_lr=1e-3, max_epochs=1,
              steps_per_epoch=1, mu_dtype="bf16"),
        generator=torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    losses = [trainer.train_step(tb)["train_loss"].item() for _ in range(3)]
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.bfloat16 for m in trainer.optimizer.mu)


# ------------------------------------------------------------------ optimizer

def _opt_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"dense.weight": (5, 3), "dense.bias": (5,), "norm.weight": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # norms of about 3 (clipped) and 0.3 (not) in turn
    grads = [{k: (rng.normal(size=s) * (0.8 if i % 2 == 0 else 0.08)).astype(
        np.float32) for k, s in shapes.items()} for i in range(5)]
    return params, grads


@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_adamw_matches_optax(mu_dtype):
    """Five updates against make_optimizer: clipping on every other step,
    Q12's epoch-0 learning rate of 0 (steps 0-1 at 2 steps per epoch), then
    epoch 1 and 2; the Fourier W (JAX only: a buffer in the port) stays
    undecayed and still."""
    params, grads = _opt_case(0)
    jparams = {"layer": {k: jnp.asarray(v) for k, v in params.items()},
               "timestep_projector": {"W": jnp.ones(4)}}
    kw = dict(base_lr=1e-2, weight_decay=0.1, max_epochs=10,
              steps_per_epoch=2, grad_clip=1.0, mu_dtype=mu_dtype)
    tx = j_optim.make_optimizer(jparams, **kw)
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = AdamW(tparams, **kw)
    for step, g in enumerate(grads):
        jg = {"layer": {k: jnp.asarray(v) for k, v in g.items()},
              "timestep_projector": {"W": jnp.zeros(4)}}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.step([torch.from_numpy(g[k]) for k in opt.names])
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for k in opt.names:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams["layer"][k]),
                                       atol=1e-6, err_msg=f"step {step} {k}")
            if step < 2:  # epoch 0: learning rate 0, the weights stay
                np.testing.assert_array_equal(tparams[k].detach().numpy(),
                                              params[k])
    np.testing.assert_array_equal(np.asarray(jparams["timestep_projector"]["W"]),
                                  np.ones(4))
    assert opt.count == len(grads)
    assert all(m.dtype == (torch.bfloat16 if mu_dtype == "bf16" else torch.float32)
               for m in opt.mu)
    # a resume carries the moments and the count
    again = AdamW({k: torch.nn.Parameter(v.detach().clone())
                   for k, v in tparams.items()}, **kw)
    again.load_state_dict(opt.state_dict())
    assert again.count == opt.count
    for a, b in zip(again.mu + again.nu, opt.mu + opt.nu):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_schedule_matches_jax():
    from e3diff_tpu_torch.training.optim import linear_warmup_per_epoch

    for max_epochs, spe in ((350, 250), (10, 3), (1, 4)):
        ours = linear_warmup_per_epoch(5e-5, max_epochs, spe)
        ref = j_optim.linear_warmup_per_epoch(5e-5, max_epochs, spe)
        for step in (0, spe - 1, spe, 7 * spe + 1, max_epochs * spe):
            np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                       rtol=1e-6, atol=1e-12)
    assert linear_warmup_per_epoch(5e-5, 350, 250)(249) == 0.0   # Q12


def test_accumulated_grads_and_ema_match_jax():
    """n = 2 interleaved microbatches: the mean loss, aux and gradients of
    accumulated_value_and_grad; and ema_update."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    m = np.array([1, 1, 0, 1], np.float32)
    w0 = rng.normal(size=(3, 2)).astype(np.float32)

    def jloss(p, b, _):
        r = ((b["x"] @ p["w"] - b["y"]) ** 2).sum(-1) * b["m"]
        return r.sum() / jnp.maximum(b["m"].sum(), 1.0), {"r0": r[0]}

    (jl, jaux), jg = j_optim.accumulated_value_and_grad(
        jloss, {"w": jnp.asarray(w0)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y), "m": jnp.asarray(m)},
        jax.random.PRNGKey(0), 2)
    w = torch.from_numpy(w0.copy()).requires_grad_()

    def tloss(b):
        r = ((b["x"] @ w - b["y"]) ** 2).sum(-1) * b["m"]
        return r.sum() / torch.clamp(b["m"].sum(), min=1.0), {"r0": r[0]}

    loss, aux, grads = accumulated_grads(
        tloss, [w], {k: torch.from_numpy(v) for k, v in
                     {"x": x, "y": y, "m": m}.items()}, 2)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(aux["r0"].item(), float(jaux["r0"]), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg["w"]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        accumulated_grads(tloss, [w], {"x": torch.zeros(3, 3)}, 2)
    ema = [torch.from_numpy(w0.copy())]
    ema_update(ema, [torch.from_numpy(x[:3, :2].copy())], 0.99)
    np.testing.assert_allclose(ema[0].numpy(), np.asarray(j_optim.ema_update(
        {"w": w0}, {"w": x[:3, :2]}, 0.99)["w"]), rtol=1e-6)


# ------------------------------------------------- checkpoints, loop, CLIs

def test_best_tracker_modes(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    for mode, want in (("max", 3.0), ("min", 1.0)):
        best = BestTracker(manager, mode=mode, name=f"best_{mode}")
        saved = [best.update({"val_loss": v}, lambda v=v: {"v": torch.tensor(v)})
                 for v in (2.0, 3.0, 1.0)]
        assert best.best == want
        assert manager.load(f"best_{mode}")["v"].item() == want
        assert saved == ([True, True, False] if mode == "max"
                         else [True, False, True])
    with pytest.raises(ValueError, match="max or min"):
        BestTracker(manager, mode="best")


def test_prefetch_keeps_order_and_reraises():
    batches = [{"a": np.full((2,), i), "num_valid": 2} for i in range(5)]
    got = [b["a"][0].item() for b in prefetch_to_device(iter(batches), "cpu")]
    assert got == list(range(5))

    def broken():
        yield batches[0]
        raise KeyError("source failed")

    it = prefetch_to_device(broken(), "cpu")
    assert "num_valid" not in next(it)
    with pytest.raises(KeyError, match="source failed"):
        next(it)


def test_train_loop_refuses_an_empty_epoch(structure_setup, tmp_path):
    _, cfgs, params, _ = structure_setup
    trainer = _structure_trainer(cfgs, params)
    with pytest.raises(ValueError, match="no batch"):
        train_loop(trainer, lambda epoch: iter([]), None, max_epochs=1,
                   device="cpu", ckpt_dir=str(tmp_path), log_fn=lambda s: None)


TINY = ["--synthetic", "--synthetic_n", "16", "--device", "cpu",
        "--hidden_size", "32", "--num_heads", "4", "--num_hidden_layers", "1",
        "--intermediate_size", "64", "--max_seq_len", "64",
        "--ligand_max_len", "16", "--batch_size", "4", "--bf16", "false",
        "--ema_decay", "0.9"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both train CLIs, one epoch on synthetic complexes, f32 on the
    CPU."""
    from e3diff_tpu_torch.cli.train_sequence import main as train_sequence
    from e3diff_tpu_torch.cli.train_structure import main as train_structure

    root = tmp_path_factory.mktemp("runs")
    hist = {"structure": train_structure(
        TINY + ["--max_epochs", "1", "--timesteps", "20",
                "--ckpt_dir", str(root / "structure")]),
        "sequence": train_sequence(
        TINY + ["--max_epochs", "1", "--timesteps", "6",
                "--ckpt_dir", str(root / "sequence")])}
    return root, hist


def test_train_clis_write_every_slot_and_history(trained):
    root, hist = trained
    for kind in ("structure", "sequence"):
        d = root / kind
        for slot in ("last", "best_val_model", "final", "final_ema"):
            assert (d / f"{slot}.pt").is_file(), (kind, slot)
        cfg = json.loads((d / "config.json").read_text())
        assert cfg["hidden_size"] == 32 and cfg["ema_decay"] == 0.9
        h = json.loads((d / "history.json").read_text())
        assert [r["epoch"] for r in h] == [0] == [r["epoch"] for r in hist[kind]]
        assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                   and np.isfinite(r["grad_norm"]) for r in h)
        last = torch.load(d / "last.pt", weights_only=True)
        assert last["epoch"] == 0 and last["trainer"]["optimizer"]["count"] > 0


def test_train_cli_resumes_and_refuses_another_run(trained, capsys):
    from e3diff_tpu_torch.cli.train_structure import main as train_structure

    root, _ = trained
    d = str(root / "structure")
    args = TINY + ["--timesteps", "20", "--ckpt_dir", d]
    assert train_structure(args + ["--max_epochs", "1"]) == []
    assert "no epochs to run" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="different configuration"):
        train_structure(args + ["--max_epochs", "2", "--hidden_size", "64"])
    # a field whose flag is not given is adopted from the run's sidecar
    bare = list(args)
    i = bare.index("--num_heads")
    del bare[i:i + 2]
    h = train_structure(bare + ["--max_epochs", "2"])
    assert [r["epoch"] for r in h] == [1]
    assert "adopted from config.json: num_heads=4" in capsys.readouterr().out


def test_final_checkpoints_serve_and_cross_to_jax(trained):
    """final.pt loads into the port (strict), into DesignEngine, and into
    the JAX package through port_*_state_dict with the same forward."""
    root, _ = trained
    s_path, q_path = (str(root / k / "final.pt") for k in ("structure", "sequence"))
    eng = DesignEngine.from_checkpoints(s_path, q_path, device="cpu",
                                        batch_size=2, sampler="ddim",
                                        ddim_steps=2)
    rng = np.random.default_rng(0)
    out = eng.design(pocket_record("ACDEFGHIKLMN", rng.uniform(
        -np.pi, np.pi, (12, 8)).astype(np.float32), 6), n_designs=2,
        generator=torch.Generator().manual_seed(1))
    assert [len(r.sequence) for r in out] == [6, 6]
    assert all(np.isfinite(r.angles).all() for r in out)

    enc = JConfig(hidden_size=32, num_heads=4, num_layers=1,
                  intermediate_size=64, max_position_embeddings=64)
    dec = dataclasses.replace(enc, add_cross_attention=True)
    batch = _batch(3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # structure
    sd = torch.load(s_path, weights_only=True)
    jparams = port_structure_state_dict({k: v.numpy() for k, v in sd.items()},
                                        num_enc_layers=1, num_dec_layers=1)
    t = np.array([0, 7, 19], np.int32)
    want = JStructure(enc, dec).apply(
        {"params": jparams}, jnp.asarray(t), batch["ligand_angles"],
        batch["ligand_attn_mask"], batch["receptor_seq"],
        batch["receptor_angles"], batch["receptor_attn_mask"])
    with torch.no_grad():
        got = eng.structure_model(torch.from_numpy(t).long(), tb["ligand_angles"],
                                  tb["ligand_attn_mask"], tb["receptor_seq"],
                                  tb["receptor_angles"], tb["receptor_attn_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # sequence
    sd = torch.load(q_path, weights_only=True)
    jenc = dataclasses.replace(enc, init_style="xavier_all")
    jparams = port_sequence_state_dict({k: v.numpy() for k, v in sd.items()},
                                       num_dec_layers=1)
    tq = np.array([[6.0], [2.0], [0.0]], np.float32)
    args = (batch["ligand_seq"], batch["ligand_angles"], batch["ligand_attn_mask"],
            batch["receptor_seq"], batch["receptor_angles"],
            batch["receptor_attn_mask"])
    want = JSequence(jenc, dataclasses.replace(
        jenc, add_cross_attention=True)).apply({"params": jparams},
                                               jnp.asarray(tq), *args)
    with torch.no_grad():
        got = eng.sequence_model(torch.from_numpy(tq),
                                 *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sample_cli_adopts_the_trained_sidecar(trained, tmp_path, capsys):
    """A port-trained hidden-32 final.pt samples through
    cli.sample_structure with no width flags: the sidecar's widths, data
    shapes (pocket_ext 4) and timesteps are adopted, as the JAX package's
    sampling scripts adopt them; an explicit --pocket_ext 0 wins."""
    from e3diff_tpu_torch.cli.sample_structure import main as sample

    root, _ = trained
    run = ["--synthetic", "--device", "cpu", "--ckpt",
           str(root / "structure" / "final.pt"), "--batch_size", "4",
           "--sampler", "ddim", "--ddim_steps", "2", "--no_trajectory"]
    ds = {ext: LigandBindingSiteData(synthetic_complexes(n=32), "test", 64,
                                     ext, 16) for ext in (0, 4)}
    assert not np.array_equal(ds[0].arrays["receptor_attn_mask"],
                              ds[4].arrays["receptor_attn_mask"])
    results = sample(run + ["--output", str(tmp_path / "a.pkl")])
    out = capsys.readouterr().out
    for field in ("pocket_ext=4", "hidden_size=32", "num_heads=4",
                  "num_hidden_layers=1", "intermediate_size=64",
                  "ligand_max_len=16", "timesteps=20"):
        assert field in out, (field, out)
    assert [a.shape for a in results] == [
        (n, 8) for n in ds[4].arrays["ligand_length"][:4]]
    assert all(np.isfinite(a).all() for a in results)
    sample(run + ["--pocket_ext", "0", "--output", str(tmp_path / "b.pkl")])
    out = capsys.readouterr().out
    assert "hidden_size=32" in out and "pocket_ext" not in out


def test_pipeline_cli_refuses_mismatched_sidecars(trained, tmp_path):
    """run_pipeline holds the two checkpoints' sidecars to SHARED_FIELDS,
    as DesignEngine.from_checkpoints does."""
    from e3diff_tpu_torch.cli.run_pipeline import main as pipeline

    root, _ = trained
    seq_dir = tmp_path / "sequence"
    seq_dir.mkdir()
    side = json.loads((root / "sequence" / "config.json").read_text())
    (seq_dir / "config.json").write_text(json.dumps(
        dict(side, pocket_ext=side["pocket_ext"] + 1)))
    (seq_dir / "final.pt").write_bytes(
        (root / "sequence" / "final.pt").read_bytes())
    with pytest.raises(SystemExit):
        pipeline(["--synthetic", "--device", "cpu", "--structure_ckpt",
                  str(root / "structure" / "final.pt"), "--sequence_ckpt",
                  str(seq_dir / "final.pt"), "--outdir", str(tmp_path / "o")])
    with pytest.raises(ValueError, match="disagree on pocket_ext"):
        DesignEngine.from_checkpoints(
            str(root / "structure" / "final.pt"), str(seq_dir / "final.pt"),
            device="cpu")


def test_adopt_ckpt_config_matches_jax(trained):
    """The port's adopt_ckpt_config and the JAX package's agree on one
    sidecar: the same fields adopted, an explicit flag kept."""
    import argparse

    from e3diff_tpu.utils import presets as jp
    from e3diff_tpu_torch.utils import presets as tp

    root, _ = trained
    ckpt = str(root / "structure" / "final.pt")
    argv = ["--num_heads", "12"]
    got = {}
    for mod in (tp, jp):
        parser = mod.add_config_flags(argparse.ArgumentParser(),
                                      mod.structure_sample_config())
        cfg = mod.config_from_args(parser.parse_args(argv))
        got[mod] = mod.adopt_ckpt_config(cfg, parser, ckpt, argv=argv)[1]
    assert got[tp] == got[jp]
    assert got[tp]["hidden_size"] == 32 and got[tp]["pocket_ext"] == 4
    assert "num_heads" not in got[tp]


@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_train_clis_default_to_the_card(kind, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    mod = __import__(f"e3diff_tpu_torch.cli.train_{kind}", fromlist=["main"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(["--synthetic", "--ckpt_dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()

