"""The port's activation checkpointing (``remat``, models/blocks.py::
TransformerStack) on the CPU, at hidden 32, 4 heads, 2 layers.

* At dropout 0.1, every draw from one seeded generator: a step at
  ``layer`` and at ``dots`` gives the loss, every gradient, the metrics,
  the weights and the generator's final state of ``none`` bit for bit,
  for both denoisers (the same operations run again, on the same bits),
  and each stack layer really runs twice. One thread: the CPU path's
  table gradient is an indexed sum that several threads may round
  differently.
* At dropout 0, the port's remat step against the JAX package's remat
  (``nn.remat`` with the same policy) on the same numpy weights: the loss
  to 1e-5 and each gradient to 1e-4 in relative L2 norm, the tolerances
  of tests/test_torch_training.py.
* A tp=2 mesh of 2 processes (tests/_torch_parallel_worker.py, gloo):
  ``layer`` equals ``none`` bit for bit, the recompute's all-reduces
  included.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion.gaussian import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.sequence import SequenceDenoiser as JSequence
from e3diff_tpu.models.structure import StructureDenoiser as JStructure
from e3diff_tpu.training.sequence import sequence_losses as j_sequence_losses
from e3diff_tpu.training.structure import (
    structure_loss_terms as j_structure_loss_terms,
)
from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.models import (
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.models.blocks import TransformerLayer
from e3diff_tpu_torch.ops.transitions import BlosumTransition
from e3diff_tpu_torch.training import AdamW, SequenceTrainer, StructureTrainer
from e3diff_tpu_torch.training.optim import accumulated_grads
from e3diff_tpu_torch.utils.presets import ExperimentConfig, config_from_sidecar
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
B, L_REC, L_LIG, K = 4, 16, 8, 20
T_STRUCT, T_SEQ = 50, 6
SMALL = dict(hidden_size=32, num_heads=4, num_layers=2, intermediate_size=64,
             max_position_embeddings=16)
MODELS = {"structure": (StructureDenoiser, StructureTrainer, "torch_default"),
          "sequence": (SequenceDenoiser, SequenceTrainer, "xavier_all")}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _batch():
    """Ragged masks; row 3 a zero-padded slot."""
    rng = np.random.default_rng(0)
    lig_mask = (np.arange(L_LIG)[None] < np.array([8, 5, 2, 0])[:, None])
    rec_mask = (np.arange(L_REC)[None] < np.array([16, 9, 4, 0])[:, None])
    seq = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, L_LIG))]
    return {
        "ligand_seq": seq * lig_mask[..., None],
        "ligand_angles": rng.uniform(-np.pi, np.pi, (B, L_LIG, 8)).astype(
            np.float32),
        "ligand_attn_mask": lig_mask.astype(np.float32),
        "receptor_seq": np.eye(K, dtype=np.float32)[
            rng.integers(0, K, (B, L_REC))],
        "receptor_angles": rng.uniform(-np.pi, np.pi, (B, L_REC, 8)).astype(
            np.float32),
        "receptor_attn_mask": rec_mask.astype(np.float32),
    }


def _diffusion(kind):
    if kind == "structure":
        return GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu")
    return D3PMDiffusion.create(BlosumTransition(device="cpu"), T_SEQ,
                                device="cpu")


def _trainer(kind, remat, dropout, state_dict=None, **kw):
    model_cls, trainer_cls, init = MODELS[kind]
    enc = TransformerConfig(**SMALL, dropout=dropout,
                            attention_dropout=dropout, init_style=init,
                            remat=remat)
    model = model_cls(enc, dataclasses.replace(enc, add_cross_attention=True),
                      device="cpu", seed=None if state_dict else 0)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    opt = AdamW(dict(model.named_parameters()), base_lr=1e-3, max_epochs=1,
                steps_per_epoch=1)
    return trainer_cls(model, _diffusion(kind), opt,
                       generator=torch.Generator().manual_seed(5), **kw)


def _layer_calls(model) -> list[int]:
    """A counter of the stack layers' forward calls, recomputes too (a
    pre-hook: a recompute stops once it has what the backward needs, so
    it may never return)."""
    calls = [0]
    for m in model.modules():
        if isinstance(m, TransformerLayer):
            m.register_forward_pre_hook(
                lambda *_: calls.__setitem__(0, calls[0] + 1))
    return calls


def _run(kind, remat):
    """A loss and its gradients, then a train step of 2 microbatches,
    every draw (t, the noise, conditioning dropout, the dropout masks and
    attention seeds) from the trainer's generator."""
    trainer = _trainer(kind, remat, 0.1, accum_steps=2, cond_dropout=0.5)
    calls = _layer_calls(trainer.model)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    trainer.model.train()
    loss, aux, grads = accumulated_grads(trainer._loss,
                                         trainer.optimizer.params, batch, 1)
    metrics = trainer.train_step(batch)
    return dict(loss=loss, aux=aux, grads=grads, metrics=metrics,
                weights=[p.detach().clone() for p in trainer.optimizer.params],
                generator=trainer.generator.get_state(), calls=calls[0])


@pytest.mark.parametrize("remat", ["layer", "dots"])
@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_remat_reproduces_none_bit_for_bit(kind, remat, one_thread):
    """The recomputed layers draw the dropout bits their forward drew and
    leave the generator where the backward found it: everything equals
    ``none``'s bit for bit."""
    want, got = _run(kind, "none"), _run(kind, remat)
    assert torch.equal(got["loss"], want["loss"])
    for k in want["aux"]:
        assert torch.equal(got["aux"][k], want["aux"][k]), k
    for g, w in zip(got["grads"], want["grads"], strict=True):
        assert torch.equal(g, w)
    for k in want["metrics"]:
        assert torch.equal(got["metrics"][k], want["metrics"][k]), k
    for g, w in zip(got["weights"], want["weights"], strict=True):
        assert torch.equal(g, w)
    assert torch.equal(got["generator"], want["generator"])
    # each forward of a layer (1 + 2 microbatches) is run again in the
    # backward
    assert got["calls"] == 2 * want["calls"] > 0


@pytest.mark.parametrize("remat", ["layer", "dots"])
def test_remat_is_inert_without_a_gradient(remat):
    """Eval mode, or train mode under no_grad (the samplers, the eval
    step, serving): one call per layer and the output of ``none``."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    t = torch.tensor([3, 40, 7, 0])
    outs = []
    for r in ("none", remat):
        model = _trainer("structure", r, 0.0).model
        calls = _layer_calls(model)
        with torch.no_grad():
            for train in (False, True):
                model.train(train)
                outs.append(model(t, batch["ligand_angles"],
                                  batch["ligand_attn_mask"],
                                  batch["receptor_seq"],
                                  batch["receptor_angles"],
                                  batch["receptor_attn_mask"]))
        assert calls[0] == 2 * 2 * SMALL["num_layers"]
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def test_remat_policy_is_checked_and_read_from_a_sidecar():
    with pytest.raises(ValueError, match="remat"):
        _trainer("structure", "all", 0.0)
    cfg = config_from_sidecar(ExperimentConfig(),
                              {"remat": "dots", "scan_layers": True})
    assert cfg.remat == "dots" and not hasattr(cfg, "scan_layers")


# ------------------------------------------------------------ against JAX

def _jax_setup(kind, remat):
    enc = JConfig(**SMALL, dropout=0.0, attention_dropout=0.0,
                  init_style=MODELS[kind][2], remat=remat)
    dec = dataclasses.replace(enc, add_cross_attention=True)
    jmodel = (JStructure if kind == "structure" else JSequence)(enc, dec)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    args = ((jnp.zeros((B,), jnp.int32), jb["ligand_angles"])
            if kind == "structure" else
            (jnp.zeros((B, 1)), jb["ligand_seq"], jb["ligand_angles"]))
    args += (jb["ligand_attn_mask"], jb["receptor_seq"],
             jb["receptor_angles"], jb["receptor_attn_mask"])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *args)["params"]
    rng = np.random.default_rng(1)

    def draw(path, x):
        noise = rng.normal(size=x.shape).astype(np.float32)
        return (1 if path[-1].key == "scale" else 0) + 0.05 * noise

    return jmodel, jb, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("remat", ["layer", "dots"])
@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_remat_step_matches_jax_remat(kind, remat):
    """Dropout 0, injected draws: the loss and every parameter's gradient
    of the port's remat step against jax.value_and_grad through the JAX
    package's remat layers."""
    jmodel, jb, params = _jax_setup(kind, remat)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    if kind == "structure":
        t = np.array([3, T_STRUCT - 1, 17, 0], np.int32)
        noise = np.random.default_rng(4).normal(
            size=(B, L_LIG, 8)).astype(np.float32)
        jdiff = JDiffusion.cosine(T_STRUCT)

        def jloss(p):
            x_t = jdiff.q_sample(jb["ligand_angles"], t, noise)
            pred = jmodel.apply({"params": p}, jnp.asarray(t), x_t,
                                jb["ligand_attn_mask"], jb["receptor_seq"],
                                jb["receptor_angles"],
                                jb["receptor_attn_mask"])
            return jnp.mean(j_structure_loss_terms(
                pred, noise, jb["ligand_attn_mask"]))

        sd = structure_state_dict_from_jax
        draws = dict(t=torch.from_numpy(t).long(),
                     noise=torch.from_numpy(noise))
    else:
        from e3diff_tpu.diffusion.d3pm import D3PMDiffusion as JD3PM
        from e3diff_tpu.ops import transitions as j_transitions

        t_int = np.array([T_SEQ, 2, 0, 1], np.int32)
        key = jax.random.PRNGKey(11)
        jd = JD3PM.create(j_transitions.BlosumTransition(), T_SEQ)
        noised = jd.apply_aa_noise(key, jb["ligand_seq"], t_int)
        t_norm = (t_int.astype(np.float32) / T_SEQ)[:, None]

        def jloss(p):
            pred = jmodel.apply({"params": p}, jnp.asarray(t_norm), noised,
                                jb["ligand_angles"], jb["ligand_attn_mask"],
                                jb["receptor_seq"], jb["receptor_angles"],
                                jb["receptor_attn_mask"])
            return j_sequence_losses(pred, noised, jb["ligand_seq"],
                                     jb["ligand_attn_mask"])[0]

        sd = sequence_state_dict_from_jax
        draws = dict(t_int=torch.from_numpy(t_int).long(),
                     gumbel=torch.from_numpy(np.array(jax.random.gumbel(
                         key, jb["ligand_seq"].shape))))
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    trainer = _trainer(kind, remat, 0.0, state_dict=sd(params))
    trainer.model.train()
    loss, _ = trainer.loss(batch, **draws)
    grads = torch.autograd.grad(loss, trainer.optimizer.params)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5)
    jsd = sd(jgrads)
    for name, g in zip(trainer.optimizer.names, grads, strict=True):
        w = jsd[name]
        # relative to the norm plus 1e-2: the key biases' gradients are
        # zero in exact arithmetic (tests/test_torch_training.py)
        err = ((g - w).norm() / (w.norm() + 1e-2)).item()
        assert err <= 1e-4, (name, err)


# ------------------------------------------------------------ tp=2

def test_tp2_remat_layer_equals_none_bit_for_bit(tmp_path):
    """A structure step on 2 tp ranks (gloo, one thread each) at dropout
    0.1 and conditioning dropout 0.5, every draw from the generator:
    ``layer`` gives ``none``'s metrics, weights, moments, shards and next
    draw bit for bit."""
    base = _trainer("structure", "none", 0.1).model.state_dict()
    batch = _batch()
    cfg = dict(SMALL, dropout=0.1, attention_dropout=0.1,
               init_style="torch_default")
    common = dict(kind="structure", state_dict=base, lr=1e-3, accum_steps=2,
                  timesteps=T_STRUCT, cond_dropout=0.5, seed=5, batch=batch)
    torch.save({"train": {r: dict(common, cfg=dict(cfg, remat=r))
                          for r in ("none", "layer")}},
               tmp_path / "input.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", "1", "2", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        none, layer = got["none"], got["layer"]
        assert none["metrics"] == layer["metrics"]
        for part in ("params", "mu", "local"):
            assert none[part].keys() == layer[part].keys()
            for k, v in none[part].items():
                assert torch.equal(v, layer[part][k]), (r, part, k)
        assert torch.equal(none["next_draw"], layer["next_draw"])
