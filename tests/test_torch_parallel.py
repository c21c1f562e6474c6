"""The port's multi-device path (e3diff_tpu_torch/parallel, the
tensor-parallel blocks, the mesh-aware trainers, samplers and train CLI)
against the JAX package and against the port's own one-process path, on
the CPU over gloo.

A dp=2 x tp=2 world of 4 spawned processes (tests/_torch_parallel_worker.py,
which imports no JAX; rendezvous through a file, as xdist runs workers side
by side) takes one structure and one sequence train step with accum_steps
2 at hidden 32, 2 layers, 4 heads, on a global batch of 8 whose two dp
halves hold very different token counts, so that the global denominators
are what is tested. Tolerances:

* against JAX's single-device ``train_step`` at dropout 0, fed the draws
  JAX makes inside it: the loss, its parts and the grad norm to 1e-5; the
  first moments (0.1 of the clipped gradient) per tensor to 1e-4 in
  relative L2 (as tests/test_torch_training.py holds gradients); the
  weights to 1e-6 where the gradient is above 1e-5, and to the learning
  rate elsewhere: Adam's first step moves a weight by lr g / (|g| + 1e-8),
  which for a gradient near 1e-8 (zero in exact arithmetic, as the key
  biases' are) is set by the rounding of g;
* against the port's one-process step at dropout 0.1 (every draw from one
  seeded generator): the same tolerances; the generators' next draws
  equal; the dp replicas, and the tp ranks' replicated tensors (the
  distance tables among them), bit for bit;
* tp=2 sampling against JAX's samplers on the same injected noise, in f32
  and int8 storage: the structure sampler's DDIM-5 to 5e-3 in wrapped
  angle and the sequence sampler's argmax exactly with logits to 1e-3, as
  tests/test_torch_structure.py and test_torch_sequence.py hold the
  one-process samplers; the tp ranks' outputs bit for bit.

Beside them: the sharding rules against JAX's, the multihost helpers
against JAX's, DesignEngine(mesh=) in the same world, and the train and
serve CLIs in 2 processes over gloo.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import types
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion.d3pm import D3PMDiffusion as JD3PM
from e3diff_tpu.diffusion.gaussian import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.diffusion.gaussian import sample_wrapped_noise as j_wrapped
from e3diff_tpu.models.config import TransformerConfig as JConfig
from e3diff_tpu.models.sequence import SequenceDenoiser as JSequence
from e3diff_tpu.models.structure import StructureDenoiser as JStructure
from e3diff_tpu.ops import transitions as j_transitions
from e3diff_tpu.parallel import mesh as j_mesh
from e3diff_tpu.parallel import multihost as j_multihost
from e3diff_tpu.sampling.sequence import make_sequence_sampler as j_seq_sampler
from e3diff_tpu.sampling.structure import make_structure_sampler as j_sampler
from e3diff_tpu.training import SequenceTrainer as JSequenceTrainer
from e3diff_tpu.training import StructureTrainer as JStructureTrainer
from e3diff_tpu.training.sequence import TrainState as JSequenceState
from e3diff_tpu.training.structure import TrainState as JStructureState
from e3diff_tpu.training.optim import make_optimizer
from e3diff_tpu.utils.params_io import cast_inference_params as j_cast
from e3diff_tpu.utils.quant import dequantize_params

from e3diff_tpu_torch.diffusion import D3PMDiffusion, GaussianAngleDiffusion
from e3diff_tpu_torch.models import (
    SequenceDenoiser,
    StructureDenoiser,
    TransformerConfig,
)
from e3diff_tpu_torch.ops import angles
from e3diff_tpu_torch.ops.transitions import BlosumTransition
from e3diff_tpu_torch.parallel import mesh as t_mesh
from e3diff_tpu_torch.parallel import multihost as t_multihost
from e3diff_tpu_torch.sampling.graphs import check_capturable
from e3diff_tpu_torch.serving import DesignEngine, pocket_record
from e3diff_tpu_torch.training import (
    AdamW,
    SequenceTrainer,
    StructureTrainer,
)
from e3diff_tpu_torch.utils.params_io import cast_inference_params
from e3diff_tpu_torch.utils.weights import (
    sequence_state_dict_from_jax,
    structure_state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
B, L_REC, L_LIG, K = 8, 12, 8, 20
DP, TP, ACCUM = 2, 2, 2
T_STRUCT, T_SEQ, DDIM_STEPS = 50, 6, 5
LR = 1e-3
RNG = jax.random.PRNGKey(42)
SMALL = dict(hidden_size=32, num_heads=4, num_layers=2, intermediate_size=64,
             max_position_embeddings=16)


def _batch():
    """Rows 0-3 (dp rank 0) long peptides and pockets, rows 4-7 short
    ones: the two ranks' token counts differ about threefold."""
    rng = np.random.default_rng(0)
    lig_len = [8, 7, 8, 6, 3, 2, 4, 1]
    rec_len = [12, 10, 12, 9, 5, 6, 4, 3]
    lig_mask = (np.arange(L_LIG)[None] < np.array(lig_len)[:, None])
    rec_mask = (np.arange(L_REC)[None] < np.array(rec_len)[:, None])
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


def _jconfigs(dropout=0.0, **over):
    enc = JConfig(**{**SMALL, **over}, dropout=dropout,
                  attention_dropout=dropout)
    return enc, dataclasses.replace(enc, add_cross_attention=True)


def _tcfg(kind, dropout=0.0):
    return dict(SMALL, dropout=dropout, attention_dropout=dropout,
                init_style="torch_default" if kind == "structure"
                else "xavier_all")


def _jparams(kind, seed, **over):
    """Seeded random weights in the JAX model's tree, N(0, 0.05^2) (LayerNorm
    scales 1 + that), as tests/test_torch_training.py draws them."""
    enc, dec = _jconfigs(**over)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    if kind == "structure":
        model = JStructure(enc, dec)
        args = (jnp.zeros((B,), jnp.int32), jb["ligand_angles"],
                jb["ligand_attn_mask"], jb["receptor_seq"],
                jb["receptor_angles"], jb["receptor_attn_mask"])
    else:
        model = JSequence(enc, dec)
        args = (jnp.zeros((B, 1)), jb["ligand_seq"], jb["ligand_angles"],
                jb["ligand_attn_mask"], jb["receptor_seq"],
                jb["receptor_angles"], jb["receptor_attn_mask"])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, x):
        noise = rng.normal(size=x.shape).astype(np.float32)
        return (1 if path[-1].key == "scale" else 0) + 0.05 * noise

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _to_port(kind, tree):
    fn = (structure_state_dict_from_jax if kind == "structure"
          else sequence_state_dict_from_jax)
    return fn(tree)


def _interleave(parts):
    """Microbatch j's rows at global rows j, j + n, ... (JAX's split)."""
    n = len(parts)
    out = np.empty((n * len(parts[0]),) + parts[0].shape[1:], parts[0].dtype)
    for j, p in enumerate(parts):
        out[j::n] = p
    return out


def _jax_trainer(kind, model, params):
    opt = make_optimizer(params, base_lr=LR, max_epochs=1, steps_per_epoch=1)
    if kind == "structure":
        return JStructureTrainer(model, JDiffusion.cosine(T_STRUCT), opt,
                                 accum_steps=ACCUM), JStructureState
    return JSequenceTrainer(model, JD3PM.create(
        j_transitions.BlosumTransition(), T_SEQ), opt,
        accum_steps=ACCUM), JSequenceState


def _jax_draws(kind, model, params):
    """The draws JAX's train_step (accum 2, cond_dropout 0) makes inside,
    from the same key splits, reassembled over the global batch as the
    port injects them."""
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    diff = _jax_trainer(kind, model, params)[0].diffusion
    draws = {}
    for j, key in enumerate(jax.random.split(RNG, ACCUM)):
        if kind == "structure":
            key_noise, _ = jax.random.split(key)
            t, noise, _ = diff.noise_batch(key_noise,
                                           jb["ligand_angles"][j::ACCUM])
            draws.setdefault("t", []).append(np.asarray(t, np.int64))
            draws.setdefault("noise", []).append(np.asarray(noise))
        else:
            key_t, key_noise, _ = jax.random.split(key, 3)
            t_int = jax.random.randint(key_t, (B // ACCUM,), 0, T_SEQ + 1)
            draws.setdefault("t_int", []).append(np.asarray(t_int, np.int64))
            draws.setdefault("gumbel", []).append(np.asarray(
                jax.random.gumbel(key_noise, (B // ACCUM, L_LIG, K))))
    return {k: _interleave(v) for k, v in draws.items()}


def _jax_step(kind, model, params):
    """JAX's single-device train_step: its metrics, and its updated weights
    and first moments in the port's names."""
    trainer, state_cls = _jax_trainer(kind, model, params)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = state_cls.create(apply_fn=model.apply,
                             params=jax.tree.map(jnp.asarray, params),
                             tx=trainer.optimizer)
    state, metrics = trainer.train_step(state, jb, RNG)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu"))
    return ({k: float(v) for k, v in metrics.items()},
            _to_port(kind, jax.tree.map(np.asarray, state.params)),
            _to_port(kind, jax.tree.map(np.asarray, adam.mu)))


def _port_one_process(kind, state_dict, dropout, cond_dropout, seed):
    """The port's one-process step (accum 2) from one seeded generator."""
    enc = TransformerConfig(**_tcfg(kind, dropout))
    dec = dataclasses.replace(enc, add_cross_attention=True)
    if kind == "structure":
        model = StructureDenoiser(enc, dec, device="cpu", seed=None)
        diff = GaussianAngleDiffusion.cosine(T_STRUCT, device="cpu")
        cls = StructureTrainer
    else:
        model = SequenceDenoiser(enc, dec, device="cpu", seed=None)
        diff = D3PMDiffusion.create(BlosumTransition(device="cpu"), T_SEQ,
                                    device="cpu")
        cls = SequenceTrainer
    model.load_state_dict(state_dict, strict=True)
    opt = AdamW(dict(model.named_parameters()), base_lr=LR, max_epochs=1,
                steps_per_epoch=1)
    gen = torch.Generator().manual_seed(seed)
    trainer = cls(model, diff, opt, accum_steps=ACCUM,
                  cond_dropout=cond_dropout, generator=gen)
    metrics = trainer.train_step({k: torch.from_numpy(v)
                                  for k, v in _batch().items()})
    return ({k: v.item() for k, v in metrics.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            dict(zip(opt.names, opt.mu)), torch.rand(4, generator=gen))


def _jax_structure_noise(key, shape, n_steps):
    key_init, k = jax.random.split(key)
    x_init = j_wrapped(key_init, shape, jnp.float32)
    zs = []
    for _ in range(n_steps):
        k, k_step = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(k_step, shape, jnp.float32)))
    return {"x_init": torch.from_numpy(np.array(x_init)),
            "z": torch.from_numpy(np.stack(zs))}


def _jax_sequence_noise(key, shape, n_pairs):
    key_init, k = jax.random.split(key)
    x_init = jax.nn.one_hot(jax.random.randint(key_init, shape[:2], 0, K), K,
                            dtype=jnp.float32)
    gumbel = []
    for _ in range(n_pairs):
        k, k_step = jax.random.split(k)
        gumbel.append(np.asarray(jax.random.gumbel(k_step, shape,
                                                   jnp.float32)))
    return {"x_init": torch.from_numpy(np.array(x_init)),
            "gumbel": torch.from_numpy(np.stack(gumbel))}


def _stored(kind, state_dict, params_dtype):
    """The port's full state_dict in a storage mode (int8 with its
    scales), as a one-process model stores it."""
    enc = TransformerConfig(**_tcfg(kind))
    dec = dataclasses.replace(enc, add_cross_attention=True)
    cls = StructureDenoiser if kind == "structure" else SequenceDenoiser
    model = cls(enc, dec, device="cpu", seed=None)
    model.load_state_dict(state_dict, strict=True)
    cast_inference_params(model, params_dtype)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the 4-rank run, and the JAX and one-process references
    (computed while the ranks run)."""
    work = tmp_path_factory.mktemp("tp_dp")
    batch = _batch()
    jm = {kind: _jparams(kind, seed) for kind, seed in
          (("structure", 1), ("sequence", 2))}
    full = {kind: _to_port(kind, p) for kind, (_, p) in jm.items()}
    train, sample = {}, {}
    for kind in jm:
        common = dict(kind=kind, state_dict=full[kind], lr=LR,
                      accum_steps=ACCUM,
                      timesteps=T_STRUCT if kind == "structure" else T_SEQ)
        draws = _jax_draws(kind, *jm[kind])
        train[f"{kind}_jax"] = dict(
            common, cfg=_tcfg(kind), cond_dropout=0.0, seed=0,
            batch={**batch, **draws})
        train[f"{kind}_dropout"] = dict(
            common, cfg=_tcfg(kind, 0.1), cond_dropout=0.5, seed=5,
            batch=batch)
    key_s, key_q = jax.random.PRNGKey(7), jax.random.PRNGKey(11)
    s_noise = _jax_structure_noise(key_s, (B, L_LIG, 8), DDIM_STEPS)
    d3pm = D3PMDiffusion.create(BlosumTransition(device="cpu"), T_SEQ,
                                device="cpu")
    q_noise = _jax_sequence_noise(key_q, (B, L_LIG, K),
                                  len(d3pm.step_pairs(None)))
    for dtype in ("f32", "int8_matmul"):
        sample[f"structure_{dtype}"] = dict(
            kind="structure", cfg=_tcfg("structure"), timesteps=T_STRUCT,
            steps=DDIM_STEPS, batch=batch, noise=s_noise,
            state_dict=_stored("structure", full["structure"], dtype))
        sample[f"sequence_{dtype}"] = dict(
            kind="sequence", cfg=_tcfg("sequence"), timesteps=T_SEQ,
            batch=batch, noise=q_noise,
            state_dict=_stored("sequence", full["sequence"], dtype))
    engine = dict(
        cfg=types.SimpleNamespace(pocket_ext=0, max_seq_len=16,
                                  ligand_max_len=L_LIG),
        structure_cfg=_tcfg("structure"), sequence_cfg=_tcfg("sequence"),
        structure=full["structure"], sequence=full["sequence"],
        timesteps=(T_STRUCT, T_SEQ), records=_records(), seed=9,
        engine=dict(batch_size=4, ddim_steps=3, seq_skip_steps=3))
    torch.save({"train": train, "sample": sample, "engine": engine},
               work / "input.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(DP * TP), str(DP), str(TP),
         str(work)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DP * TP)]

    # meanwhile: the references
    jax_ref = {kind: _jax_step(kind, *jm[kind]) for kind in jm}
    ones = {kind: _port_one_process(kind, full[kind], 0.1, 0.5, 5)
            for kind in jm}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_samples = {}
    for dtype in ("f32", "int8_matmul"):
        for kind, (model, params) in jm.items():
            p = params if dtype == "f32" else jax.jit(
                lambda q: dequantize_params(j_cast(q, dtype)))(params)
            if kind == "structure":
                run = j_sampler(model, JDiffusion.cosine(T_STRUCT),
                                return_trajectory=False, sampler="ddim",
                                ddim_steps=DDIM_STEPS)
                j_samples[f"{kind}_{dtype}"] = np.asarray(run(p, jb, key_s)[0])
            else:
                run = j_seq_sampler(model, JD3PM.create(
                    j_transitions.BlosumTransition(), T_SEQ), diverse=True)
                j_samples[f"{kind}_{dtype}"] = np.asarray(run(p, jb, key_q))
    one_engine = _one_process_engine(engine)
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(DP * TP)]
    return dict(jax=jax_ref, ones=ones, ranks=ranks, j_samples=j_samples,
                engine=one_engine)


def _records():
    rng = np.random.default_rng(3)
    return [pocket_record("ACDEFGH"[:n], rng.uniform(
        -np.pi, np.pi, (n, 8)).astype(np.float32), p)
        for n, p in ((6, 5), (7, 8), (5, 3))]


def _one_process_engine(case):
    """The engine's one-process designs from the seed a mesh engine draws
    for its one device batch."""
    models = []
    for kind in ("structure", "sequence"):
        enc = TransformerConfig(**case[f"{kind}_cfg"])
        dec = dataclasses.replace(enc, add_cross_attention=True)
        cls = StructureDenoiser if kind == "structure" else SequenceDenoiser
        m = cls(enc, dec, device="cpu", seed=None)
        m.load_state_dict(case[kind], strict=True)
        models.append(m)
    eng = DesignEngine(
        case["cfg"], models[0],
        GaussianAngleDiffusion.cosine(case["timesteps"][0], device="cpu"),
        models[1], D3PMDiffusion.create(BlosumTransition(device="cpu"),
                                        case["timesteps"][1], device="cpu"),
        device="cpu", **case["engine"])
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator(
    ).manual_seed(case["seed"])).item())
    results = eng.design_records(case["records"],
                                 generator=torch.Generator().manual_seed(seed))
    return [(r.sequence, r.angles, r.pdb) for r in results]


def _rel_l2(got, want):
    return ((got - want).norm() / (want.norm() + 1e-3)).item()


def _check_step(got, metrics, params, mu):
    """One mesh step (rank 0's gathered result) against a reference."""
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert set(got["params"]) == set(params)
    worst = max(got["mu"], key=lambda k: _rel_l2(got["mu"][k], mu[k].float()))
    assert _rel_l2(got["mu"][worst], mu[worst].float()) <= 1e-4, worst
    for k, want in params.items():
        want = torch.as_tensor(want).float()
        tol = torch.full_like(want, 1e-6)
        if k in mu:   # a weight whose gradient is near 0: up to lr
            tol = torch.where(mu[k].float().abs() > 1e-6, tol,
                              torch.full_like(want, LR))
        err = (got["params"][k].float() - want).abs()
        assert (err <= tol).all(), (k, err.max().item())


@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_dp_tp_step_matches_jax_single_device_step(world, kind):
    """dp=2 x tp=2, dropout 0, JAX's own draws injected (each rank its
    rows), unequal token counts across the dp halves."""
    metrics, params, mu = world["jax"][kind]
    got = world["ranks"][0][f"{kind}_jax"]
    assert set(metrics) == set(got["metrics"])
    _check_step(got, metrics, params, mu)


@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_dp_tp_step_matches_one_process_step_at_dropout(world, kind):
    """Dropout 0.1 in the attention kernels and the hidden Dropouts, and
    conditioning dropout 0.5, every draw made by each rank at the global
    batch's shape from one seed: the one-process step's result; the
    generators in lockstep; replicas bit for bit."""
    metrics, params, mu, next_draw = world["ones"][kind]
    ranks = [r[f"{kind}_dropout"] for r in world["ranks"]]
    _check_step(ranks[0], metrics, params, mu)
    for r in ranks:
        torch.testing.assert_close(r["next_draw"], next_draw, atol=0, rtol=0)
        assert r["capture_refused"]   # a gloo mesh captures no step
        assert r["reloaded"]          # full state -> shard, the same bits
    rules = t_mesh.param_sharding_rules(params, types.SimpleNamespace(tp=TP))
    for dp_rank in range(DP):   # tp ranks: the replicated tensors
        a, b = (ranks[dp_rank * TP + t]["local"] for t in range(TP))
        for k, rule in rules.items():
            if rule == "replicated":
                assert torch.equal(a[k], b[k]), k
    for t in range(TP):         # dp replicas: everything
        a, b = ranks[t]["local"], ranks[TP + t]["local"]
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert any(rule == "replicated" and "distance_embedding" in k
               for k, rule in rules.items())


@pytest.mark.parametrize("dtype", ["f32", "int8_matmul"])
@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_tp_sampling_matches_jax_with_injected_noise(world, kind, dtype):
    name = f"{kind}_{dtype}"
    ranks = world["ranks"]
    for d in range(DP):   # the tp ranks of a dp group agree bit for bit
        assert torch.equal(ranks[d * TP][name], ranks[d * TP + 1][name])
    got = torch.cat([ranks[d * TP][name] for d in range(DP)]).numpy()
    want = world["j_samples"][name]
    assert got.shape == want.shape
    if kind == "structure":
        dist = np.abs(np.asarray(angles.wrap_angle(
            torch.from_numpy(got - want))))
        assert dist.max() <= 5e-3
    else:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_design_engine_on_a_mesh_follows_rank_0(world):
    """DesignEngine(mesh=) at dp=2 x tp=2: rank 0 leads one design batch
    (3 requests padded to bucket 4), the other ranks follow and stop; the
    designs are the one-process engine's from the same seed: the same
    sequences, angles to 5e-3 as the samplers, a PDB for each."""
    ranks = world["ranks"]
    assert all(r["engine"] is None for r in ranks[1:])
    got, want = ranks[0]["engine"], world["engine"]
    assert len(got) == len(want) == 3
    for (seq, ang, pdb), (wseq, wang, _) in zip(got, want):
        assert seq == wseq and len(seq) == len(ang)
        dist = np.abs(np.asarray(angles.wrap_angle(torch.from_numpy(
            ang - wang))))
        assert dist.max() <= 5e-3
        assert pdb is not None and pdb.count("ATOM") == 4 * len(seq)


# ---------------------------------------------------------------- the rules

def _jax_rule_codes(kind, params, tp):
    """JAX's PartitionSpec of every leaf as a code (0 replicated, 1 the
    last axis split, 2 the one before), carried to the port's names."""
    specs = j_mesh.param_sharding_rules(params, types.SimpleNamespace(
        shape={"tp": tp}))

    def code(x, spec):
        spec = tuple(spec)
        c = 0
        if spec and spec[-1] == "tp":
            c = 1
        elif len(spec) >= 2 and spec[-2] == "tp":
            c = 2
        return np.full(np.shape(x), c, np.float32)

    codes = jax.tree.map(code, params, specs,
                         is_leaf=lambda x: isinstance(x, np.ndarray))
    return {k: int(v.reshape(-1)[0]) for k, v in _to_port(kind, codes).items()}


ATTN_SPLIT_NAMES = (".self.query.", ".self.key.", ".self.value.",
                    "output.dense.weight")


@pytest.mark.parametrize("heads,hidden", [(4, 32), (3, 48)])
@pytest.mark.parametrize("kind", ["structure", "sequence"])
def test_sharding_rules_match_jax(kind, heads, hidden):
    """Every parameter of a small model: the port's rule equals JAX's
    PartitionSpec, except where the heads do not divide by tp (3 heads,
    tp=2): JAX splits the 48 features of Q/K/V mid-head, the port cannot
    split a head and replicates the attention blocks whole."""
    _, params = _jparams(kind, 0, num_heads=heads, hidden_size=hidden)
    want = _jax_rule_codes(kind, params, TP)
    full = _to_port(kind, params)
    got = t_mesh.param_sharding_rules(full, types.SimpleNamespace(tp=TP))
    assert set(got) == set(want)
    code = {"replicated": 0, "col": 1, "row": 2}
    differ = sorted(k for k in got if code[got[k]] != want[k])
    expected = [] if heads % TP == 0 else sorted(
        k for k in got if any(s in k for s in ATTN_SPLIT_NAMES)
        and "adaLN" not in k and want[k] != 0
        and (".attention." in k or ".crossattention." in k
             or ".attn." in k))
    assert differ == expected
    if heads % TP:
        assert differ   # the listed names
    assert {got[k] for k in got} >= {"col", "row", "replicated"}


def test_shard_and_gather_round_trip_int8_scales():
    """int8 storage: a column layer's scale is split with its weight, a row
    layer's kept whole; gather_params (each tp rank's shard in turn)
    restores the full dict."""
    _, params = _jparams("structure", 0)
    full = _stored("structure", _to_port("structure", params), "int8_matmul")
    shards = []
    for t in range(TP):
        m = types.SimpleNamespace(tp=TP, tp_rank=t)
        shards.append(t_mesh.shard_params(full, m))
    q = "encoder.layer.0.attention.self.query"
    o = "encoder.layer.0.attention.output.dense"
    assert shards[0][f"{q}.weight_scale"].shape[0] == full[
        f"{q}.weight_scale"].shape[0] // TP
    assert torch.equal(shards[1][f"{o}.weight_scale"],
                       full[f"{o}.weight_scale"])
    assert shards[1][f"{o}.weight"].dtype == torch.int8
    rules = t_mesh.param_sharding_rules(full, types.SimpleNamespace(tp=TP))

    class FakeMesh(types.SimpleNamespace):
        def gather_tp(self, t, dim):   # the broadcasts, in one process
            key = next(k for k, v in shards[0].items() if v is t)
            return torch.cat([s[key] for s in shards], dim=dim)

    back = t_mesh.gather_params(shards[0], FakeMesh(tp=TP, tp_rank=0), rules)
    assert set(back) == set(full)
    for k in full:
        assert torch.equal(back[k], full[k]), k


def test_gloo_meshes_refuse_capture():
    check_capturable(None, True)
    check_capturable(types.SimpleNamespace(can_capture=True,
                                           backend="nccl"), True)
    check_capturable(types.SimpleNamespace(can_capture=False,
                                           backend="gloo"), False)
    with pytest.raises(RuntimeError, match="eager=True"):
        check_capturable(types.SimpleNamespace(can_capture=False,
                                               backend="gloo"), True)


# ------------------------------------------------------------ multihost

@pytest.mark.parametrize("n,pc", [(67, 4), (5, 8), (64, 4), (63, 16), (1, 2)])
def test_host_rows_match_jax(n, pc):
    for pi in range(pc):
        assert t_multihost.host_local_slice(n, pi, pc) == \
            j_multihost.host_local_slice(n, process_index=pi,
                                         process_count=pc)
    assert t_multihost.host_batch_rows(n, pc) == j_multihost.host_batch_rows(
        n, process_count=pc)


def test_pad_local_batch_matches_jax():
    batch = {k: v[:5] for k, v in _batch().items()}
    batch["num_valid"] = 5
    batch["structure_ids"] = [{"pdb_id": str(i)} for i in range(5)]
    got = t_multihost.pad_local_batch(batch, 7)
    want = j_multihost.pad_local_batch(batch, 7)
    assert set(got) == set(want)
    for k in want:
        if k == "structure_ids":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="rows > target"):
        t_multihost.pad_local_batch(batch, 4)
    with pytest.raises(ValueError, match="rows > target"):
        j_multihost.pad_local_batch(batch, 4)


def test_distribute_batch_checks_rows_as_jax(monkeypatch):
    local = {k: v[:4] for k, v in _batch().items()}
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    out = t_multihost.distribute_batch(local, mesh)
    for k, v in local.items():
        assert torch.equal(out[k], torch.from_numpy(v))
    monkeypatch.setattr(t_multihost.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(t_multihost.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    jmesh = j_mesh.make_mesh(dp=8, tp=1)
    for fn, m in ((t_multihost.distribute_batch, mesh),
                  (j_multihost.distribute_batch, jmesh)):
        with pytest.raises(ValueError, match="pad_local_batch"):
            fn(local, m, global_rows=67)
        bad = dict(local)
        bad["ligand_angles"] = bad["ligand_angles"][:2]
        with pytest.raises(ValueError, match="inconsistent"):
            fn(bad, m)


def _no_cluster_env(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def test_initialize_multihost_env_driven(monkeypatch):
    """torchrun's variables configure the job; an initialised job and an
    explicit single process are left alone."""
    dist = t_multihost.dist
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert t_multihost.initialize_multihost(backend="gloo") == (0, 1)
    assert calls == [{"backend": "gloo", "init_method": "env://",
                      "world_size": 4, "rank": 2}]
    calls.clear()
    t_multihost.initialize_multihost("10.0.0.2:99", backend="gloo")
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.2:99",
                      "world_size": 4, "rank": 2}]
    calls.clear()
    t_multihost.initialize_multihost(num_processes=1)
    assert calls == []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert t_multihost.initialize_multihost() == (2, 4)
    assert calls == []


def test_initialize_multihost_without_a_cluster(monkeypatch):
    """Nothing configured: initialisation is attempted, and its failure
    warns and continues single-process; anything configured fails
    loudly."""
    dist = t_multihost.dist
    _no_cluster_env(monkeypatch)
    calls = []

    def boom(**kw):
        calls.append(kw)
        raise ValueError("no MASTER_ADDR")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", boom)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert t_multihost.initialize_multihost() == (0, 1)
    assert calls and calls[0]["init_method"] == "env://"
    assert any("no cluster detected" in str(w.message) for w in caught)
    with pytest.raises(ValueError):
        t_multihost.initialize_multihost(process_id=3)
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError):
        t_multihost.initialize_multihost()


# --------------------------------------------------------- the train CLI

CLI = ["--synthetic", "--synthetic_n", "24", "--device", "cpu",
       "--hidden_size", "32", "--num_heads", "4", "--num_hidden_layers", "1",
       "--intermediate_size", "64", "--max_seq_len", "64", "--batch_size",
       "4", "--bf16", "false"]


def _ranks(cmd, n):
    """``cmd`` in ``n`` processes with the variables torchrun would set."""
    procs = []
    for r in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _cli_cmd(module, args, rdv=None):
    """``python -m module args``, or with ``rdv`` the worker's ``cli``
    entry, which joins the gloo job through ``file://rdv`` first."""
    if rdv is None:
        return [sys.executable, "-m", module, *args]
    return [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
            "cli", str(rdv), module, *args]


def _cli(ckpt_dir, epochs, *, ranks=1, rdv=None, kind="structure"):
    """A train CLI in ``ranks`` processes (gloo, dp-only)."""
    args = [*CLI, "--max_epochs", str(epochs), "--ckpt_dir", str(ckpt_dir)]
    if ranks > 1:
        args += ["--multihost", "--dp", str(ranks), "--dist_backend", "gloo"]
    cmd = _cli_cmd(f"e3diff_tpu_torch.cli.train_{kind}", args,
                   rdv if ranks > 1 else None)
    for p in _ranks(cmd, ranks):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]


def _forward(state_dict):
    enc = TransformerConfig(hidden_size=32, num_heads=4, num_layers=1,
                            intermediate_size=64, max_position_embeddings=64)
    model = StructureDenoiser(enc, dataclasses.replace(
        enc, add_cross_attention=True), device="cpu", seed=None)
    model.load_state_dict(state_dict, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with torch.no_grad():
        return model(torch.arange(B) * 100, tb["ligand_angles"],
                     tb["ligand_attn_mask"], tb["receptor_seq"],
                     tb["receptor_angles"], tb["receptor_attn_mask"])


def test_two_process_cli_checkpoint_restores_single_process(tmp_path):
    """``--multihost --dp 2 --dist_backend gloo``: rank 0 writes
    config.json, final.pt (the one-process key set) and history.json; the
    weights are the one-process run's (the forwards to 1e-4, as
    tests/test_torch_training.py holds a trained final.pt; each weight but
    the key biases, whose gradient is zero in exact arithmetic, to 1e-5);
    and a single process resumes the 2-process run's last.pt into the
    one-process run's second epoch."""
    two, one = tmp_path / "two", tmp_path / "one"
    _cli(two, 1, ranks=2, rdv=tmp_path / "rdv")
    _cli(one, 2)
    for name in ("config.json", "final.pt", "last.pt", "history.json"):
        assert (two / name).is_file(), name
    assert not any(p.name.startswith(".") for p in two.iterdir())
    got = torch.load(two / "final.pt", weights_only=True)
    ref_dir = tmp_path / "one_epoch"
    _cli(ref_dir, 1)
    want = torch.load(ref_dir / "final.pt", weights_only=True)
    assert set(got) == set(want)
    for k in want:
        if not k.endswith("self.key.bias"):
            torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=0,
                                       msg=k)
    torch.testing.assert_close(_forward(got), _forward(want), atol=1e-4,
                               rtol=0)
    _cli(two, 2)   # one process resumes the 2-process run
    torch.testing.assert_close(
        _forward(torch.load(two / "final.pt", weights_only=True)),
        _forward(torch.load(one / "final.pt", weights_only=True)),
        atol=1e-4, rtol=0)


def test_two_rank_serve_answers_design_requests(tmp_path):
    """``serve --dp 2 --dist_backend gloo`` (the CPU, eager): rank 0 runs
    the HTTP server and leads each device batch, rank 1 follows; a
    /design request is answered with valid designs, and an interrupt of
    rank 0 releases rank 1, both exiting cleanly."""
    _cli(tmp_path / "s", 1)
    _cli(tmp_path / "q", 1, kind="sequence")
    cmd = _cli_cmd("e3diff_tpu_torch.cli.serve", [
        "--structure_ckpt", str(tmp_path / "s" / "final.pt"),
        "--sequence_ckpt", str(tmp_path / "q" / "final.pt"),
        "--transition", "blosum", "--device", "cpu", "--port", "0",
        "--serve_batch_size", "4", "--ddim_steps", "3",
        "--seq_skip_steps", "3", "--dp", "2", "--dist_backend", "gloo"],
        tmp_path / "rdv")
    procs = _ranks(cmd, 2)
    try:
        port, seen = None, []
        for line in procs[0].stdout:
            seen.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "".join(seen)[-4000:]
        rng = np.random.default_rng(0)
        payload = {"pocket": {"sequence": "ACDEFG",
                              "angles": rng.uniform(-3, 3, (6, 8)).tolist(),
                              "peptide_length": 5}, "n_designs": 3}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/design", method="POST",
            data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = json.loads(resp.read())
            assert resp.status == 200
        assert len(body["designs"]) == 3
        for d in body["designs"]:
            assert len(d["sequence"]) == 5
            assert set(d["sequence"]) <= set("ACDEFGHIKLMNPQRSTVWY")
            assert d["pdb"].startswith("ATOM")
        procs[0].send_signal(signal.SIGINT)
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
