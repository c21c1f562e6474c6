"""The port's captured samplers, on the CPU, at a small size (the tiny
engine of test_torch_engine.py: hidden 32, 4 heads, 2 layers, structure
T = 8 with DDIM-3, sequence T = 6): ``GraphCache`` holds to
``JitSamplerCache``'s semantics; the capturable step functions
(``reverse_step`` over device buffers), looped eagerly as the CPU path runs
them, equal the Python loop they replaced (host-int timesteps, one draw per
step) bit for bit in f32, and match the JAX samplers on the same draws
within the sampler tolerances of test_torch_structure.py and
test_torch_sequence.py; drawing all of a batch's noise up front gives the
same designs through ``DesignEngine`` as the per-step draws did. The
graphs themselves run only on the card (chip_smoke.py, phase 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e3diff_tpu.diffusion import D3PMDiffusion as JD3PM
from e3diff_tpu.diffusion import GaussianAngleDiffusion as JDiffusion
from e3diff_tpu.ops import UniformTransition as JUniform
from e3diff_tpu.sampling.sequence import make_sequence_sampler as j_seq_sampler
from e3diff_tpu.sampling.structure import make_structure_sampler as j_sampler
from e3diff_tpu.utils.jit_cache import JitSamplerCache

from e3diff_tpu_torch.diffusion.d3pm import sample_gumbel
from e3diff_tpu_torch.diffusion.gaussian import sample_wrapped_noise
from e3diff_tpu_torch.sampling.sequence import make_sequence_sampler
from e3diff_tpu_torch.sampling.structure import make_structure_sampler
from e3diff_tpu_torch.utils.graph_cache import GraphCache
from tests.test_torch_engine import (  # noqa: F401  (params: a fixture)
    T_SEQ,
    T_STRUCT,
    _engine,
    _jax_engine,
    _pocket,
    params,
)
from tests.test_torch_sequence import _jax_draws
from tests.test_torch_structure import _jax_noise

K = 20


# ------------------------------------------------------------ GraphCache

class _Obj:
    pass


class _Program:
    def __init__(self, name):
        self.name, self.closed = name, 0

    def close(self):
        self.closed += 1


def test_graph_cache_semantics_match_jit_cache():
    """The same puts and gets on both caches give the same hits and misses:
    identity pinning (a recycled id with another object misses), the LRU
    order (a get refreshes an entry), and the bound."""
    m1, m2, d = _Obj(), _Obj(), _Obj()
    caches = [GraphCache(maxsize=3), JitSamplerCache(maxsize=3)]
    trace = []
    for cache in caches:
        vals = {n: _Program(n) for n in "abcde"}
        got = []
        cache.put((id(m1), id(d), "ddim", 16), vals["a"], m1, d)
        cache.put((id(m1), id(d), "ddim", 32), vals["b"], m1, d)
        got.append(cache.get((id(m1), id(d), "ddim", 16), m1, d))
        # same key, another object under it: a recycled id never aliases
        got.append(cache.get((id(m1), id(d), "ddim", 16), m2, d))
        got.append(cache.get((id(m1), id(d), "ddim", 16), m1))
        got.append(cache.get((id(m2), id(d), "ddim", 16), m2, d))
        cache.put((id(m2), id(d), "ddim", 16), vals["c"], m2, d)
        # "a" was used last of the three; "b" is the oldest
        cache.put((id(m2), id(d), "ddpm", 16), vals["d"], m2, d)
        got.append(cache.get((id(m1), id(d), "ddim", 32), m1, d))
        got += [cache.get((id(m1), id(d), "ddim", 16), m1, d),
                cache.get((id(m2), id(d), "ddim", 16), m2, d),
                cache.get((id(m2), id(d), "ddpm", 16), m2, d)]
        cache.put((id(m1), id(d), "ddim", 64), vals["e"], m1, d)
        got.append(cache.get((id(m1), id(d), "ddim", 16), m1, d))
        assert len(cache._entries) == 3
        trace.append([None if v is None else v.name for v in got])
    assert trace[0] == trace[1] == ["a", None, None, None, None, "a", "c",
                                    "d", None]


def test_graph_cache_closes_what_it_drops():
    """An evicted program and a replaced one are closed once; a program
    put again under its own key is not."""
    m, d = _Obj(), _Obj()
    cache = GraphCache(maxsize=2)
    progs = [_Program(i) for i in range(4)]
    cache.put(("k", 0), progs[0], m, d)
    cache.put(("k", 0), progs[0], m, d)
    cache.put(("k", 1), progs[1], m, d)
    assert [p.closed for p in progs] == [0, 0, 0, 0]
    cache.put(("k", 2), progs[2], m, d)          # evicts ("k", 0)
    cache.put(("k", 1), progs[3], m, d)          # replaces ("k", 1)
    assert [p.closed for p in progs] == [1, 1, 0, 0]
    assert len(cache) == 2
    with pytest.raises(ValueError):
        GraphCache(maxsize=0)


# ------------------------------------------- the step functions, eagerly

def _struct_batch(eng, records):
    return {k: torch.from_numpy(v) for k, v in eng._stack_slots(
        [eng.featurize(r) for r in records]).items()
        if k in eng._DEVICE_KEYS}


def _old_structure_loop(diffusion, denoise_fn, x_init, z, ts, t_prev, ddim):
    """The reverse loop before the step functions: host-int timesteps."""
    x, traj = x_init, []
    b = x.shape[0]
    for i, t in enumerate(ts.tolist()):
        t_vec = torch.full((b,), int(t), dtype=torch.long)
        eps = denoise_fn(t_vec, x)
        if ddim:
            x = diffusion.ddim_step(x, eps, t_vec,
                                    torch.full((b,), int(t_prev[i])), 1.0,
                                    z[i])
        else:
            x = diffusion.p_step(x, eps, t_vec, z[i])
        traj.append(x)
    return x, torch.stack(traj)


@pytest.mark.parametrize("sampler,guided", [
    ("ddpm", False), ("ddim", False), ("ddpm", True), ("ddim", True)])
def test_structure_step_equals_the_old_loop(params, sampler, guided):
    from e3diff_tpu_torch.sampling.structure import make_denoise_fn

    eng = _engine(params)
    model, diffusion = eng.structure_model, eng.structure_diffusion
    batch = _struct_batch(eng, [_pocket(6, 5, 0), _pocket(9, 7, 1),
                                _pocket(4, 8, 2)])
    ts, t_prev = diffusion.ladder(sampler, n_steps=3)
    gen = torch.Generator().manual_seed(5)
    x_init = sample_wrapped_noise(batch["ligand_angles"].shape,
                                  generator=gen, device="cpu")
    z = torch.randn((len(ts),) + tuple(x_init.shape), generator=gen)
    scale = np.array([1.0, 2.5, 0.5, 1.5], np.float32)
    run = make_structure_sampler(
        model, diffusion, sampler=sampler, ddim_steps=3,
        return_trajectory=True, guided=guided)
    got, traj = run(batch, noise={"x_init": x_init, "z": z}, scale=scale)
    denoise = make_denoise_fn(model, batch, guided=guided, scale=scale)
    want, want_traj = _old_structure_loop(diffusion, denoise, x_init, z, ts,
                                          t_prev, sampler == "ddim")
    assert torch.equal(got, want) and torch.equal(traj, want_traj)
    assert not torch.equal(x_init, got)


def _old_d3pm_loop(d3pm, denoise_fn, x_init, gumbel, n_steps, diverse):
    x = x_init
    b = x.shape[0]
    for i, (s, t) in enumerate(d3pm.step_pairs(n_steps)):
        logits = denoise_fn(torch.full((b, 1), float(s)), x)
        x = d3pm.posterior_sample(x, logits, s, diverse, t_int=t,
                                  gumbel=None if gumbel is None else gumbel[i])
    return denoise_fn(torch.zeros((b, 1)), x)


@pytest.mark.parametrize("diverse,n_steps,guided", [
    (True, None, False), (True, 3, False), (False, 3, True), (True, 2, True)])
def test_d3pm_step_equals_the_old_loop(params, diverse, n_steps, guided):
    from e3diff_tpu_torch.sampling.sequence import make_denoise_fn

    eng = _engine(params)
    model, d3pm = eng.sequence_model, eng.sequence_d3pm
    recs = [_pocket(6, 5, 0), _pocket(9, 7, 1), _pocket(4, 8, 2)]
    batch = _struct_batch(eng, recs)
    gen = torch.Generator().manual_seed(6)
    x_init, gumbel = d3pm.draw_noise(batch["ligand_seq"].shape, n_steps,
                                     generator=gen, device="cpu",
                                     diverse=diverse)
    scale = np.array([2.0, 1.0, 3.0, 1.0], np.float32)
    run = make_sequence_sampler(model, d3pm, diverse=diverse,
                                n_steps=n_steps, guided=guided)
    got = run(batch, noise={"x_init": x_init, "gumbel": gumbel}, scale=scale)
    want = _old_d3pm_loop(d3pm, make_denoise_fn(model, batch, guided=guided,
                                                scale=scale),
                          x_init, gumbel, n_steps, diverse)
    assert torch.equal(got, want)


def test_ddpm_ladder_with_a_stride():
    from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion

    diffusion = GaussianAngleDiffusion.cosine(1000, device="cpu")
    for step in (1, 3, 7):
        ts, t_prev = diffusion.ladder("ddpm", step=step)
        assert ts.tolist() == list(reversed(range(0, 1000, step)))
        assert (t_prev == ts - step).all()
    with pytest.raises(ValueError, match="sampler"):
        diffusion.ladder("euler")


# ----------------------------------------------------- against the JAX package

@pytest.mark.parametrize("sampler,scale", [("ddpm", 1.0), ("ddim", 1.5)])
def test_structure_steps_match_jax(params, sampler, scale):
    """``reverse_step`` at every index of the ladder, fed JAX's own x_t
    and z, against the next x of JAX's trajectory: within 5e-3, the
    sampler tolerance of test_torch_structure.py (at T = 8 the first DDIM
    step divides the network's f32 rounding by sqrt(alpha_bar_7): 1.2e-3
    measured; and a whole run can part from JAX where an angle lands
    within rounding of the +-pi wrap). The two live slots only: the
    two dead ones (all-zero masks) have softmax rows near -10^4, where an
    f32 step is 2^-10, and the first DDPM step multiplies that by 100."""
    from e3diff_tpu_torch.sampling.structure import make_denoise_fn

    eng, jeng = _engine(params), _jax_engine(params)
    diffusion = eng.structure_diffusion
    batch = _struct_batch(eng, [_pocket(6, 5, 0), _pocket(9, 7, 1)])
    key = jax.random.PRNGKey(3)
    _, want = j_sampler(
        jeng.structure_model, JDiffusion.cosine(T_STRUCT), sampler=sampler,
        ddim_steps=3, guidance_scale=scale, return_trajectory=True)(
        jeng.structure_params,
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key)
    want = np.asarray(want)
    ts, t_prev = diffusion.ladder(sampler, n_steps=3)
    noise = _jax_noise(key, tuple(batch["ligand_angles"].shape), len(ts))
    st = diffusion.reverse_state(noise["x_init"], noise["z"], ts, t_prev,
                                 return_trajectory=False)
    denoise = make_denoise_fn(eng.structure_model, batch,
                              guided=scale != 1.0, scale=scale)
    for i in range(len(ts)):
        st.x.copy_(noise["x_init"] if i == 0 else torch.from_numpy(want[i - 1].copy()))
        st.i.fill_(i)
        diffusion.reverse_step(denoise, st, ddim=sampler == "ddim")
        assert st.i.item() == i + 1
        d = st.x.numpy()[:2] - want[i, :2]
        assert np.abs((d + np.pi) % (2 * np.pi) - np.pi).max() <= 5e-3, i


@pytest.mark.parametrize("n_steps,scale", [(None, 1.0), (3, 1.5)])
def test_d3pm_steps_match_jax(params, n_steps, scale):
    """Identical class indices on every token, logits within 1e-3 (the
    tolerances of test_torch_sequence.py)."""
    eng, jeng = _engine(params), _jax_engine(params)
    batch = _struct_batch(eng, [_pocket(6, 5, 0), _pocket(9, 7, 1)])
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_seq_sampler(
        jeng.sequence_model, JD3PM.create(JUniform(20), timesteps=T_SEQ),
        n_steps=n_steps, guidance_scale=scale)(
        jeng.sequence_params,
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, key))
    noise = _jax_draws(key, tuple(batch["ligand_seq"].shape),
                       len(eng.sequence_d3pm.step_pairs(n_steps)))
    got = make_sequence_sampler(eng.sequence_model, eng.sequence_d3pm,
                                n_steps=n_steps, guidance_scale=scale)(
        batch, noise=noise).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-3)


# ------------------------------------------------- the draw order, one seed

def test_engine_designs_survive_the_draw_order(params):
    """DesignEngine now draws a batch's noise before its first step (x_init
    and all n steps' z, then the sequence sampler's x_init and all its
    Gumbel noise). From one seed it gives the designs that the draws made
    one step at a time, interleaved with the forwards, gave: the samplers
    fed those per-step draws by hand reproduce every sequence and angle."""
    eng = _engine(params, batch_size=4)
    recs = [_pocket(6, 5, 0), _pocket(9, 7, 1), _pocket(4, 8, 2)]
    slots = [eng.featurize(r) for r in recs]
    out = eng.design_slots(slots, generator=torch.Generator().manual_seed(9),
                           return_pdb=False)
    gen = torch.Generator().manual_seed(9)
    batch = _struct_batch(eng, recs)
    shape = tuple(batch["ligand_angles"].shape)
    x_init = sample_wrapped_noise(shape, generator=gen, device="cpu")
    z = torch.stack([torch.randn(shape, generator=gen) for _ in range(3)])
    b, length = shape[:2]
    q_init = torch.nn.functional.one_hot(
        torch.randint(0, K, (b, length), generator=gen), K).float()
    n_pairs = len(eng.sequence_d3pm.step_pairs(None))
    gumbel = torch.stack([sample_gumbel((b, length, K), generator=gen,
                                        device="cpu")
                          for _ in range(n_pairs)])
    angles, _ = make_structure_sampler(
        eng.structure_model, eng.structure_diffusion, sampler="ddim",
        ddim_steps=3, return_trajectory=False)(
        batch, noise={"x_init": x_init, "z": z})
    seq_batch = dict(batch, ligand_angles=angles)
    logits = make_sequence_sampler(eng.sequence_model, eng.sequence_d3pm)(
        seq_batch, noise={"x_init": q_init, "gumbel": gumbel})
    pred = logits.argmax(-1).numpy()
    for i, (res, rec) in enumerate(zip(out, recs)):
        n = int(np.asarray(rec["ligand_mask"]).sum())
        np.testing.assert_array_equal(res.angles, angles[i, :n].numpy())
        assert res.sequence == "".join(
            "ACDEFGHIKLMNPQRSTVWY"[j] for j in pred[i, :n])


def test_cpu_samplers_run_eagerly(params):
    """On the CPU the samplers never capture: ``eager`` changes nothing,
    and asking for a program needs a card."""
    eng = _engine(params)
    batch = _struct_batch(eng, [_pocket(6, 5, 0)])
    runs = [make_structure_sampler(eng.structure_model, eng.structure_diffusion,
                                   sampler="ddim", ddim_steps=3, eager=e)
            for e in (False, True)]
    a, b = (r(batch, generator=torch.Generator().manual_seed(1)) for r in runs)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises((AttributeError, TypeError, RuntimeError)):
        runs[0].program(batch)
