"""Batched structure (angle) sampling (counterpart of
e3diff_tpu/sampling/structure.py).

Per batch: draw the wrapped-Gaussian initial noise and every step's noise
at once, encode the pocket and project every decoder layer's
cross-attention K/V once, then run the reverse steps (DDPM or DDIM), and
trim each sample to its true ligand length. On the card the encoding and
one reverse step are CUDA graphs captured once per bucket (batch, ligand
and receptor shape, dtypes, sampler flags) and replayed, the host loop
being ``n`` replays; the programs live in a bounded ``GraphCache``. On the
CPU, or when asked (``eager=True``), the same step runs as a Python loop.
Both paths read the same draws, so one seed gives the same samples either
way. Reference quirk Q5 (only the first batch is sampled, sample.py:237)
is ``first_batch_only=True`` by default.

A model built on a mesh (parallel/mesh.py) samples the rank's dp rows of
a global batch with its tp shard: the noise is drawn at the global
batch's shape and the rank keeps its rows, so every rank of one seed
draws what one device would. NCCL's collectives are captured in the
graphs; a gloo mesh's cannot be, and there the sampler runs with
``eager=True``.

Each sampler keeps a ``WeightImage`` of its model (models/blocks.py), and
each of its calls and captures runs inside its ``frozen()``: a model of
f32 weights and bf16 compute reads its Linears' and tables' bf16 compute
image, cast once and made again in place when the weights change, so that
a captured step casts no weight.

Each sampler call runs inside a ``structure.run`` span (utils/telemetry.py)
with its CUDA time on the card: the draws, the copies into the static
buffers and the replays enqueued (``captured`` when the call captured its
bucket's program). ``sample_structure_batches`` adds ``sample.to_device``
and ``sample.results`` around each batch's copy in and read out.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import strip_meta
from e3diff_tpu_torch.diffusion.gaussian import GaussianAngleDiffusion
from e3diff_tpu_torch.diffusion.guidance import guided_combine, null_receptor
from e3diff_tpu_torch.models.blocks import WeightImage
from e3diff_tpu_torch.sampling.graphs import (
    CapturedCall,
    check_capturable,
    fill_static,
)
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.device import resolve_device
from e3diff_tpu_torch.utils.graph_cache import GraphCache

BATCH_KEYS = ("ligand_angles", "ligand_attn_mask", "receptor_seq",
              "receptor_angles", "receptor_attn_mask")


def make_denoise_fn(model, batch: dict, *, guided: bool, scale=1.0):
    """Encode the pocket and project the cross-attention K/V once; returns
    denoise_fn(t_vec, x) -> eps_hat, one ``decode`` per call (over the 2B
    conditional ‖ null batch, combined with ``scale``, when guided)."""
    rec_seq, rec_ang = batch["receptor_seq"], batch["receptor_angles"]
    rec_mask, lig_mask = batch["receptor_attn_mask"], batch["ligand_attn_mask"]
    if guided:
        nseq, nang, nmask = null_receptor(rec_seq, rec_ang, rec_mask)
        rec_seq = torch.cat([rec_seq, nseq])
        rec_ang = torch.cat([rec_ang, nang])
        rec_mask = torch.cat([rec_mask, nmask])
        lig_mask = torch.cat([lig_mask, lig_mask])
    enc_out = model.encode_receptor(rec_seq, rec_ang, rec_mask)
    cross_kv = model.precompute_cross_kv(enc_out)

    def denoise_fn(t_vec, x):
        if guided:
            t_vec = torch.cat([t_vec, t_vec])
            x = torch.cat([x, x])
        pred = model.decode(t_vec, x, lig_mask, enc_out, rec_mask,
                            cross_kv=cross_kv)
        return guided_combine(pred, scale) if guided else pred

    return denoise_fn


class StructureProgram:
    """One bucket's structure sampler on the card: the pocket encoding and
    one reverse step, each a ``CapturedCall`` over static buffers (the
    batch, the (B,) guidance scale, the ``ReverseState``)."""

    def __init__(self, model, diffusion: GaussianAngleDiffusion,
                 batch: dict, *, ts, t_prev, ddim: bool, eta: float,
                 guided: bool, return_trajectory: bool, trajectory_dtype,
                 pool):
        dev = next(model.parameters()).device
        self.inputs = {k: torch.zeros(batch[k].shape, dtype=batch[k].dtype,
                                      device=dev) for k in BATCH_KEYS}
        lig = self.inputs["ligand_angles"]
        self.scale = (torch.ones(lig.shape[0], device=dev) if guided
                      else None)
        self.state = diffusion.reverse_state(
            lig, torch.zeros((len(ts),) + tuple(lig.shape)), ts, t_prev,
            return_trajectory, trajectory_dtype)
        self.encode = CapturedCall(
            lambda: make_denoise_fn(model, self.inputs, guided=guided,
                                    scale=self.scale), pool=pool,
            owner="structure")
        self.encode.replay()  # the step's warm-up reads the encoding
        denoise_fn = self.encode.out
        self.step = CapturedCall(
            lambda: diffusion.reverse_step(denoise_fn, self.state, ddim=ddim,
                                           eta=eta),
            pool=pool, reset=self.state.i.zero_, owner="structure")
        self.n_steps = len(ts)

    def run(self, batch: dict, x_init, z, scale):
        """Copy the batch, the scale and the draws into the static buffers,
        replay the encoding and n steps; returns copies of the final
        sample and of the trajectory (or None)."""
        for k, buf in self.inputs.items():
            fill_static(buf, batch[k])
        if self.scale is not None:
            fill_static(self.scale, scale)
        st = self.state
        fill_static(st.x, x_init)
        fill_static(st.z, z)
        st.i.zero_()
        self.encode.replay()
        for _ in range(self.n_steps):
            self.step.replay()
        return st.x.clone(), None if st.traj is None else st.traj.clone()

    def close(self) -> None:
        self.encode.close()
        self.step.close()
        self.inputs = self.scale = self.state = None


def make_structure_sampler(model, diffusion: GaussianAngleDiffusion, *,
                           step: int = 1, return_trajectory: bool = True,
                           trajectory_dtype: torch.dtype | None = None,
                           sampler: str = "ddpm", ddim_steps: int = 50,
                           ddim_eta: float = 1.0, guidance_scale=1.0,
                           guided: bool | None = None,
                           cache: GraphCache | None = None,
                           eager: bool = False):
    """Returns run(batch, generator=None, noise=None, scale=None) ->
    (final, trajectory or None).

    batch: dict of tensors (ligand_angles, ligand_attn_mask, receptor_seq,
    receptor_angles, receptor_attn_mask), on the model's device or on the
    host (pinned memory makes the copies asynchronous). generator: the
    device generator the noise is drawn from before the first step, x_init
    first and then every step's z; or noise = {"x_init": (B, L, F),
    "z": (n_steps, B, L, F)} to inject the draws instead. On a mesh model
    the batch and injected draws are the rank's dp rows, and the
    generator's draws are made at the global batch's shape and cut.

    ``trajectory_dtype`` (bf16, say) is the type the trajectory is stored
    in, the sample's when None; the carried sample keeps its own.

    sampler "ddpm" is the reference's ancestral loop (T forwards, or T/step
    with the lossy stride); "ddim" runs ddim_steps forwards. A guidance
    scale other than 1 (or guided=True) runs classifier-free guidance as
    one 2B forward per step; the scale, a number or a (B,) vector, may
    also be given per call.

    On the card each bucket's program is captured at its first call into
    ``cache`` (a new ``GraphCache`` when None) and replayed after;
    ``eager=True`` runs the Python loop there instead (the graphs'
    oracle). ``run.program(batch)`` returns the bucket's program,
    capturing it if needed."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if guided is None:
        guided = not (np.ndim(guidance_scale) == 0
                      and float(guidance_scale) == 1.0)
    ts, t_prev = diffusion.ladder(sampler, step=step, n_steps=ddim_steps)
    device = next(model.parameters()).device
    graphs = device.type == "cuda" and not eager
    mesh = getattr(model, "mesh", None)
    check_capturable(mesh, graphs)
    if graphs and cache is None:
        cache = GraphCache()
    image = WeightImage(model)
    flags = ("structure", step, return_trajectory, str(trajectory_dtype),
             sampler, ddim_steps, float(ddim_eta), guided)

    def cached(batch) -> tuple[StructureProgram, bool]:
        """The bucket's program, and whether this call captured it."""
        key = (id(model), id(diffusion), *flags,
               *((k, tuple(batch[k].shape), str(batch[k].dtype))
                 for k in BATCH_KEYS))
        prog = cache.get(key, model, diffusion)
        if prog is not None:
            return prog, False
        prog = StructureProgram(
            model, diffusion, batch, ts=ts, t_prev=t_prev,
            ddim=sampler == "ddim", eta=ddim_eta, guided=guided,
            return_trajectory=return_trajectory,
            trajectory_dtype=trajectory_dtype, pool=cache.pool())
        cache.put(key, prog, model, diffusion)
        return prog, True

    def run(batch, generator=None, noise=None, scale=None):
        if noise is None and generator is None:
            raise ValueError("pass a generator or injected noise")
        lig = batch["ligand_angles"]
        bucket = (*lig.shape[:2], batch["receptor_seq"].shape[1])
        with telemetry.span("structure.run", device=device.type == "cuda",
                            bucket=bucket) as span, image.frozen():
            if noise is None:
                n = lig.shape[0]
                r0, rows = (0, n) if mesh is None else mesh.rows(n)
                x_init, z = diffusion.draw_noise(
                    (rows,) + tuple(lig.shape[1:]), len(ts),
                    generator=generator, device=device, dtype=lig.dtype)
                x_init, z = x_init[r0:r0 + n], z[:, r0:r0 + n]
            else:
                x_init, z = noise["x_init"], noise["z"]
            w = guidance_scale if scale is None else scale
            if graphs:
                prog, span.attrs["captured"] = cached(batch)
                return prog.run(batch, x_init, z, w)
            tbatch = {k: batch[k].to(device) for k in BATCH_KEYS}
            denoise_fn = make_denoise_fn(model, tbatch, guided=guided,
                                         scale=w)
            kw = dict(noise=z, return_trajectory=return_trajectory,
                      trajectory_dtype=trajectory_dtype)
            if sampler == "ddim":
                return diffusion.sample_loop_ddim(
                    denoise_fn, x_init.to(device), n_steps=ddim_steps,
                    eta=ddim_eta, **kw)
            return diffusion.sample_loop(denoise_fn, x_init.to(device),
                                         step=step, **kw)

    def program(batch) -> StructureProgram:
        with image.frozen():
            return cached(batch)[0]

    run.program = program
    return run


def _to_host(t, stream):
    """``t`` on its way to the host: a copy into page-locked memory queued
    on ``stream`` after the work queued so far, and the event that marks
    its end; a tensor on the CPU as it is, with no event."""
    if t.device.type != "cuda":
        return t, None
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    t.record_stream(stream)   # not reused before the copy has read it
    return host, done


def sample_structure_batches(
    model,
    diffusion: GaussianAngleDiffusion,
    batches: Iterable[dict],
    *,
    device="cuda",
    seed: int = 0,
    step: int = 1,
    first_batch_only: bool = True,
    return_trajectory: bool = True,
    trajectory_dtype: torch.dtype | None = None,
    sampler: str = "ddpm",
    ddim_steps: int = 50,
    ddim_eta: float = 1.0,
    guidance_scale: float = 1.0,
) -> list[np.ndarray]:
    """Sample numpy batches on ``device`` (where the model lives); returns
    per-sample arrays shaped (T, len_i, 8) (trajectory) or (len_i, 8)
    (final only), the reference output.pkl layout, in f32 (a
    ``trajectory_dtype`` trajectory travels to the host in its type and
    becomes f32 there, as the JAX package's does).

    Batch n's copy to the host runs on a side stream while batch n+1
    samples (e3diff_tpu/sampling/structure.py:167-205, the pending /
    materialize pair): its result is a copy of the sampler's buffers,
    queued before the next batch's replays, and the host slices it once
    the next batch is queued."""
    device = resolve_device(device)
    run = make_structure_sampler(
        model, diffusion, step=step, return_trajectory=return_trajectory,
        trajectory_dtype=trajectory_dtype, sampler=sampler,
        ddim_steps=ddim_steps, ddim_eta=ddim_eta,
        guidance_scale=guidance_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    copies = torch.cuda.Stream(device) if device.type == "cuda" else None

    def materialize(pending):
        out, done, lengths, num_valid = pending
        if done is not None:
            done.synchronize()
        out = out.float().numpy()
        if return_trajectory:
            return [out[:, i, :lengths[i], :] for i in range(num_valid)]
        return [out[i, :lengths[i], :] for i in range(num_valid)]

    results = []
    pending = None
    for batch in batches:
        with telemetry.span("sample.to_device"):
            tbatch = {k: torch.as_tensor(np.asarray(v), device=device)
                      for k, v in strip_meta(batch).items()}
        final, traj = run(tbatch, generator)
        out, done = _to_host(traj if return_trajectory else final, copies)
        lengths = np.asarray(batch["ligand_attn_mask"]).sum(1).astype(int)
        num_valid = int(batch.get("num_valid", len(lengths)))
        if pending is not None:
            with telemetry.span("sample.results"):
                results.extend(materialize(pending))
        pending = (out, done, lengths, num_valid)
        if first_batch_only:
            break
    if pending is not None:
        with telemetry.span("sample.results"):
            results.extend(materialize(pending))
    return results
