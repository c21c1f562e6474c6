"""Batched sequence (inverse-folding) sampling with recovery rates
(counterpart of e3diff_tpu/sampling/sequence.py; sequence_model/
sample.py:181-258 and sample_by_generated_angles.py).

Per batch: draw the uniform one-hot noise and every step's Gumbel noise at
once, run the D3PM reverse loop of full SequenceDenoiser forwards (the
receptor fuse takes the timestep, so nothing is computed once per batch),
argmax the final logits, decode them to amino-acid strings and score them
against the true sequence. On the card the reverse step and the final
forward are CUDA graphs captured once per bucket and replayed (as in
sampling/structure.py); on the CPU, or when asked (``eager=True``), the
same step runs as a Python loop, on the same draws. ``generated_angles``
replaces the native ligand backbone angles with the structure sampler's
(the end-to-end pipeline). A mesh model samples its rank's dp rows, as
in sampling/structure.py.

One step on a given state: a bucket's ``SequenceProgram`` (``run.program
(batch)``) takes the batch, the one-hots ``x`` and the draws into its
static buffers with ``load(batch, x, gumbel, scale)``, which leaves it at
step 0 (``state.i``; set it to take a later step of ``state.s`` and
``state.t``); each ``step.replay()`` then takes one reverse step in place
on ``state.x``, and ``final.replay()`` writes the s = 0 logits to
``final.out``. ``run`` is ``load``, every step and the final forward, the
same bits.

Each sampler keeps a ``WeightImage`` of its model (models/blocks.py),
and each of its calls and captures runs inside its ``frozen()``, as in
sampling/structure.py.

Each sampler call runs inside a ``sequence.run`` span (utils/telemetry.py)
with its CUDA time on the card (``captured`` when the call captured its
bucket's program).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import AA_VOCAB, strip_meta
from e3diff_tpu_torch.diffusion.d3pm import D3PMDiffusion
from e3diff_tpu_torch.diffusion.guidance import (
    concat_cond_uncond,
    guided_combine,
)
from e3diff_tpu_torch.models.blocks import WeightImage
from e3diff_tpu_torch.sampling.graphs import (
    CapturedCall,
    check_capturable,
    fill_static,
)
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.device import resolve_device
from e3diff_tpu_torch.utils.graph_cache import GraphCache

COND_FIELDS = ("ligand_angles", "ligand_attn_mask", "receptor_seq",
               "receptor_angles", "receptor_attn_mask")


def make_denoise_fn(model, batch: dict, *, guided: bool, scale=1.0):
    """denoise_fn(s (B, 1), x one-hot) -> logits, one full forward per
    call on the batch's COND_FIELDS; when guided, over the 2B conditional
    ‖ null batch (the null branch drops the pocket and the ligand angles,
    as training's conditioning dropout does), combined with ``scale``."""
    cond = {f: batch[f] for f in COND_FIELDS}
    if guided:
        cond = concat_cond_uncond(cond, drop_ligand_angles=True)

    def denoise_fn(s_arr, x):
        if guided:
            s_arr = torch.cat([s_arr, s_arr])
            x = torch.cat([x, x])
        logits = model(s_arr, x, cond["ligand_angles"],
                       cond["ligand_attn_mask"], cond["receptor_seq"],
                       cond["receptor_angles"], cond["receptor_attn_mask"])
        return guided_combine(logits, scale) if guided else logits

    return denoise_fn


class SequenceProgram:
    """One bucket's sequence sampler on the card: the guided batch's
    conditioning (``prepare``, None unguided: the forward then reads the
    batch's buffers as they are), one reverse step and the final s = 0
    forward, each a ``CapturedCall`` over static buffers (the batch, the
    (B,) guidance scale, the ``D3PMState``)."""

    def __init__(self, model, d3pm: D3PMDiffusion, batch: dict, *,
                 diverse: bool, n_steps: int | None, guided: bool, pool):
        dev = next(model.parameters()).device
        self.inputs = {k: torch.zeros(batch[k].shape, dtype=batch[k].dtype,
                                      device=dev) for k in COND_FIELDS}
        lig = torch.zeros(batch["ligand_seq"].shape,
                          dtype=batch["ligand_seq"].dtype, device=dev)
        self.scale = (torch.ones(lig.shape[0], device=dev) if guided
                      else None)
        n = len(d3pm.step_pairs(n_steps))
        self.state = d3pm.reverse_state(
            lig, torch.zeros((n,) + tuple(lig.shape)) if diverse else None,
            n_steps)
        self.prepare = None
        if guided:
            self.prepare = CapturedCall(
                lambda: make_denoise_fn(model, self.inputs, guided=True,
                                        scale=self.scale), pool=pool,
                owner="sequence")
            self.prepare.replay()
            denoise_fn = self.prepare.out
        else:
            denoise_fn = make_denoise_fn(model, self.inputs, guided=False)
        self.step = CapturedCall(
            lambda: d3pm.reverse_step(denoise_fn, self.state,
                                      diverse=diverse),
            pool=pool, reset=self.state.i.zero_, owner="sequence")
        self.final = CapturedCall(
            lambda: d3pm.final_logits(denoise_fn, self.state.x), pool=pool,
            owner="sequence")
        self.n_steps = n

    def load(self, batch: dict, x, gumbel, scale) -> None:
        """Copy the batch's COND_FIELDS, the (B,) scale (guided programs),
        the one-hots ``x`` and every step's Gumbel draws (diverse
        programs) into the static buffers, put ``state.i`` at step 0, and
        replay ``prepare``: each ``step.replay()`` after it takes one
        reverse step from ``x``."""
        for k, buf in self.inputs.items():
            fill_static(buf, batch[k])
        if self.scale is not None:
            fill_static(self.scale, scale)
        st = self.state
        fill_static(st.x, x)
        if st.gumbel is not None:
            fill_static(st.gumbel, gumbel)
        st.i.zero_()
        if self.prepare is not None:
            self.prepare.replay()

    def run(self, batch: dict, x_init, gumbel, scale):
        """``load`` the batch and the draws, replay the steps and the final
        forward; returns a copy of the final logits."""
        self.load(batch, x_init, gumbel, scale)
        for _ in range(self.n_steps):
            self.step.replay()
        self.final.replay()
        return self.final.out.clone()

    def close(self) -> None:
        for call in (self.prepare, self.step, self.final):
            if call is not None:
                call.close()
        self.inputs = self.scale = self.state = None


def make_sequence_sampler(model, d3pm: D3PMDiffusion, *, diverse: bool = True,
                          n_steps: int | None = None, guidance_scale=1.0,
                          guided: bool | None = None,
                          cache: GraphCache | None = None,
                          eager: bool = False):
    """Returns run(batch, generator=None, noise=None, scale=None) -> final
    logits (B, L, K).

    batch: dict of tensors (ligand_seq for the shape, plus COND_FIELDS), on
    the model's device or on the host. generator: the device generator
    that x_init and then every step's Gumbel noise are drawn from, before
    the first step; or noise = {"x_init": (B, L, K) one-hots, "gumbel":
    (n_pairs, B, L, K)} to inject the draws ("gumbel" may be left out when
    ``diverse`` is False). On a mesh model the batch and injected draws
    are the rank's dp rows, and the generator's draws are made at the
    global batch's shape and cut.

    A guidance scale other than 1 (or guided=True) runs classifier-free
    guidance on the logits as one 2B forward per step. The scale, a number
    or a (B,) vector, may also be given per call.

    On the card each bucket's program is captured at its first call into
    ``cache`` (a new ``GraphCache`` when None) and replayed after;
    ``eager=True`` runs the Python loop there instead (the graphs'
    oracle). ``run.program(batch)`` returns the bucket's program,
    capturing it if needed."""
    if guided is None:
        guided = not (np.ndim(guidance_scale) == 0
                      and float(guidance_scale) == 1.0)
    device = next(model.parameters()).device
    graphs = device.type == "cuda" and not eager
    mesh = getattr(model, "mesh", None)
    check_capturable(mesh, graphs)
    if graphs and cache is None:
        cache = GraphCache()
    image = WeightImage(model)
    flags = ("sequence", diverse, n_steps, guided)

    def cached(batch) -> tuple[SequenceProgram, bool]:
        """The bucket's program, and whether this call captured it."""
        key = (id(model), id(d3pm), *flags,
               *((k, tuple(batch[k].shape), str(batch[k].dtype))
                 for k in COND_FIELDS + ("ligand_seq",)))
        prog = cache.get(key, model, d3pm)
        if prog is not None:
            return prog, False
        prog = SequenceProgram(model, d3pm, batch, diverse=diverse,
                               n_steps=n_steps, guided=guided,
                               pool=cache.pool())
        cache.put(key, prog, model, d3pm)
        return prog, True

    @torch.no_grad()
    def run(batch, generator=None, noise=None, scale=None):
        if noise is None and generator is None:
            raise ValueError("pass a generator or injected noise")
        lig = batch["ligand_seq"]
        bucket = (*lig.shape[:2], batch["receptor_seq"].shape[1])
        with telemetry.span("sequence.run", device=device.type == "cuda",
                            bucket=bucket) as span, image.frozen():
            if noise is None:
                n = lig.shape[0]
                r0, rows = (0, n) if mesh is None else mesh.rows(n)
                x_init, gumbel = d3pm.draw_noise(
                    (rows,) + tuple(lig.shape[1:]), n_steps,
                    generator=generator, device=device, dtype=lig.dtype,
                    diverse=diverse)
                x_init = x_init[r0:r0 + n]
                if gumbel is not None:
                    gumbel = gumbel[:, r0:r0 + n]
            else:
                x_init, gumbel = noise["x_init"], noise.get("gumbel")
                if diverse and gumbel is None:
                    raise ValueError("diverse sampling needs noise['gumbel']")
            w = guidance_scale if scale is None else scale
            if graphs:
                prog, span.attrs["captured"] = cached(batch)
                return prog.run(batch, x_init, gumbel, w)
            tbatch = {k: batch[k].to(device) for k in COND_FIELDS}
            return d3pm.sample_loop(
                make_denoise_fn(model, tbatch, guided=guided, scale=w),
                x_init.to(device=device, dtype=lig.dtype),
                gumbel=None if gumbel is None else gumbel.to(device),
                diverse=diverse, n_steps=n_steps)

    def program(batch) -> SequenceProgram:
        with image.frozen():
            return cached(batch)[0]

    run.program = program
    return run


def decode(indices: np.ndarray, mask: np.ndarray) -> str:
    return "".join(AA_VOCAB[i] for i in indices[mask.astype(bool)])


def sample_sequence_batches(
    model,
    d3pm: D3PMDiffusion,
    batches: Iterable[dict],
    *,
    device="cuda",
    seed: int = 0,
    diverse: bool = True,
    n_steps: int | None = None,
    generated_angles: Sequence[np.ndarray] | None = None,
    guidance_scale: float = 1.0,
) -> dict:
    """Sample numpy batches on ``device`` (where the model lives); returns
    the structure_ids, true_sequence, predict_sequence and recovery_rate
    lists (the reference's pickled DataFrame columns)."""
    device = resolve_device(device)
    run = make_sequence_sampler(model, d3pm, diverse=diverse,
                                n_steps=n_steps,
                                guidance_scale=guidance_scale)
    generator = torch.Generator(device=device).manual_seed(seed)
    out = {"structure_ids": [], "true_sequence": [],
           "predict_sequence": [], "recovery_rate": []}
    for batch_idx, batch in enumerate(batches):
        tbatch = {k: torch.as_tensor(np.asarray(v), device=device)
                  for k, v in strip_meta(batch).items()}
        if generated_angles is not None:
            tbatch["ligand_angles"] = torch.as_tensor(
                np.asarray(generated_angles[batch_idx]),
                dtype=tbatch["ligand_angles"].dtype, device=device)
        pred = run(tbatch, generator).float().argmax(-1).cpu().numpy()
        true = np.asarray(batch["ligand_seq"]).argmax(-1)
        masks = np.asarray(batch["ligand_attn_mask"])
        num_valid = int(batch.get("num_valid", pred.shape[0]))
        ids = batch.get("structure_ids", [{} for _ in range(pred.shape[0])])
        for i in range(num_valid):
            m = masks[i].astype(bool)
            out["recovery_rate"].append(
                float((pred[i][m] == true[i][m]).sum() / max(m.sum(), 1)))
            out["predict_sequence"].append(decode(pred[i], masks[i]))
            out["true_sequence"].append(decode(true[i], masks[i]))
            sid = ids[i] if i < len(ids) else {}
            out["structure_ids"].append(
                f'{sid.get("pdb_id", "?")}_{sid.get("ligand_chain", "?")}')
    return out
