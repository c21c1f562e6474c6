"""Design engine: both models -> batched pocket-conditioned peptide design
(counterpart of e3diff_tpu/serving/engine.py, without Orbax restore).

A design request is a preprocessing-schema complex record (the
reference's biolip.pt element layout, clean_data/data_preprocessing.py:
838-893) or a bare pocket built with :func:`pocket_record`. The engine
featurizes requests into fixed serving shapes, runs the structure sampler
(DDIM-25 by default), rebuilds the backbones on the device with the
batched NERF, formats PDB text, and inverse-folds the generated angles
with the sequence D3PM (the uniform transition by default, the reference's
end-to-end pairing, sample_by_generated_angles.py:253).

Requests are padded into slots, never reshaped. Shapes are chosen per
request along three bucket axes, the smallest configured bucket that
fits: ligand length, receptor length and batch size (a partial batch pads
to a small batch bucket; its dead slots carry all-zero attention masks).
On the card each bucket runs two captured programs, the structure
sampler's and the sequence sampler's (CUDA graphs, sampling/graphs.py),
from one bounded ``GraphCache`` of the engine's; ``warmup`` captures them.
A batch's features go to the programs' static buffers as asynchronous
copies from page-locked host memory. One lock serialises the device work
of concurrent callers: the replays, and the reading back of each batch's
results before the next batch replays.

With a ``mesh`` (parallel/mesh.py; both models built on it) every batch
bucket must divide by dp. Rank 0 is the controller: it takes the
requests, and broadcasts each device batch (the stacked slots, the
sampler's scales and a seed drawn from the caller's generator) to the
other ranks, which run ``follow()`` until ``stop_followers()``. Each rank
samples its dp rows (the noise drawn at the batch's shape from a
generator of that seed, and cut), and the rows come back to rank 0 as
host arrays over the mesh's gloo group.

Spans (utils/telemetry.py), on the caller's thread: ``engine.batch`` for
each device batch (its ligand, receptor and batch bucket, the slots used
and the ligand positions they fill), and inside it ``engine.inputs``
(stacking the slots and their page-locked copy), the samplers'
``structure.run`` and ``sequence.run``, ``engine.readback`` (the blocking
reads of the results) and ``engine.results`` (the PDB text and the
records, on the host). ``stats()`` counts the device batches per bucket.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Sequence

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import AA_VOCAB, LigandBindingSiteData
from e3diff_tpu_torch.geometry.nerf import nerf_build_backbone_batch
from e3diff_tpu_torch.geometry.pdb import backbone_pdb_text
from e3diff_tpu_torch.sampling.sequence import make_sequence_sampler
from e3diff_tpu_torch.sampling.structure import make_structure_sampler
from e3diff_tpu_torch.utils import telemetry
from e3diff_tpu_torch.utils.device import resolve_device
from e3diff_tpu_torch.utils.graph_cache import GraphCache


@dataclasses.dataclass
class DesignResult:
    sequence: str                 # inverse-folded peptide sequence
    angles: np.ndarray            # (peptide_len, 8) generated backbone angles
    pdb: str | None               # NERF-reconstructed backbone PDB text
    recovery_rate: float | None   # against the record's true ligand
                                  # sequence; None for a pocket record


def pocket_record(pocket_seq: str, pocket_angles: np.ndarray,
                  peptide_length: int) -> dict:
    """A design-request record from a bare pocket.

    The residues are used VERBATIM as the extended pocket (the record is
    marked ``already_extended`` and featurized with ext 0); a dummy
    poly-alanine ligand of ``peptide_length`` fills the slots the samplers
    design into (its angles start as noise and its sequence is never a
    recovery target: ``synthetic_ligand``)."""
    pocket_angles = np.asarray(pocket_angles, np.float32)
    n_pocket = len(pocket_seq)
    if pocket_angles.shape != (n_pocket, 8):
        raise ValueError(
            f"pocket_angles shape {pocket_angles.shape} != ({n_pocket}, 8)")
    if peptide_length < 1:
        raise ValueError("peptide_length must be >= 1")
    bad = sorted(set(pocket_seq) - set(AA_VOCAB))
    if bad:
        raise ValueError(f"unknown residues in pocket_seq: {bad}")
    n = n_pocket + peptide_length
    angles = np.concatenate(
        [pocket_angles, np.zeros((peptide_length, 8), np.float32)])
    lig_mask = np.zeros(n, bool)
    lig_mask[n_pocket:] = True
    return {
        "amino_acid": list(pocket_seq + "A" * peptide_length),
        "angle_features": angles,
        "ligand_mask": lig_mask,
        "pocket_mask": ~lig_mask,
        "already_extended": True,
        "synthetic_ligand": True,
        "structure_ids": {"pdb_id": "request", "ligand_chain": "A"},
    }


def _buckets(values, limit: int, what: str, name: str) -> list[int]:
    buckets = sorted({int(b) for b in values})
    for b in buckets:
        if not 1 <= b <= limit:
            raise ValueError(f"{what} bucket {b} outside [1, {name}={limit}]")
    return buckets


def _fresh_generator(device) -> torch.Generator:
    seed = int(np.random.SeedSequence().entropy % (2 ** 63))
    return torch.Generator(device=device).manual_seed(seed)


class DesignEngine:
    """Serves batched design requests with both models on one device, or
    over a mesh.

    cfg: the sampling config (utils/presets.py::ExperimentConfig or any
    object with pocket_ext, max_seq_len and ligand_max_len). The models
    carry their weights, on ``device``. ``mesh``: the mesh both models
    were built for (rank 0 leads, the others ``follow()``); on a mesh
    whose collectives cannot be captured (gloo) the samplers run their
    eager loop."""

    _DEVICE_KEYS = ("ligand_angles", "ligand_attn_mask", "ligand_seq",
                    "receptor_angles", "receptor_attn_mask", "receptor_seq")

    def __init__(self, cfg, structure_model, structure_diffusion,
                 sequence_model, sequence_d3pm, *, device="cuda",
                 batch_size: int = 64, sampler: str = "ddim",
                 ddim_steps: int = 25, ddim_eta: float = 1.0, step: int = 1,
                 seq_skip_steps: int | None = None, diverse: bool = True,
                 guidance_scale: float = 1.0,
                 seq_guidance_scale: float = 1.0, enable_cfg: bool = False,
                 ligand_buckets: Sequence[int] | None = None,
                 receptor_buckets: Sequence[int] | None = None,
                 batch_buckets: Sequence[int] | None = None, mesh=None):
        self.mesh = mesh
        eager = mesh is not None and not mesh.can_capture
        for m in (structure_model, sequence_model):
            if getattr(m, "mesh", None) is not mesh:
                raise ValueError("the models were built for another mesh")
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.ligand_buckets = _buckets(
            ligand_buckets or [cfg.ligand_max_len or cfg.max_seq_len],
            cfg.max_seq_len, "ligand", "max_seq_len")
        self.receptor_buckets = _buckets(
            receptor_buckets or [cfg.max_seq_len], cfg.max_seq_len,
            "receptor", "max_seq_len")
        # the largest batch bucket is always batch_size (the chunk size)
        self.batch_buckets = _buckets(
            [*(batch_buckets or []), batch_size], batch_size, "batch",
            "batch_size")
        if mesh is not None:
            for b in self.batch_buckets:
                if b % mesh.dp:
                    raise ValueError(
                        f"batch bucket {b} must be divisible by the mesh's "
                        f"dp extent {mesh.dp} (fixed serving shapes)")
        self.structure_model = structure_model
        self.sequence_model = sequence_model
        self.structure_diffusion = structure_diffusion
        self.sequence_d3pm = sequence_d3pm
        # classifier-free guidance: a sampler is guided when its default
        # scale is not 1 or enable_cfg asks for it; a guided sampler takes
        # each slot's own scale as a (B,) vector
        self.guidance_scale = float(guidance_scale)
        self.seq_guidance_scale = float(seq_guidance_scale)
        self._struct_guided = enable_cfg or self.guidance_scale != 1.0
        self._seq_guided = enable_cfg or self.seq_guidance_scale != 1.0
        # both samplers' captured programs, one of each per bucket
        self.graphs = GraphCache()
        self._struct_run = make_structure_sampler(
            structure_model, structure_diffusion, step=step,
            return_trajectory=False, sampler=sampler,
            ddim_steps=ddim_steps, ddim_eta=ddim_eta,
            guidance_scale=guidance_scale, guided=self._struct_guided,
            cache=self.graphs, eager=eager)
        self._seq_run = make_sequence_sampler(
            sequence_model, sequence_d3pm, diverse=diverse,
            n_steps=seq_skip_steps, guidance_scale=seq_guidance_scale,
            guided=self._seq_guided, cache=self.graphs, eager=eager)
        # one device, callers on many threads: one batch at a time
        self._device_lock = threading.Lock()
        self._warm = False
        self._stats_lock = threading.Lock()
        self._buckets: dict[tuple, list[int]] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoints(cls, structure_ckpt: str, sequence_ckpt: str, *,
                         transition: str = "uniform",
                         params_dtype: str | None = None,
                         seq_params_dtype: str | None = None,
                         device="cuda", mesh=None,
                         **kwargs) -> "DesignEngine":
        """An engine from two reference-layout ``.pt`` state_dicts (the
        reference's own, or the JAX package's ``export_*_state_dict``),
        each model's architecture from its ``config.json`` sidecar.

        params_dtype: weight storage of both models (one of
        utils/params_io.py's PARAMS_DTYPES); seq_params_dtype: the sequence
        model's, when it should differ (None: params_dtype). ``mesh``:
        every rank loads both files, stores them, and keeps its shard."""
        from e3diff_tpu_torch.utils import builders
        from e3diff_tpu_torch.utils.params_io import (
            cast_inference_params,
            load_sequence_checkpoint,
            load_structure_checkpoint,
        )
        from e3diff_tpu_torch.utils.presets import (
            check_shared_fields,
            config_from_sidecar,
            load_ckpt_config,
            structure_sample_config,
        )

        device = resolve_device(device)
        if seq_params_dtype is None:
            seq_params_dtype = params_dtype
        cfg = config_from_sidecar(structure_sample_config(),
                                  load_ckpt_config(structure_ckpt))
        qside = load_ckpt_config(sequence_ckpt) or {}
        check_shared_fields(cfg, qside)
        qcfg = dataclasses.replace(
            cfg, timesteps=qside.get("timesteps", 50),
            num_hidden_layers=qside.get("num_hidden_layers", 6))

        if mesh is not None:
            device = mesh.device
        smodel = builders.build_structure_model(cfg, device=device)
        load_structure_checkpoint(structure_ckpt, smodel)
        cast_inference_params(smodel, params_dtype)
        qmodel = builders.build_sequence_model(qcfg, device=device)
        load_sequence_checkpoint(sequence_ckpt, qmodel, qcfg.timesteps)
        cast_inference_params(qmodel, seq_params_dtype)
        if mesh is not None:
            from e3diff_tpu_torch.parallel import load_shard, shard_params

            # the stored weights (int8 with its scales) cut to the shard
            full = (smodel, qmodel)
            smodel = builders.build_structure_model(cfg, device=device,
                                                    mesh=mesh)
            qmodel = builders.build_sequence_model(qcfg, device=device,
                                                   mesh=mesh)
            for shard, whole in zip((smodel, qmodel), full):
                load_shard(shard, shard_params(
                    whole.state_dict(), mesh, rules=shard.sharding_rules))
            del full
        return cls(cfg, smodel,
                   builders.build_structure_diffusion(cfg, device=device),
                   qmodel,
                   builders.build_sequence_diffusion(qcfg, transition,
                                                     device=device),
                   device=device, mesh=mesh, **kwargs)

    # ------------------------------------------------------------------
    def _pick_bucket(self, record: dict) -> int:
        """Smallest ligand bucket that fits the request's peptide."""
        n = int(np.asarray(record["ligand_mask"]).sum())
        for b in self.ligand_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request does not fit the serving shapes: peptide length "
            f"{n} exceeds the largest ligand bucket "
            f"({self.ligand_buckets[-1]} residues)")

    def _pick_receptor_bucket(self, rec_len: int) -> int:
        """Smallest receptor bucket that fits the extended pocket."""
        for b in self.receptor_buckets:
            if rec_len <= b:
                return b
        raise ValueError(
            f"request does not fit the serving shapes: extended pocket "
            f"length {rec_len} exceeds the largest receptor bucket "
            f"({self.receptor_buckets[-1]} residues)")

    def _slot_scale(self, value, default: float, guided: bool,
                    name: str) -> float:
        """A per-request guidance scale, refused where the sampler is not
        guided (ignoring it would give the request what it did not ask)."""
        if value is None:
            return default
        w = float(value)
        if not np.isfinite(w):
            raise ValueError(f"{name} must be finite, got {value!r}")
        if not guided and w != default:
            raise ValueError(
                f"{name}={w} needs a CFG-enabled engine (enable_cfg or a "
                f"default scale other than 1) and a checkpoint trained "
                f"with conditioning dropout")
        return w

    def featurize(self, record: dict, *, guidance_scale=None,
                  seq_guidance_scale=None) -> dict:
        """One record -> one slot's features at the serving shapes (the
        peptide padded to the smallest ligand bucket it fits, slot
        ['_bucket'], the pocket sliced to its receptor bucket,
        ['_rbucket']). Per-request CFG scales override the engine's."""
        ext = 0 if record.get("already_extended") else self.cfg.pocket_ext
        bucket = self._pick_bucket(record)
        try:
            ds = LigandBindingSiteData(
                [record], None, max_len=self.cfg.max_seq_len,
                pocket_ext=ext, ligand_max_len=bucket)
        except RuntimeError as exc:
            # an oversized pocket ("Length exceed") is the request's fault
            raise ValueError(
                f"request does not fit the serving shapes (receptor "
                f"<= {self.cfg.max_seq_len} residues): {exc}") from exc
        slot = ds[0]
        # padding is a zero tail: slicing to the bucket keeps every residue
        rbucket = self._pick_receptor_bucket(int(slot["receptor_length"]))
        for k in ("receptor_angles", "receptor_attn_mask", "receptor_seq"):
            slot[k] = slot[k][:rbucket]
        slot["_synthetic_ligand"] = bool(record.get("synthetic_ligand"))
        slot["_bucket"] = bucket
        slot["_rbucket"] = rbucket
        slot["_guidance_scale"] = self._slot_scale(
            guidance_scale, self.guidance_scale, self._struct_guided,
            "guidance_scale")
        slot["_seq_guidance_scale"] = self._slot_scale(
            seq_guidance_scale, self.seq_guidance_scale, self._seq_guided,
            "seq_guidance_scale")
        return slot

    def warmup(self, generator: torch.Generator | None = None,
               shapes=None) -> None:
        """Run every (receptor, ligand, batch) bucket combination once on
        dummy requests, or only the triples in ``shapes``: the first run
        builds the kernels and, on the card, captures the bucket's two
        programs (as the JAX engine's warmup compiles); a capture that
        fails raises. One line per combination, with its seconds, goes to
        stderr."""
        if shapes is None:
            shapes = [(rb, b, bb) for rb in self.receptor_buckets
                      for b in self.ligand_buckets
                      for bb in self.batch_buckets]
        shapes = list(shapes)
        for i, (rb, b, bb) in enumerate(shapes):
            if (rb not in self.receptor_buckets or b not in self.ligand_buckets
                    or bb not in self.batch_buckets):
                raise ValueError(
                    f"warmup shape (rec={rb}, lig={b}, batch={bb}) is not "
                    f"in the configured buckets {self.receptor_buckets} x "
                    f"{self.ligand_buckets} x {self.batch_buckets}")
            # a pocket of exactly rb residues routes to bucket rb
            rec = pocket_record("A" * rb, np.zeros((rb, 8), np.float32), b)
            with telemetry.span("engine.warmup", receptor=rb, ligand=b,
                                batch=bb) as warm:
                self.design_records([rec] * bb, generator=generator,
                                    return_pdb=False)
            print(f"[warmup {i + 1}/{len(shapes)}] rec={rb} lig={b} "
                  f"batch={bb}: {warm.seconds:.1f}s",
                  file=sys.stderr, flush=True)
        self._warm = True

    @property
    def ready(self) -> bool:
        return self._warm

    def stats(self) -> dict:
        """Device batches run so far, per kind and (ligand, receptor,
        batch) bucket: ``batches``, ``slots`` used, ``dead_slots`` and
        ``padded_positions`` (ligand positions no slot fills)."""
        with self._stats_lock:
            rows = sorted(self._buckets.items())
        return {"buckets": [
            {"kind": kind, "ligand": lig, "receptor": rec, "batch": bb,
             "batches": n, "slots": slots, "dead_slots": n * bb - slots,
             "padded_positions": n * bb * lig - used}
            for (kind, lig, rec, bb), (n, slots, used) in rows]}

    def _count(self, span, kind: str, chunk, batch) -> None:
        """The batch's bucket and fill, on its span and in ``stats()``."""
        bb, lig = batch["ligand_attn_mask"].shape[:2]
        rec = batch["receptor_attn_mask"].shape[1]
        used = int(batch["ligand_attn_mask"].sum())
        span.attrs.update(ligand=lig, receptor=rec, batch=bb,
                          slots=len(chunk), positions=used)
        with self._stats_lock:
            row = self._buckets.setdefault((kind, lig, rec, bb), [0, 0, 0])
            row[0] += 1
            row[1] += len(chunk)
            row[2] += used

    # ------------------------------------------------------------------
    def design_records(self, records: Sequence[dict],
                       generator: torch.Generator | None = None,
                       return_pdb: bool = True) -> list[DesignResult]:
        """Featurize request records and run the full design pipeline."""
        return self.design_slots([self.featurize(r) for r in records],
                                 generator=generator, return_pdb=return_pdb)

    def design_slots(self, slots: Sequence[dict],
                     generator: torch.Generator | None = None,
                     return_pdb=True) -> list[DesignResult]:
        """The design pipeline for featurized slots, in input order. Slots
        are grouped by (ligand, receptor) bucket, chunked at batch_size,
        and each chunk padded to the smallest batch bucket that fits it.
        ``return_pdb`` is a bool or one bool per slot. Noise comes from
        ``generator`` (a device generator), or from a fresh seed."""
        if not slots:
            return []
        if isinstance(return_pdb, bool):
            return_pdb = [return_pdb] * len(slots)
        if len(return_pdb) != len(slots):
            raise ValueError("return_pdb length != slots length")
        generator = generator or _fresh_generator(self.device)
        results: list[DesignResult | None] = [None] * len(slots)
        for idxs in self._bucket_groups(slots):
            chunk_slots = [slots[i] for i in idxs]
            want = [return_pdb[i] for i in idxs]
            for start in range(0, len(idxs), self.batch_size):
                sub = self._design_batch(
                    chunk_slots[start:start + self.batch_size],
                    want[start:start + self.batch_size], generator)
                for i, r in zip(idxs[start:start + self.batch_size], sub):
                    results[i] = r
        return results

    def inverse_fold_slots(self, slots: Sequence[dict],
                           generator: torch.Generator | None = None,
                           noise: Sequence[dict] | None = None
                           ) -> list[DesignResult]:
        """Inverse folding only: sequences for the slots' OWN ligand
        backbone angles (the reference's sample_sequence use case,
        sequence_model/sample.py:231-258). Grouped and chunked as
        ``design_slots``. ``noise``: one injected-draws dict of the
        sequence sampler (see sampling/sequence.py) per device batch, in
        the order the batches run, in place of ``generator``'s draws."""
        if not slots:
            return []
        generator = generator or _fresh_generator(self.device)
        noise_iter = None if noise is None else iter(noise)
        results: list[DesignResult | None] = [None] * len(slots)
        for idxs in self._bucket_groups(slots):
            for start in range(0, len(idxs), self.batch_size):
                part = idxs[start:start + self.batch_size]
                sub = self._inverse_fold_batch(
                    [slots[i] for i in part], generator,
                    None if noise_iter is None else next(noise_iter))
                for i, r in zip(part, sub):
                    results[i] = r
        return results

    def design(self, record: dict, n_designs: int = 1,
               generator: torch.Generator | None = None,
               return_pdb: bool = True) -> list[DesignResult]:
        """n_designs independent candidates for one record (each in its
        own batch slot, with its own noise)."""
        return self.design_records([record] * n_designs, generator=generator,
                                   return_pdb=return_pdb)

    # ------------------------------------------------------------------
    def _pick_batch_bucket(self, n: int) -> int:
        """Smallest batch bucket that fits n slots."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]  # unreachable: chunks <= batch_size

    def _bucket_groups(self, slots) -> list[list[int]]:
        """Slot indices grouped by (ligand, receptor) bucket, ascending."""
        groups: dict[tuple[int, int], list[int]] = {}
        default = (self.ligand_buckets[-1], self.receptor_buckets[-1])
        for i, s in enumerate(slots):
            key = (int(s.get("_bucket", default[0])),
                   int(s.get("_rbucket", default[1])))
            groups.setdefault(key, []).append(i)
        return [groups[b] for b in sorted(groups)]

    def _stack_slots(self, chunk) -> dict:
        """The chunk's features stacked and zero-padded to its batch
        bucket: dead slots carry all-zero attention masks."""
        bucket = self._pick_batch_bucket(len(chunk))
        batch = {}
        for k in chunk[0]:
            if k.startswith("_"):
                continue
            stacked = np.stack([s[k] for s in chunk])
            if len(chunk) < bucket:
                pad = np.zeros((bucket - len(chunk),) + stacked.shape[1:],
                               stacked.dtype)
                stacked = np.concatenate([stacked, pad])
            batch[k] = stacked
        return batch

    def _scale_kwargs(self, chunk, batch_n: int, guided: bool,
                      slot_key: str, default: float) -> dict:
        """The slots' guidance scales as a (B,) ``scale`` for a guided
        sampler ({} for a plain one); dead slots take the default."""
        if not guided:
            return {}
        w = np.full(batch_n, default, np.float32)
        w[:len(chunk)] = [s.get(slot_key, default) for s in chunk]
        return {"scale": w}

    def _tensors(self, batch: dict) -> dict:
        """The batch's sampler inputs as host tensors, page-locked when the
        engine serves on the card (the samplers copy them into their
        static buffers asynchronously)."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items() if k in self._DEVICE_KEYS}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _results(self, chunk, batch, pred, angles, coords=None,
                 want_pdb=None) -> list[DesignResult]:
        with telemetry.span("engine.results"):
            results = []
            for i, slot in enumerate(chunk):
                length = int(batch["ligand_attn_mask"][i].sum())
                pdb = None
                if want_pdb is not None and want_pdb[i]:
                    xyz = coords[i, :4 * length]
                    if length and not np.any(np.isnan(xyz)):
                        # centred over the valid chain, as the trimmed
                        # chain's own centred reconstruction (reference
                        # NaN guard kept)
                        pdb = backbone_pdb_text(xyz - xyz.mean(0))
                recovery = None
                if not slot["_synthetic_ligand"]:
                    true = batch["ligand_seq"][i, :length].argmax(-1)
                    recovery = float((pred[i, :length] == true).sum()
                                     / max(length, 1))
                results.append(DesignResult(
                    sequence="".join(AA_VOCAB[j]
                                     for j in pred[i, :length]),
                    angles=np.asarray(angles[i, :length], np.float32),
                    pdb=pdb, recovery_rate=recovery))
            return results

    def _design_batch(self, chunk, want_pdb, generator) -> list[DesignResult]:
        """Structure sampler, device NERF and sequence sampler for one
        same-bucket chunk; the host reads each result once per batch."""
        with telemetry.span("engine.batch", kind="design") as span:
            with telemetry.span("engine.inputs"):
                batch = self._stack_slots(chunk)
                tbatch = None if self.mesh is not None else self._tensors(
                    batch)
            self._count(span, "design", chunk, batch)
            bsz = len(batch["ligand_attn_mask"])
            struct_kw = self._scale_kwargs(chunk, bsz, self._struct_guided,
                                           "_guidance_scale",
                                           self.guidance_scale)
            seq_kw = self._scale_kwargs(chunk, bsz, self._seq_guided,
                                        "_seq_guidance_scale",
                                        self.seq_guidance_scale)
            if self.mesh is not None:
                angles_np, pred = self._lead(
                    "design", batch, self._seed(generator),
                    struct_kw=struct_kw, seq_kw=seq_kw)
                coords = None
                if any(want_pdb):
                    with self._device_lock, telemetry.span("engine.readback"):
                        coords = nerf_build_backbone_batch(torch.from_numpy(
                            angles_np).to(self.device)).cpu().numpy()
                return self._results(chunk, batch, pred, angles_np, coords,
                                     want_pdb)
            with self._device_lock:
                angles, logits = self._design_rows(tbatch, generator,
                                                   struct_kw, seq_kw)
                with telemetry.span("engine.readback"):
                    coords = None
                    if any(want_pdb):
                        coords = nerf_build_backbone_batch(
                            angles).cpu().numpy()
                    angles_np = angles.float().cpu().numpy()
                    pred = logits.float().argmax(-1).cpu().numpy()
            return self._results(chunk, batch, pred, angles_np, coords,
                                 want_pdb)

    def _design_rows(self, tbatch, generator, struct_kw, seq_kw):
        """Both samplers over a batch of tensors: (angles, logits)."""
        angles, _ = self._struct_run(tbatch, generator, **struct_kw)
        seq_batch = dict(tbatch)
        seq_batch["ligand_angles"] = angles.to(tbatch["ligand_angles"].dtype)
        return angles, self._seq_run(seq_batch, generator, **seq_kw)

    def _inverse_fold_batch(self, chunk, generator, noise
                            ) -> list[DesignResult]:
        with telemetry.span("engine.batch", kind="inverse_fold") as span:
            with telemetry.span("engine.inputs"):
                batch = self._stack_slots(chunk)
                tbatch = None if self.mesh is not None else self._tensors(
                    batch)
            self._count(span, "inverse_fold", chunk, batch)
            seq_kw = self._scale_kwargs(
                chunk, len(batch["ligand_attn_mask"]), self._seq_guided,
                "_seq_guidance_scale", self.seq_guidance_scale)
            if self.mesh is not None:
                if noise is not None:
                    noise = {k: v.cpu() for k, v in noise.items()}
                _, pred = self._lead("inverse_fold", batch,
                                     self._seed(generator), seq_kw=seq_kw,
                                     noise=noise)
                return self._results(chunk, batch, pred,
                                     batch["ligand_angles"])
            with self._device_lock:
                logits = self._seq_run(tbatch, generator, noise=noise,
                                       **seq_kw)
                with telemetry.span("engine.readback"):
                    pred = logits.float().argmax(-1).cpu().numpy()
            return self._results(chunk, batch, pred, batch["ligand_angles"])

    # -- the mesh: rank 0 leads, the other ranks follow ------------------
    def _seed(self, generator) -> int:
        """A device batch's seed under a mesh, drawn from the caller's
        generator: every rank seeds its own generator with it."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())

    def _lead(self, kind: str, batch: dict, seed: int, **kw):
        """Rank 0: broadcast one device batch, sample its own rows, and
        collect every dp group's: (angles (B, L, 8) or None, argmax
        classes (B, L)) as host arrays."""
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 leads; the others follow()")
        with self._device_lock:
            self.mesh.broadcast_object((kind, batch, seed, kw))
            parts = self.mesh.gather_objects(self._run_rows(kind, batch, seed,
                                                            **kw))
        # one part per dp group: its tp rank 0's
        parts = parts[::self.mesh.tp]
        angles = (None if parts[0][0] is None
                  else np.concatenate([p[0] for p in parts]))
        return angles, np.concatenate([p[1] for p in parts])

    def _run_rows(self, kind, batch, seed, struct_kw=None, seq_kw=None,
                  noise=None):
        """This rank's dp rows of a broadcast batch through the samplers:
        (angles or None, argmax classes) as host arrays."""
        n = len(batch["ligand_attn_mask"]) // self.mesh.dp
        rows = slice(self.mesh.dp_rank * n, (self.mesh.dp_rank + 1) * n)

        def mine(kwargs):
            return {k: (v[rows] if np.ndim(v) else v)
                    for k, v in (kwargs or {}).items()}

        tbatch = self._tensors({k: v[rows] for k, v in batch.items()})
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if kind == "design":
            angles, logits = self._design_rows(tbatch, gen, mine(struct_kw),
                                               mine(seq_kw))
            angles = angles.float().cpu().numpy()
        else:
            if noise is not None:
                noise = {k: v[:, rows] if k == "gumbel" else v[rows]
                         for k, v in noise.items()}
            angles = None
            logits = self._seq_run(tbatch, gen, noise=noise, **mine(seq_kw))
        return angles, logits.float().argmax(-1).cpu().numpy()

    def follow(self) -> None:
        """Every rank but 0: run the device batches rank 0 broadcasts,
        until ``stop_followers``."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() is for the ranks other than 0 of a "
                               "mesh")
        while True:
            msg = self.mesh.broadcast_object()
            if msg is None:
                return
            kind, batch, seed, kw = msg
            self.mesh.gather_objects(self._run_rows(kind, batch, seed, **kw))

    def stop_followers(self) -> None:
        """Rank 0: release the other ranks from ``follow()``."""
        if self.mesh is not None and self.mesh.rank == 0:
            with self._device_lock:
                self.mesh.broadcast_object(None)
