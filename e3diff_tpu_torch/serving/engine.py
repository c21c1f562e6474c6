"""Design engine: both models -> batched pocket-conditioned peptide design
(counterpart of e3diff_tpu/serving/engine.py, without the multi-device
``mesh`` and without Orbax restore).

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
One lock serialises the device work of concurrent callers.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Sequence

import numpy as np
import torch

from e3diff_tpu_torch.data.dataset import AA_VOCAB, LigandBindingSiteData
from e3diff_tpu_torch.geometry.nerf import nerf_build_backbone_batch
from e3diff_tpu_torch.geometry.pdb import backbone_pdb_text
from e3diff_tpu_torch.sampling.sequence import make_sequence_sampler
from e3diff_tpu_torch.sampling.structure import make_structure_sampler
from e3diff_tpu_torch.utils.device import resolve_device


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
    """Serves batched design requests with both models on one device.

    cfg: the sampling config (utils/presets.py::ExperimentConfig or any
    object with pocket_ext, max_seq_len and ligand_max_len). The models
    carry their weights, on ``device``."""

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
                 batch_buckets: Sequence[int] | None = None):
        self.device = resolve_device(device)
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
        self._struct_run = make_structure_sampler(
            structure_model, structure_diffusion, step=step,
            return_trajectory=False, sampler=sampler,
            ddim_steps=ddim_steps, ddim_eta=ddim_eta,
            guidance_scale=guidance_scale, guided=self._struct_guided)
        self._seq_run = make_sequence_sampler(
            sequence_model, sequence_d3pm, diverse=diverse,
            n_steps=seq_skip_steps, guidance_scale=seq_guidance_scale,
            guided=self._seq_guided)
        # one device, callers on many threads: one batch at a time
        self._device_lock = threading.Lock()
        self._warm = False

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoints(cls, structure_ckpt: str, sequence_ckpt: str, *,
                         transition: str = "uniform",
                         params_dtype: str | None = None,
                         seq_params_dtype: str | None = None,
                         device="cuda", **kwargs) -> "DesignEngine":
        """An engine from two reference-layout ``.pt`` state_dicts (the
        reference's own, or the JAX package's ``export_*_state_dict``),
        each model's architecture from its ``config.json`` sidecar.

        params_dtype: weight storage of both models ("f32", "bf16_matmul"
        or "int8_matmul"); seq_params_dtype: the sequence model's, when it
        should differ (None: params_dtype)."""
        from e3diff_tpu_torch.diffusion import (
            D3PMDiffusion,
            GaussianAngleDiffusion,
        )
        from e3diff_tpu_torch.models import SequenceDenoiser, StructureDenoiser
        from e3diff_tpu_torch.ops.transitions import (
            BlosumTransition,
            UniformTransition,
        )
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
            transformer_configs,
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

        smodel = StructureDenoiser(*transformer_configs(cfg, "torch_default"),
                                   device=device, seed=None)
        load_structure_checkpoint(structure_ckpt, smodel)
        cast_inference_params(smodel, params_dtype)
        qmodel = SequenceDenoiser(*transformer_configs(qcfg, "xavier_all"),
                                  device=device, seed=None)
        load_sequence_checkpoint(sequence_ckpt, qmodel, qcfg.timesteps)
        cast_inference_params(qmodel, seq_params_dtype)
        trans = (BlosumTransition(device=device) if transition == "blosum"
                 else UniformTransition(20))
        return cls(cfg, smodel,
                   GaussianAngleDiffusion.cosine(cfg.timesteps, device=device),
                   qmodel,
                   D3PMDiffusion.create(trans, timesteps=qcfg.timesteps,
                                        device=device),
                   device=device, **kwargs)

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
        builds the kernels and allocates each shape's memory. One line per
        combination, with its seconds, goes to stderr."""
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
            t0 = time.monotonic()
            # a pocket of exactly rb residues routes to bucket rb
            rec = pocket_record("A" * rb, np.zeros((rb, 8), np.float32), b)
            self.design_records([rec] * bb, generator=generator,
                                return_pdb=False)
            print(f"[warmup {i + 1}/{len(shapes)}] rec={rb} lig={b} "
                  f"batch={bb}: {time.monotonic() - t0:.1f}s",
                  file=sys.stderr, flush=True)
        self._warm = True

    @property
    def ready(self) -> bool:
        return self._warm

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

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items() if k in self._DEVICE_KEYS}

    def _results(self, chunk, batch, pred, angles, coords=None,
                 want_pdb=None) -> list[DesignResult]:
        results = []
        for i, slot in enumerate(chunk):
            length = int(batch["ligand_attn_mask"][i].sum())
            pdb = None
            if want_pdb is not None and want_pdb[i]:
                xyz = coords[i, :4 * length]
                if length and not np.any(np.isnan(xyz)):
                    # centred over the valid chain, as the trimmed chain's
                    # own centred reconstruction (reference NaN guard kept)
                    pdb = backbone_pdb_text(xyz - xyz.mean(0))
            recovery = None
            if not slot["_synthetic_ligand"]:
                true = batch["ligand_seq"][i, :length].argmax(-1)
                recovery = float((pred[i, :length] == true).sum()
                                 / max(length, 1))
            results.append(DesignResult(
                sequence="".join(AA_VOCAB[j] for j in pred[i, :length]),
                angles=np.asarray(angles[i, :length], np.float32), pdb=pdb,
                recovery_rate=recovery))
        return results

    def _design_batch(self, chunk, want_pdb, generator) -> list[DesignResult]:
        """Structure sampler, device NERF and sequence sampler for one
        same-bucket chunk; the host reads each result once per batch."""
        batch = self._stack_slots(chunk)
        bsz = len(batch["ligand_attn_mask"])
        tbatch = self._to_device(batch)
        struct_kw = self._scale_kwargs(chunk, bsz, self._struct_guided,
                                       "_guidance_scale", self.guidance_scale)
        seq_kw = self._scale_kwargs(chunk, bsz, self._seq_guided,
                                    "_seq_guidance_scale",
                                    self.seq_guidance_scale)
        with self._device_lock:
            angles, _ = self._struct_run(tbatch, generator, **struct_kw)
            seq_batch = dict(tbatch)
            seq_batch["ligand_angles"] = angles.to(
                tbatch["ligand_angles"].dtype)
            logits = self._seq_run(seq_batch, generator, **seq_kw)
            coords = None
            if any(want_pdb):
                coords = nerf_build_backbone_batch(angles).cpu().numpy()
            angles_np = angles.float().cpu().numpy()
            pred = logits.float().argmax(-1).cpu().numpy()
        return self._results(chunk, batch, pred, angles_np, coords, want_pdb)

    def _inverse_fold_batch(self, chunk, generator, noise
                            ) -> list[DesignResult]:
        batch = self._stack_slots(chunk)
        seq_kw = self._scale_kwargs(
            chunk, len(batch["ligand_attn_mask"]), self._seq_guided,
            "_seq_guidance_scale", self.seq_guidance_scale)
        with self._device_lock:
            logits = self._seq_run(self._to_device(batch), generator,
                                   noise=noise, **seq_kw)
            pred = logits.float().argmax(-1).cpu().numpy()
        return self._results(chunk, batch, pred, batch["ligand_angles"])
