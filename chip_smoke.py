"""Smoke run of the PyTorch / CUDA port (``e3diff_tpu_torch``) on one card.

Phases, each of which stops the run with a non-zero exit when it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``e3diff_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a, printing the build seconds, ``ptxas`` resources
   (and, for the training kernels, their registers and resident blocks per
   SM from the occupancy API) and, where ``cuobjdump`` exists, each
   kernel's tensor-core (HMMA) and 16-byte load and store instructions in
   the SASS;
3. hold each kernel against its plain PyTorch version on the card, in f32
   and bf16, at the shapes the structure sampler gives it and at the edges
   of its contract (and the f32 attention also against a float64 softmax
   reference);
4. build the full-width 146M ``StructureDenoiser`` with seeded random
   weights and bf16 compute, and check its parameter count;
5. one ``decode`` through the kernels against the same ``decode`` through
   the plain versions, in bf16 and in f32;
6. the main path: the structure sampler at B=32, receptor 64, ligand 16 --
   DDPM-1000, DDIM-25 and CFG w=1.5 DDIM-25, with int8_matmul and f32
   weight storage, plus the sampling CLI, each a fresh sampler that
   captures its CUDA graphs at its first call -- checking that every
   sample is finite and in [-pi, pi) and that the run launched the kernels
   exactly as often as the capture of one encode (13 + 29) and one
   reverse step (25 + 41) does, its warm-up calls included, and printing
   the seconds of the first call and of a second one (replays only);
   then (6.2) the sampling CLI's DDPM-1000 trajectory kept, without and
   with --trajectory_bf16 from one seed (the bf16 pickle is the f32 one
   rounded to bf16, exactly), a captured DDIM-25 run with a bf16
   trajectory buffer against the eager loop (bit for bit), and
   sample_structure_batches over 3 DDPM-1000 batches (each batch's copy
   to the host overlapping the next batch) against the serial loop it
   replaced, in turns, the same arrays and the seconds of each;
7. each kernel's device time beside its plain version, a one-call PyTorch
   yardstick and its bound, at each main-path shape;
8. the design request at full width: the 61M ``SequenceDenoiser`` (its
   parameter count, one forward through the kernels against the plain
   versions), the batched NERF on the card against the float64 oracle,
   then ``DesignEngine`` with both models, int8_matmul and f32 weight
   storage, on 32 pocket records (ligand bucket 16, receptor 64,
   structure DDIM-25, sequence D3PM over 50 steps with the uniform
   transition) and on 5 records padded to batch bucket 8, and the
   pipeline CLI -- checking every sequence, every PDB (4 atoms a residue,
   finite, ideal bond lengths), the exact launches of both kernels in
   each captured call (13 + 29 per encode and 25 + 41 per DDIM step;
   15 + 32 per sequence forward) and that a warm engine's design batch
   launches nothing from Python (replays only), and printing seconds per
   design batch;
9. training at full width: the dropout bits the kernels draw from a seed
   (Philox4x32-10, written out by ``e3d_dropout_keep``) against
   ``dropout_keep_plain`` bit for bit, and the bits the training forward
   and the backward apply, read back exactly; the training forward of the
   attention kernel (dropout 0.1 from a seed, and 0, with the row
   log-sum-exp), its backward and the LayerNorm backward against their
   plain versions (and in f32 against torch.autograd) at the training
   shapes (B=64, 128 x 128), the sampler's, Lq != Lk, lengths off the
   16-row tiles, ragged and dead rows, f32 and bf16 (and two backward
   calls on the same inputs giving the same bits), then their times
   beside the plain versions, the backward of SDPA / of F.layer_norm(x + r)
   and their bounds (the forward also with its seed draw, beside the mask
   draw it replaced; the LayerNorm backward's two kernels apart); for the
   146M structure and the 61M sequence trainer at
   their presets (B=64, length 128, bf16 compute, f32 master weights,
   AdamW): one step's loss and gradients through the kernels against the
   plain versions at dropout 0 (f32 and bf16), 20 train steps at dropout
   0.1 with finite, falling losses and the exact launches of each step
   (38 + 70 forward and 38 + 70 backward; 15 + 32 and 15 + 32), an eval
   step (forward kernels only), the median step time, samples/s and peak
   memory; two 3-step structure runs from one seed ending in the same
   weights; both train CLIs for one epoch (each captures its train step
   and its eval step: the launches of the captures with their warm-ups),
   and DesignEngine serving a design batch from the two final.pt
   files they wrote;
10. serving at full width, int8_matmul: the captured samplers against
   the eager loop on the same draws (structure DDIM-25, DDPM-1000 and a
   CFG DDIM-25 batch with per-slot scales; sequence D3PM-50, plain and
   CFG), within GRAPH_TOL, with their seconds; the sequence program's
   one-step seam, ``load`` then its step replays and the final replay,
   against its ``run`` bit for bit; the launches each captured
   call makes at capture and, by kernel name in a torch.profiler trace,
   at one replay; a design batch of 32 through DesignEngine with captured
   and with eager samplers (seconds, and with --profile the device idle
   share of each); DesignServer on 127.0.0.1:0 -- /healthz 503, then 200
   after warmup, 40 concurrent /design requests over two ligand buckets
   all answered 200 with valid sequences and PDBs, /inverse_fold,
   /stats showing coalesced batches, p50/p95 latency, and a small-queue
   server answering 429 with Retry-After; then 20 design batches through
   more buckets than the engine's GraphCache holds, with flat
   max_memory_allocated;
11. structure files to evaluated designs: 64 complexes written as PDB,
   mmCIF and gzipped PDB files (the port's NERF) with a BioLiP metadata
   TSV (duplicate pdb_ids, a resolution >= 5); the native DSSP library
   built by g++ from e3diff_tpu_torch/native/dssp_core.cpp (seconds
   printed), the preprocess CLI in its own process with 4 workers loading
   it (records, seconds, complexes/s), the C++ H-bond scan and ASA against
   the numpy engine on 8 structures; phase 4's and phase 8's full-width
   models saved as .pt files with config.json sidecars, then the CLIs
   sample_structure (DDIM-25, bf16 storage), create_pdb (every PDB read
   back by the port's reader), sample_by_generated_angles (bf16) and
   evaluate (--geometry), each captured call with its exact launches and
   every floating leaf stored bf16; a bf16 DesignEngine's design batch
   beside phase 8's int8_matmul one; prune_ckpt on phase 9's run
   directory (DesignEngine still loads its final.pt; a directory with no
   inference artifact is refused); convert_data from a .pt corpus;
12. the train step captured as one CUDA graph (Trainer.capture), for
   both trainers at their presets (B=64, length 128, bf16 compute,
   dropout 0.1): 20 replays against 20 eager steps of a trainer built
   from the same seed, every draw from the trainer's generator -- losses,
   grad norms, weights, moments and count equal bit for bit (on a
   difference, the same comparison at dropout 0 with the draws injected
   says whether the draws make it); the launches at capture (one step's,
   the optimizer's one fused update among them, as every train step of
   phases 9, 12 and 13 is held to) and, by kernel name in a
   utils/timing.py::profiler_trace, per replay;
   ms per step (median of 18 after 2), samples/s, max_memory_allocated,
   the device idle share and the utils/profiling.py digest of 3 profiled
   steps, eager and captured; 2 captured steps with accum_steps 2,
   cond_dropout 0.1 and an EMA against 2 eager ones, bit for bit; then the
   structure train CLI, captured, for 2 epochs with --profile_dir (the
   digest printed, the trace written, the peak memory with the snapshot
   saves), 1 epoch and a resume for 1 more ending in the same final.pt,
   and 2 epochs under E3DIFF_SNAPSHOT_SAVES=0 writing the same files;
   (g) remat: the structure trainer at its preset from one seed, 3 eager
   steps and 3 replays of its captured step at remat none, layer and
   dots, every run's losses, grad norms, weights, moments and
   generator state equal to the eager none run's bit for bit, each remat
   step launching the recomputed layers' forward kernels (36 training
   attention forwards and 60 LayerNorms more a step) and no other; ms a
   step and max_memory_allocated of each; one sequence step at layer
   against none (12 and 18 more); (h) the eval step captured
   (Trainer.capture_eval) for both trainers over 2 x 64 + 17 validation
   complexes (the last batch zero-padded): a train step, two eval passes
   and a train step, captured against eager, every metric, epoch mean
   and the final state with the generator's bit for bit; eval ms a batch
   eager and captured, and the number of eval graphs (one shape: one);
   (i) clipping and AdamW in one pass (ops/kernels.py::adamw_update): 3
   updates through the kernel against the plain chain from equal states,
   p, mu, nu and count bit for bit after each, at both trainers'
   parameter lists (mu f32 and bf16, weight decay 0.1 and 0, the clip
   taken, left, taken), on an edge list with gradients viewed out of one
   flat buffer and on 1100 small tensors (two launches); the kernel's
   device ms a call at both lists beside its bound (28 bytes an element
   over 3.35 TB/s), the plain chain's and torch.optim.AdamW(fused=True)'s
   (its rows in the kernels' record); a captured structure train step's
   graphs.capture span reads adamw_launches 1 or more, the capture's
   launches of the kernel;
13. multi-device on one card, the ranks spawned onto cuda:0 with seeded
   full-width weights: (a) dp=2 over gloo, 3 eager structure train steps
   at the preset (B=64, 32 a rank, length 128, bf16, dropout 0.1) against
   the one-process bf16 and f32 runs from the same seed (losses, grad
   norms, first moments, weights), the ranks' weights bit for bit equal,
   the hidden dropout draws' cost at the global shape, and (f)
   DesignEngine(mesh=) over phase 9's final.pt files, rank 0 leading a
   design batch of 32 and rank 1 following; (b) tp=2 over gloo, the same
   steps (6 heads a rank), the replicated tensors bit for bit equal, the
   keep bits a rank's attention kernels and e3d_dropout_keep draw at its
   block against dropout_keep_plain's, exactly, and (c) tp=2 DDIM-25 and
   D3PM-50 batches in f32, eager, against the one-process samples on the
   same noise; (d) an NCCL world of one: the captured train step, its
   all-reduces in the graph, against the mesh-free captured step over 3
   replays, bit for bit; (e) the structure train CLI under
   ``torch.distributed.run --nproc_per_node 2 ... --multihost --dp 2
   --dist_backend gloo``, its final.pt with the one-process key set
   serving DesignEngine.from_checkpoints. Each world's setup and step
   times, gloo all-reduce ms a step and peak memory per rank are printed.

The last three lines are the kernels' JSON record, the card, and
``{"ok": true, "device": {...}}``. The kernels' ``launches`` in the
record sum the main paths' runs: phase 6's DDPM-1000 int8 run (its
capture included), phase 10's server (its warmup's captures and 40
requests), phase 9's eager train steps and phase 12's captured ones
(each capture with its warm-up steps; replays launch nothing from
Python), phase 12 (g)'s remat runs and (h)'s eval runs, and phase 13's
ranks' train steps, tp samplers and engine; phases 6.2, 11 and 12 (i)
check their own launches and add none.

Usage, from the root of a checkout:
    python3 chip_smoke.py              # what the checks above need
    python3 chip_smoke.py --profile DIR  # also torch.profiler breakdowns
                                         # of a DDIM run, design batches
                                         # (captured and eager) and 3
                                         # structure train steps (device
                                         # busy ms a step, the dropout draws'
                                         # ms), traces written to DIR, with
                                         # phase 12's
Without a CUDA card, or away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent

# the main path: bench.py's structure-sampler shape
B, L_REC, L_LIG = 32, 64, 16
MAX_POS = 64                 # max_seq_len of the sampling config
T, DDIM_STEPS, CFG_SCALE = 1000, 25, 1.5
HEADS, HEAD_DIM = 12, 64
HIDDEN = HEADS * HEAD_DIM

# kernel calls of one forward (models/structure.py, models/blocks.py)
PER_ENCODE = {"fused_attention": 13, "fused_layernorm": 29}
PER_STEP = {"fused_attention": 25, "fused_layernorm": 41}
# one SequenceDenoiser forward (models/sequence.py): 4 embeddings (1 LN
# each), 3 SELayer calls (1 attention + 3 LN each), 6 layers (2 + 3 each),
# the head (1 LN)
PER_SEQ_FORWARD = {"fused_attention": 15, "fused_layernorm": 32}
SEQ_T = 50                   # D3PM steps: 49 loop forwards + the final one
# the calls each sampler captures, one graph each: the structure sampler's
# pocket encoding and reverse step; the sequence sampler's reverse step and
# final forward (and, guided, its conditioning: concatenations, no kernel
# of the port)
STRUCT_CALLS = {"encode": PER_ENCODE, "step": PER_STEP}
SEQ_CALLS = {"step": PER_SEQ_FORWARD, "final": PER_SEQ_FORWARD}
SEQUENCE_PARAMS = 60_990_100  # jax.eval_shape of the JAX model (CPU tests)
DESIGN_BATCH, SMALL_BATCH = 32, 5   # the second pads to batch bucket 8

# H100 SXM (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Kernel against plain version. f32: the repo's Pallas tolerance
# (tests/test_pallas_kernels.py). bf16: the two round P and the output to
# bf16 after sums taken in different orders, so one may land a bf16 step
# (2^-8 relative) from the other in P and then in the output.
ATTN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
LN_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}
# Whole decode, kernels against plain versions: f32 differs only by
# summation order (~1e-6 per op); in bf16 those rounding flips pass
# through 12 layers, so the outputs are held to 3% in relative L2 norm.
DECODE_F32_ATOL = 1e-3
DECODE_BF16_REL_L2 = 3e-2
# Rows whose every key is masked (dead batch slots): all scores sit near
# -10^4, where an f32 step is 2^-10, so P carries a relative error of
# about 1e-3 against float64 and a rounding flip between the kernel's fused
# multiply-add and the plain version's two roundings moves the output by
# up to ~1e-3 max|v|: such cases are held to 1e-2 in f32.
ATTN_DEAD_F32_TOL = (1e-2, 1e-4)
# NERF in f32 against the float64 oracle over 16 residues (the JAX
# package's bound, tests/test_geometry.py); bond lengths of the device
# coordinates, and of the PDB's, which rounds each coordinate to 1e-3
# (a distance then moves by at most sqrt(3) 1e-3 more)
NERF_ATOL = 2e-4
BOND_ATOL = 1e-3
PDB_BOND_ATOL = BOND_ATOL + math.sqrt(3) * 1e-3


class AttnCase(NamedTuple):
    label: str
    b: int
    lq: int
    lk: int
    max_pos: int
    table: bool
    ragged: bool
    dead: bool = False   # the last 3 batch rows have every key masked


# the main path's three shapes first (phase 7 times them), then the edges
# of the kernel's contract: Lq != Lk, lengths off the 16-row tiles, the
# 128 limit, CFG's 2B, ragged masks (each with single-key rows)
ATTN_CASES = [
    AttnCase("decoder self 32x16x16 +table", B, L_LIG, L_LIG, MAX_POS, True,
             False),
    AttnCase("cross 32x16x64", B, L_LIG, L_REC, MAX_POS, False, False),
    AttnCase("encoder self 32x64x64 +table", B, L_REC, L_REC, MAX_POS, True,
             False),
    AttnCase("ragged 32x16x50 +table, masked tail", B, L_LIG, 50, MAX_POS,
             True, True),
    AttnCase("edge 32x1x1 +table", B, 1, 1, MAX_POS, True, False),
    AttnCase("edge 32x1x1", B, 1, 1, MAX_POS, False, False),
    AttnCase("edge 32x5x13 +table, ragged", B, 5, 13, MAX_POS, True, True),
    AttnCase("edge 32x17x64 +table", B, 17, L_REC, MAX_POS, True, False),
    AttnCase("edge 32x17x64, ragged", B, 17, L_REC, MAX_POS, False, True),
    AttnCase("limit 32x128x128 +table max_pos 128, ragged", B, 128, 128, 128,
             True, True),
    AttnCase("limit 32x128x128", B, 128, 128, 128, False, False),
    AttnCase("cfg 64x16x16 +table, ragged", 2 * B, L_LIG, L_LIG, MAX_POS,
             True, True),
    AttnCase("cfg 64x16x64, ragged", 2 * B, L_LIG, L_REC, MAX_POS, False,
             True),
    # the sequence model under CFG: its receptor fuse (64 keys, a table)
    AttnCase("cfg 64x64x64 +table, ragged", 2 * B, L_REC, L_REC, MAX_POS,
             True, True),
    # a batch bucket of 8 holding 5 requests: 3 dead slots, all keys masked
    AttnCase("dead slots 8x16x16 +table", 8, L_LIG, L_LIG, MAX_POS, True,
             True, True),
    AttnCase("dead slots 8x64x64 +table", 8, L_REC, L_REC, MAX_POS, True,
             True, True),
    AttnCase("dead slots 8x16x64", 8, L_LIG, L_REC, MAX_POS, False, True,
             True),
]
# (rows, width): the main path's two, fewer rows than a block holds, and a
# width that takes the second (scalar) kernel
LN_CASES = [(B * L_LIG, HIDDEN), (B * L_REC, HIDDEN), (1, HIDDEN),
            (3, HIDDEN), (37, 96)]
# the main-path shapes phase 7 times
TIMED_ATTN = ATTN_CASES[:3]
TIMED_LN = [B * L_LIG, B * L_REC]


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def phase(title: str):
    print(f"\n== {title}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _cycles_per_ms(torch) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_call(torch, fn, iters: int, reps: int = 7) -> tuple[float, float]:
    """(device ms, host ms) of one call of ``fn``, medians over ``reps``.

    Device: CUDA events around ``iters`` back-to-back calls, queued behind
    a sleep kernel long enough for the host to enqueue them all, so the
    host's launch cost is hidden. A repetition in which the device reached
    the start event before the host had enqueued every call may hold idle
    gaps (a host stalled on its shared cores): it is taken again behind a
    sleep twice as long. Host: wall time of enqueueing one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    cycles = int((2.0 * host_ms * iters + 1.0) * _CYCLES_PER_MS)
    dev, host = [], []
    while len(dev) < reps:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_rep = (time.perf_counter() - t0) * 1e3 / iters
        drained = start.query()  # the queue may have run dry
        end.record()
        end.synchronize()
        if drained and cycles < 64 * _CYCLES_PER_MS * (host_ms * iters + 1):
            cycles *= 2
            continue
        host.append(host_rep)
        dev.append(start.elapsed_time(end) / iters)
    return statistics.median(dev), statistics.median(host)


_CYCLES_PER_MS = 0.0


# ---------------------------------------------------------------------------
# phase helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def clock_line() -> str:
    """SM clock, its maximum, power draw and temperature, as nvidia-smi
    reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip()


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def compare(label, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    worst = err.max().item()
    ok = bool(((err <= atol + rtol * want.float().abs()).all()
               & got.float().isfinite().all()).item())
    print(f"  {label}: max_abs_err {worst:.3e} "
          f"(atol {atol:g} + rtol {rtol:g}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    check(ok, f"{label}: kernel disagrees with its plain version")
    return worst


def attention_inputs(torch, gen, case, dtype, heads=HEADS):
    """Seeded q, k, v (``heads`` heads wide), mask and table for one
    ``AttnCase``. A ragged mask keeps a random prefix of 1..Lk keys, and a
    single key in every fourth batch row; a dead row masks every key."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    b, lq, lk, width = case.b, case.lq, case.lk, heads * HEAD_DIM
    q, k, v = randn(b, lq, width), randn(b, lk, width), randn(b, lk, width)
    mask = torch.zeros(b, lk, device="cuda")
    if case.ragged:
        lengths = torch.randint(1, lk + 1, (b,), generator=gen, device="cuda")
        lengths[::4] = 1
        keep = torch.arange(lk, device="cuda")[None, :] < lengths[:, None]
        mask = mask.masked_fill(~keep, -10000.0)
    if case.dead:
        mask[-3:] = -10000.0
    table = randn(2 * case.max_pos - 1, HEAD_DIM) if case.table else None
    return q, k, v, mask, table


def attention_f64(torch, q, k, v, mask, table, max_pos):
    """The attention core in float64 with torch.softmax, independent of
    both the kernel and its plain version."""
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    q4, k4, v4 = (t.double().view(b, -1, HEADS, HEAD_DIM) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4)
    if table is not None:
        idx = (torch.arange(lq, device="cuda")[:, None]
               - torch.arange(lk, device="cuda")[None, :] + max_pos - 1)
        s = s + torch.einsum("bqhd,qkd->bhqk", q4, table.double()[idx])
    p = torch.softmax(s / math.sqrt(HEAD_DIM)
                      + mask.double()[:, None, None, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v4).reshape(b, lq, HIDDEN)


def ln_inputs(torch, gen, rows, width, dtype, residual, affine):
    x = torch.randn(rows, width, generator=gen, device="cuda").to(dtype)
    res = (torch.randn(rows, width, generator=gen, device="cuda").to(dtype)
           if residual else None)
    w = b = None
    if affine:
        w = 1 + 0.1 * torch.randn(width, generator=gen, device="cuda")
        b = 0.1 * torch.randn(width, generator=gen, device="cuda")
    return x, w, b, res, (1e-12 if affine else 1e-5)


def attention_cost(b, lq, lk, with_table, elem) -> tuple[int, int]:
    """Bytes (each input read once, the output written once) and
    operations (QK^T, P V and the relative bias, 2 per multiply-add)."""
    table_rows = (lq + lk - 1) if with_table else 0
    nbytes = (elem * (2 * b * lq * HIDDEN + 2 * b * lk * HIDDEN
                      + table_rows * HEAD_DIM) + 4 * b * lk)
    ops = 2 * b * HEADS * lq * lk * HEAD_DIM * (3 if with_table else 2)
    return nbytes, ops


def ln_cost(rows, residual, affine, elem) -> tuple[int, int]:
    nbytes = elem * rows * HIDDEN * (3 if residual else 2) \
        + (8 * HIDDEN if affine else 0)
    return nbytes, 8 * rows * HIDDEN


def sass_summary(nvcc: str, lib_path: Path) -> dict[str, Counter] | None:
    """Per kernel function of the library, counts of its tensor-core,
    ldmatrix and global load/store instructions in ``cuobjdump -sass``;
    None where the toolkit has no cuobjdump."""
    exe = Path(nvcc).parent / "cuobjdump"
    exe = str(exe) if exe.is_file() else shutil.which("cuobjdump")
    if exe is None:
        return None
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    per, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per[fn] = Counter()
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?((?:HMMA|LDSM|LDGSTS|LDG|STG)"
                      r"[A-Z0-9_.]*)", line)
        if fn is not None and m:
            per[fn][m.group(1)] += 1
    return {kernel_name(fn): ops for fn, ops in per.items()}


def kernel_name(mangled: str) -> str:
    """The mangled name from the kernel's own identifier on, without its
    namespace: ``attention_mma_kernelILi4ELb1EEEvNS_4ArgsEf`` for
    ``attention_mma_kernel<4, true>(Args, float)``. The qualified name
    after ``_ZN`` (or ``_Z``) is a run of identifiers, each after its
    length in digits."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.compile(r"\d+").match(mangled, pos):
        pos = m.end() + int(m.group())
        if mangled[m.end():pos].endswith("_kernel"):
            return mangled[m.end():]
    return mangled


def print_sass(per: dict[str, Counter]) -> None:
    for fn, ops in sorted(per.items()):
        wide_ld = sum(n for op, n in ops.items()
                      if op.startswith(("LDG", "LDGSTS")) and ".128" in op)
        narrow_ld = sum(n for op, n in ops.items()
                        if op.startswith("LDG") and not op.startswith("LDGSTS")
                        and ".128" not in op)
        wide_st = sum(n for op, n in ops.items()
                      if op.startswith("STG") and ".128" in op)
        hmma = sum(n for op, n in ops.items() if op.startswith("HMMA"))
        ldsm = sum(n for op, n in ops.items() if op.startswith("LDSM"))
        print(f"  {fn}: HMMA {hmma}, LDSM {ldsm}, 16-byte global loads "
              f"{wide_ld}, narrower global loads {narrow_ld}, 16-byte "
              f"stores {wide_st}")


# the kernels phase 2 summarises: the training forward at 128 keys (bf16,
# without and with the table), its backward, the LayerNorm backward
RESIDENCY_KERNELS = (
    ("attention_mma_kernel<8, false, true>",
     "attention_mma_kernelILi8ELb0ELb1E"),
    ("attention_mma_kernel<8, true, true>",
     "attention_mma_kernelILi8ELb1ELb1E"),
    ("attention_bwd_mma_kernel<8, false>", "attention_bwd_mma_kernelILi8ELb0E"),
    ("attention_bwd_mma_kernel<8, true>", "attention_bwd_mma_kernelILi8ELb1E"),
    ("layernorm_bwd_vec_kernel<bf16, 768>",
     "layernorm_bwd_vec_kernelI13__nv_bfloat16Li768E"),
    ("column_sum_kernel", "column_sum_kernel"),
)


def ptxas_resources(log: str) -> dict[str, str]:
    """Mangled kernel name -> ptxas's "Used N registers, ..." line."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "Used" in line and "registers" in line:
            res[fn] = line.split(":", 1)[-1].strip()
    return res


def print_residency(torch, lib, log: str) -> None:
    """ptxas registers of the training kernels and their resident blocks
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at the training
    shape: 64x128x128 attention, 8192x768 LayerNorm backward."""
    res = ptxas_resources(log)
    for label, key in RESIDENCY_KERNELS:
        used = [v for k, v in res.items() if key in k]
        print(f"  ptxas {label}: {used[0] if used else 'not in the log'}")
    for table in (0, 1):
        n = ctypes.c_int(0)
        code = lib.e3d_attention_train_occupancy(128, 128, table,
                                                 ctypes.byref(n))
        check(code == 0, f"occupancy query failed with cudaError {code}")
        print(f"  training forward 128x128{' +table' if table else ''} bf16: "
              f"{n.value} resident blocks per SM")
    n = ctypes.c_int(0)
    code = lib.e3d_layernorm_backward_occupancy(HIDDEN, 1, ctypes.byref(n))
    check(code == 0, f"occupancy query failed with cudaError {code}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  layernorm backward {HIDDEN} bf16: {n.value} resident blocks per "
          f"SM ({sms} SMs)")


def bound(nbytes, ops, dtype_name) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# parameter counts of the blocks from their configs alone (Linears,
# LayerNorms, distance tables), independent of the module code

def _lin(i, o):
    return i * o + o


def _block(cfg, relative):
    h = cfg.hidden_size
    table = (2 * cfg.max_position_embeddings - 1) * cfg.head_dim
    return 4 * _lin(h, h) + 2 * h + (table if relative else 0)


def _selayer(cfg):
    h, m = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    return (_lin(h, h) + _lin(h, 6 * h) + _block(cfg, True) + _lin(h, m)
            + _lin(m, h))


def _layer(cfg):
    h, i = cfg.hidden_size, cfg.intermediate_size
    cross = _block(cfg, False) if cfg.add_cross_attention else 0
    return _block(cfg, True) + cross + _lin(h, i) + _lin(i, h) + 2 * h


def _emb(cfg, n_in):
    return _lin(n_in, cfg.hidden_size) + 2 * cfg.hidden_size


def _head(cfg, n_out):
    h = cfg.hidden_size
    return _lin(h, h) + 2 * h + _lin(h, n_out)


def expected_param_count(enc, dec, n_features=8, n_aa=20) -> int:
    """The StructureDenoiser's parameter count (the Fourier W included);
    at max_seq_len 64 it is the 146,214,664 values that jax.eval_shape
    gives the JAX model."""
    return (_emb(enc, n_features) + _emb(enc, n_aa) + _selayer(enc)
            + enc.num_layers * _layer(enc)
            + _emb(dec, n_features) + dec.hidden_size // 2 + _selayer(dec)
            + dec.num_layers * _layer(dec) + _head(dec, n_features))


def expected_sequence_param_count(enc, dec, n_features=8, n_aa=20) -> int:
    """The SequenceDenoiser's: four embeddings, the one shared fuse
    SELayer (quirk Q7), the decoder, decoder_normalize, the head and the
    Fourier W; at max_seq_len 64 the 60,990,100 values of the JAX model."""
    return (2 * _emb(enc, n_aa) + 2 * _emb(enc, n_features) + _selayer(enc)
            + dec.num_layers * _layer(dec) + _selayer(dec) + _head(dec, n_aa)
            + dec.hidden_size // 2)


def make_batch(torch, gen):
    """bench.py's sampling batch, with ragged peptide (5..16) and pocket
    (16..64) lengths."""
    def lengths_mask(lo, hi, length):
        n = torch.randint(lo, hi + 1, (B,), generator=gen, device="cuda")
        return (torch.arange(length, device="cuda")[None, :]
                < n[:, None]).float()

    seq_idx = torch.randint(0, 20, (B, L_REC), generator=gen, device="cuda")
    return {
        "ligand_angles": torch.zeros(B, L_LIG, 8, device="cuda"),
        "ligand_attn_mask": lengths_mask(5, L_LIG, L_LIG),
        "receptor_seq": torch.nn.functional.one_hot(seq_idx, 20).float(),
        "receptor_angles": (torch.rand(B, L_REC, 8, generator=gen,
                                       device="cuda") * 2 - 1) * math.pi,
        "receptor_attn_mask": lengths_mask(16, L_REC, L_REC),
    }


@contextlib.contextmanager
def plain_versions(kernels):
    """The models' kernel calls go to the plain PyTorch versions: the
    inference kernels' and, for training, the differentiable paths', which
    autograd then differentiates (a dropout seed becomes its keep mask,
    ``dropout_keep_plain``)."""
    def autograd_plain(q, k, v, mask, table, seed, p, *, num_heads, max_pos,
                       dropout_block=None):
        keep = None if seed is None else kernels.dropout_keep_plain(
            seed, (q.shape[0], num_heads, q.shape[1], k.shape[1]), p,
            dropout_block)
        return kernels.attention_autograd_plain(
            q, k, v, mask, table, keep, p, num_heads=num_heads,
            max_pos=max_pos)

    names = ("fused_attention", "fused_layernorm", "attention_autograd",
             "layernorm_autograd")
    saved = [getattr(kernels, n) for n in names]
    for n, plain in zip(names, (
            kernels.attention_plain, kernels.layernorm_plain,
            autograd_plain, kernels.layernorm_plain)):
        setattr(kernels, n, plain)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(kernels, n, f)


def launch_counts(kernels) -> dict[str, int]:
    return {k.__name__: k.launches for k in kernels.KERNELS}


def with_zeros(kernels, want: dict[str, int]) -> dict[str, int]:
    """``want`` over every kernel: a kernel it does not name was launched
    0 times (the samplers launch no training kernel)."""
    return {k.__name__: want.get(k.__name__, 0) for k in kernels.KERNELS}


def captured(kernels, calls: dict, programs: int = 1) -> dict[str, int]:
    """The launches of capturing ``programs`` fresh programs of these
    calls: every call runs WARMUP_CALLS times eagerly, then once more
    under capture (sampling/graphs.py); replays launch nothing from
    Python."""
    from e3diff_tpu_torch.sampling.graphs import WARMUP_CALLS

    return with_zeros(kernels, {
        k: programs * (WARMUP_CALLS + 1) * sum(c.get(k, 0)
                                               for c in calls.values())
        for k in PER_STEP})


def sum_counts(*counts: dict[str, int]) -> dict[str, int]:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def in_angle_range(torch, x) -> bool:
    x = torch.as_tensor(x)
    return bool(x.isfinite().all() and x.min() >= -math.pi
                and x.max() < math.pi)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", metavar="DIR", default=None,
                      help="also profile a DDIM run, a design batch and "
                           "structure train steps with torch.profiler and "
                           "write their traces to DIR")
    args = args.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card here; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "e3diff_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(no e3diff_tpu_torch/csrc); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from e3diff_tpu_torch.cli.sample_structure import main as cli_main
    from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion
    from e3diff_tpu_torch.models import (
        StructureDenoiser,
        structure_model_configs,
    )
    from e3diff_tpu_torch.models.structure import state_dict_numel
    from e3diff_tpu_torch.ops import _build, kernels
    from e3diff_tpu_torch.ops.angles import wrap_angle
    from e3diff_tpu_torch.sampling import make_structure_sampler
    from e3diff_tpu_torch.utils.params_io import cast_inference_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global _CYCLES_PER_MS
    t_start = time.perf_counter()

    # 1 ---------------------------------------------------------------
    phase("1. card")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device count "
          f"{torch.cuda.device_count()}, CUDAGraph.register_generator_state "
          f"{hasattr(torch.cuda.CUDAGraph, 'register_generator_state')} "
          f"(the samplers draw their noise before a graph runs, and need "
          f"none), Generator.clone_state "
          f"{hasattr(torch.Generator, 'clone_state')} (remat restores the "
          f"trainer's generator with get_state / set_state, which a "
          f"capture records)")

    # 2 ---------------------------------------------------------------
    phase("2. build the kernels (nvcc, sm_90a)")
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path = _build.build(verbose=True)
    print(log.getvalue())
    kernels_lib = _build.load_library()
    check(kernels_lib is not None, "kernel library did not load")
    print(f"built {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    print_residency(torch, kernels_lib, log.getvalue())
    sass = sass_summary(_build._nvcc(), lib_path)
    if sass is None:
        print("cuobjdump not found: no SASS summary")
    else:
        print_sass(sass)
        for kernel in ("attention_mma_kernel", "attention_bwd_mma_kernel"):
            mma_fns = [fn for fn in sass if fn.startswith(kernel)]
            check(len(mma_fns) > 0 and all(
                any(op.startswith("HMMA") for op in sass[fn])
                for fn in mma_fns),
                f"the bf16 {kernel} has no HMMA instruction")
    _CYCLES_PER_MS = _cycles_per_ms(torch)

    # 3 ---------------------------------------------------------------
    phase("3. each kernel against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_err = {}  # (kernel, shape) -> bf16 max abs error, for phase 7
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for case in ATTN_CASES:
            q, k, v, mask, tab = attention_inputs(torch, gen, case, dtype)
            kw = dict(num_heads=HEADS, max_pos=case.max_pos)
            got = kernels.fused_attention(q, k, v, mask, tab, **kw)
            want = kernels.attention_plain(q, k, v, mask, tab, **kw)
            torch.cuda.synchronize()
            tol = (ATTN_DEAD_F32_TOL if case.dead and dname == "float32"
                   else ATTN_TOL[dname])
            err = compare(f"attention {case.label} {dname}", got, want, *tol)
            if dtype == torch.float32:
                compare(f"attention {case.label} {dname} vs float64", got,
                        attention_f64(torch, q, k, v, mask, tab,
                                      case.max_pos), *tol)
            else:
                bf16_err["fused_attention", case.label] = err
        for rows, width in LN_CASES:
            for residual in (False, True):
                for affine in (False, True):
                    x, w, b, res, eps = ln_inputs(torch, gen, rows, width,
                                                  dtype, residual, affine)
                    got = kernels.fused_layernorm(x, w, b, res, eps=eps)
                    want = kernels.layernorm_plain(x, w, b, res, eps=eps)
                    torch.cuda.synchronize()
                    label = (f"layernorm {rows}x{width}"
                             f"{' +residual' if residual else ''}"
                             f"{' +affine' if affine else ''} {dname}")
                    err = compare(label, got, want, *LN_TOL[dname])
                    if dtype == torch.bfloat16 and residual and affine:
                        bf16_err["fused_layernorm", (rows, width)] = err

    # 4 ---------------------------------------------------------------
    phase("4. the full-width StructureDenoiser (bf16 compute)")
    enc, dec = structure_model_configs(max_seq_len=MAX_POS,
                                       dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = StructureDenoiser(enc, dec, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = state_dict_numel(model)
    want_params = expected_param_count(enc, dec)
    print(f"built in {time.perf_counter() - t0:.2f} s: {n_params:,} values "
          f"(expected {want_params:,})")
    check(n_params == want_params, "parameter count differs")

    # 5 ---------------------------------------------------------------
    phase("5. one decode through the kernels against the plain versions")
    batch = make_batch(torch, gen)
    t_vec = torch.randint(0, T, (B,), generator=gen, device="cuda")
    x_t = wrap_angle(torch.randn(B, L_LIG, 8, generator=gen, device="cuda"))

    def one_decode(m):
        enc_out = m.encode_receptor(batch["receptor_seq"],
                                    batch["receptor_angles"],
                                    batch["receptor_attn_mask"])
        return m.decode(t_vec, x_t, batch["ligand_attn_mask"], enc_out,
                        batch["receptor_attn_mask"],
                        cross_kv=m.precompute_cross_kv(enc_out))

    enc32, dec32 = structure_model_configs(max_seq_len=MAX_POS)
    model32 = StructureDenoiser(enc32, dec32, device="cuda", seed=None)
    model32.load_state_dict(model.state_dict(), strict=True)
    for m, dname in ((model32, "f32"), (model, "bf16")):
        got = one_decode(m)
        with plain_versions(kernels):
            want = one_decode(m)
        torch.cuda.synchronize()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        err = max_err(got, want)
        print(f"  decode {dname}: max_abs_err {err:.3e}, relative L2 "
              f"{rel:.3e}, |eps| max {want.float().abs().max().item():.2f}")
        check(got.isfinite().all().item(), f"decode {dname}: not finite")
        if dname == "f32":
            check(err <= DECODE_F32_ATOL, f"decode f32 differs by {err}")
        else:
            check(rel <= DECODE_BF16_REL_L2, f"decode bf16 differs by {rel}")
    del model32

    # 6 ---------------------------------------------------------------
    phase("6. the main path: the structure sampler, B=32, receptor 64, "
          "ligand 16")
    diffusion = GaussianAngleDiffusion.cosine(T, device="cuda")
    model8 = StructureDenoiser(enc, dec, device="cuda", seed=None)
    model8.load_state_dict(model.state_dict(), strict=True)
    cast_inference_params(model8, "int8_matmul")
    runs = [("ddpm", T, 1.0), ("ddim", DDIM_STEPS, 1.0),
            ("ddim", DDIM_STEPS, CFG_SCALE)]
    seconds, main_counts = {}, None
    struct_capture = captured(kernels, STRUCT_CALLS)
    for storage, m in (("int8_matmul", model8), ("f32", model)):
        warm = make_structure_sampler(m, diffusion, sampler="ddim",
                                      ddim_steps=2, guidance_scale=CFG_SCALE,
                                      return_trajectory=False)
        warm(batch, generator=torch.Generator(device="cuda").manual_seed(9))
        for sampler, n_steps, scale in runs:
            name = (f"{sampler}-{n_steps}"
                    f"{f' cfg w={scale}' if scale != 1.0 else ''} {storage}")
            run = make_structure_sampler(
                m, diffusion, sampler=sampler, ddim_steps=n_steps,
                guidance_scale=scale, return_trajectory=False)
            g = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            final, _ = run(batch, generator=g)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = launch_counts(kernels)
            t0 = time.perf_counter()
            again, _ = run(batch, generator=g)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            seconds[name] = secs
            print(f"  {name}: {secs:.3f} s ({secs / n_steps * 1e3:.2f} ms "
                  f"per step) replayed; first call, capture included, "
                  f"{first:.3f} s, launches {counts}", flush=True)
            check(counts == struct_capture,
                  f"{name}: launches {counts} != {struct_capture}")
            for out in (final, again):
                check(tuple(out.shape) == (B, L_LIG, 8), f"{name}: shape")
                check(in_angle_range(torch, out),
                      f"{name}: output not finite or outside [-pi, pi)")
            if (sampler, storage) == ("ddpm", "int8_matmul"):
                main_counts = counts
    # the samplers' programs hold device memory; later phases measure it
    del warm, run
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "output.pkl"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results = cli_main(["--synthetic", "--sampler", "ddim",
                            "--ddim_steps", str(DDIM_STEPS),
                            "--params_dtype", "int8_matmul",
                            "--batch_size", str(B),
                            "--max_seq_len", str(MAX_POS),
                            "--ligand_max_len", str(L_LIG),
                            "--no_trajectory", "--output", str(out)])
        secs = time.perf_counter() - t0
        counts = launch_counts(kernels)
        print(f"  cli ddim-{DDIM_STEPS} int8_matmul: {secs:.3f} s including "
              f"model build and capture, {len(results)} samples, launches "
              f"{counts}")
        check(counts == struct_capture,
              f"cli: launches {counts} != {struct_capture}")
        check(out.is_file() and len(results) > 0, "cli wrote no samples")
        check(all(r.ndim == 2 and r.shape[1] == 8
                  and in_angle_range(torch, r) for r in results),
              "cli samples malformed")
    t0 = time.perf_counter()
    traj_numbers = trajectory_phase(torch, kernels, cli_main, model8,
                                    diffusion, batch, struct_capture)
    traj_numbers["phase"] = time.perf_counter() - t0
    print(f"  {card}")
    print(f"  phase 6.2 took {traj_numbers['phase']:.1f} s")
    del model8
    torch.cuda.empty_cache()

    # 7 ---------------------------------------------------------------
    phase("7. kernel timings (device ms per call, L2-warm, bf16)")
    print(f"  clocks before: {clock_line()}")
    record = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case in TIMED_ATTN:
        q, k, v, mask, tab = attention_inputs(torch, gen, case,
                                              torch.bfloat16)
        kw = dict(num_heads=HEADS, max_pos=case.max_pos)
        q4, k4, v4 = (t.view(case.b, -1, HEADS, HEAD_DIM).transpose(1, 2)
                      for t in (q, k, v))
        # SDPA's bias is built here, outside the timed call: its time is a
        # lower bound for the library on the shapes with a table
        bias = mask[:, None, None, :]
        if case.table:
            idx = (torch.arange(case.lq, device="cuda")[:, None]
                   - torch.arange(case.lk, device="cuda")[None, :]
                   + case.max_pos - 1)
            bias = bias + torch.einsum("bhqd,qkd->bhqk", q4.float(),
                                       tab.float()[idx]) / math.sqrt(HEAD_DIM)
        bias = bias.to(torch.bfloat16)
        ms, host = time_call(
            torch, lambda: kernels.fused_attention(q, k, v, mask, tab, **kw),
            iters=200)
        plain_ms, _ = time_call(
            torch, lambda: kernels.attention_plain(q, k, v, mask, tab, **kw),
            iters=30)
        lib_ms, _ = time_call(
            torch, lambda: sdpa(q4, k4, v4, attn_mask=bias), iters=100)
        nbytes, ops = attention_cost(case.b, case.lq, case.lk, case.table, 2)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        print(f"  attention {case.label}: kernel {ms * 1e3:.2f} us (host "
              f"{host * 1e3:.1f} us per call), plain {plain_ms * 1e3:.2f} "
              f"us, sdpa {lib_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
              f"by {b_by} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop)",
              flush=True)
        record.append(dict(
            name="fused_attention", route="cuda",
            source="e3diff_tpu_torch/csrc/attention.cu",
            replaces="e3diff_tpu/ops/pallas_kernels.py:110",
            launches=main_counts["fused_attention"],
            max_abs_err=bf16_err["fused_attention", case.label], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=f"{case.label} bf16"))
    for rows in TIMED_LN:
        x, w, b, res, eps = ln_inputs(torch, gen, rows, HIDDEN,
                                      torch.bfloat16, True, True)
        ln = torch.nn.functional.layer_norm
        w16, b16 = w.to(x.dtype), b.to(x.dtype)
        ms, host = time_call(
            torch, lambda: kernels.fused_layernorm(x, w, b, res, eps=eps),
            iters=200)
        plain_ms, _ = time_call(
            torch, lambda: kernels.layernorm_plain(x, w, b, res, eps=eps),
            iters=30)
        lib_ms, _ = time_call(
            torch, lambda: ln(x + res, (HIDDEN,), w16, b16, eps), iters=100)
        nbytes, ops = ln_cost(rows, True, True, 2)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        label = f"{rows}x{HIDDEN} +residual +affine"
        print(f"  layernorm {label}: kernel {ms * 1e3:.2f} us (host "
              f"{host * 1e3:.1f} us per call), plain {plain_ms * 1e3:.2f} "
              f"us, F.layer_norm(x + r) {lib_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.2f} us by {b_by} ({nbytes / 1e6:.2f} MB)",
              flush=True)
        record.append(dict(
            name="fused_layernorm", route="cuda",
            source="e3diff_tpu_torch/csrc/layernorm.cu",
            replaces="e3diff_tpu/ops/pallas_kernels.py:168",
            launches=main_counts["fused_layernorm"],
            max_abs_err=bf16_err["fused_layernorm", (rows, HIDDEN)], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=f"{label} bf16"))

    print(f"  clocks after: {clock_line()}")

    # 8 ---------------------------------------------------------------
    phase("8. the design request at full width: SequenceDenoiser, device "
          "NERF, DesignEngine")
    t0 = time.perf_counter()
    design_seconds = design_phase(torch, kernels, model, enc, dec,
                                  diffusion, batch, gen, card)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9 ---------------------------------------------------------------
    phase("9. training at full width: the training kernels, both trainers, "
          "both train CLIs")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    train_errs = training_kernel_checks(torch, kernels, gen)
    print(f"  clocks before: {clock_line()}")
    record += time_training_kernels(torch, kernels, gen, train_errs)
    print(f"  clocks after: {clock_line()}")
    train_counts = {k.__name__: 0 for k in kernels.KERNELS}
    train_timing = {}
    for model_name in ("structure", "sequence"):
        totals, train_timing[model_name] = trainer_phase(torch, kernels,
                                                         model_name, gen)
        for k, n in totals.items():
            train_counts[k] += n
    # the train CLIs' run directories, which phase 11 prunes
    runs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    train_cli_phase(torch, kernels, Path(runs.name))
    print(f"  {card}")
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10 --------------------------------------------------------------
    phase("10. serving: captured samplers against eager, DesignServer, "
          "memory across cache evictions")
    t0 = time.perf_counter()
    serve_counts, serve_seconds = serving_phase(
        torch, kernels, model, enc, dec, diffusion, batch, card,
        None if args.profile is None else Path(args.profile))
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    if args.profile:
        for eager in (False, True):
            phase(f"profile: DDIM-25 int8_matmul, "
                  f"{'eager' if eager else 'captured'}, torch.profiler")
            profile_sampler(torch, model, diffusion, batch,
                            make_structure_sampler, cast_inference_params,
                            StructureDenoiser, enc, dec, Path(args.profile),
                            eager)
        phase("profile: structure train steps, B=64, torch.profiler")
        profile_train_steps(torch, kernels, Path(args.profile))

    # 11 --------------------------------------------------------------
    phase("11. structure files to evaluated designs: preprocess (native "
          "DSSP), sample in bf16, PDBs, inverse folding, evaluation, "
          "prune_ckpt, convert_data")
    t0 = time.perf_counter()
    flow_seconds = files_to_designs_phase(torch, kernels, model,
                                          Path(runs.name), card,
                                          design_seconds)
    flow_seconds["phase"] = time.perf_counter() - t0
    print(f"  phase 11 took {flow_seconds['phase']:.1f} s")

    # 12 --------------------------------------------------------------
    phase("12. the train step captured as one CUDA graph: replays against "
          "eager steps, launches, times, digests; the train CLI captured, "
          "profiled, resumed, with snapshot and synchronous saves")
    t0 = time.perf_counter()
    del model   # what stays resident under phase 12's trainers is printed
    torch.cuda.empty_cache()
    print(f"  memory_allocated before: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    capture_timing = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as tmp:
        out = Path(args.profile or tmp)
        for model_name in ("structure", "sequence"):
            counts, capture_timing[model_name] = captured_train_phase(
                torch, kernels, model_name, gen, out)
            for k, n in counts.items():
                train_counts[k] += n
        capture_timing["cli_peak_gib"] = train_cli_capture_phase(
            torch, kernels, Path(tmp)) / 2**30
    print(f"  {card}")
    print(f"  phase 12 (a-f) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    phase("12 (g). remat: layer and dots against none, eager and "
          "captured, bit for bit, with their launches, times and memory")
    counts, remat_numbers = remat_phase(torch, kernels, gen, card)
    for k, n in counts.items():
        train_counts[k] += n
    remat_numbers["phase"] = time.perf_counter() - t1
    print(f"  phase 12 (g) took {remat_numbers['phase']:.1f} s")
    t1 = time.perf_counter()
    phase("12 (h). the eval step captured: against eager eval_step over a "
          "zero-padded validation set, with train steps around it")
    counts, eval_numbers = eval_capture_phase(torch, kernels, gen, card)
    for k, n in counts.items():
        train_counts[k] += n
    eval_numbers["phase"] = time.perf_counter() - t1
    print(f"  phase 12 (h) took {eval_numbers['phase']:.1f} s")
    t1 = time.perf_counter()
    phase("12 (i). clipping and AdamW in one pass: the kernel against the "
          "plain chain bit for bit at both train lists, its times, a "
          "captured step's adamw_launches")
    adamw_numbers, adamw_rows = adamw_phase(torch, kernels, gen)
    record += adamw_rows
    adamw_numbers["phase"] = time.perf_counter() - t1
    print(f"  phase 12 (i) took {adamw_numbers['phase']:.1f} s")
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    # 13 --------------------------------------------------------------
    phase("13. multi-device on one card: dp=2 and tp=2 ranks over gloo, "
          "an NCCL world of one captured, the train CLI under "
          "torch.distributed.run, DesignEngine(mesh=)")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    par_counts, par_numbers = multidevice_phase(torch, kernels, card,
                                                Path(runs.name))
    runs.cleanup()
    par_numbers["phase"] = time.perf_counter() - t0
    print(f"  phase 13 took {par_numbers['phase']:.1f} s")

    # the launches of the main paths' runs: the DDPM-1000 structure run
    # (its capture), the server (its warmup's captures and 40 requests),
    # the two trainers' eager train steps and their captured steps (each
    # capture with its warm-up, and the replays), the remat and eval runs
    # of phase 12 (g) and (h), and phase 13's ranks'
    # (their train steps, tp samplers and the mesh engine)
    for entry in record:
        entry["launches"] = (main_counts[entry["name"]]
                             + serve_counts[entry["name"]]
                             + train_counts[entry["name"]]
                             + par_counts[entry["name"]])

    print(f"\nsampler seconds, replayed: {json.dumps(seconds)}")
    print(f"design seconds per batch: {json.dumps(design_seconds)}")
    print(f"serving: {json.dumps(serve_seconds)}")
    print(f"train steps: {json.dumps(train_timing)}")
    print(f"files to designs, seconds: {json.dumps(flow_seconds)}")
    print(f"captured train steps: {json.dumps(capture_timing)}")
    print(f"trajectory and host copies: {json.dumps(traj_numbers)}")
    print(f"remat: {json.dumps(remat_numbers)}")
    print(f"eval steps: {json.dumps(eval_numbers)}")
    print(f"fused AdamW: {json.dumps(adamw_numbers)}")
    print(f"multi-device: {json.dumps(par_numbers)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class StageMeter:
    """Wraps a DesignEngine's two samplers to read, for each call, the
    seconds to the end of its device work (synchronised at the stage's
    end, where the engine reads its result anyway)."""

    def __init__(self, torch, engine):
        self.torch, self.calls = torch, []
        for stage, attr in (("structure", "_struct_run"),
                            ("sequence", "_seq_run")):
            setattr(engine, attr, self._wrap(stage, getattr(engine, attr)))

    def _wrap(self, stage, run):
        def timed_run(*args, **kwargs):
            t0 = time.perf_counter()
            out = run(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.calls.append((stage, time.perf_counter() - t0))
            return out
        return timed_run


def pocket_requests(n: int, seed: int) -> list[tuple[str, np.ndarray, int]]:
    """Pocket requests: 16..64 random residues with angles like real
    backbones' (dihedrals uniform, bond angles near their means), and a
    peptide length of 5..16."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_pocket = int(rng.integers(16, L_REC + 1))
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n_pocket))
        angles = np.concatenate(
            [rng.uniform(-np.pi, np.pi, (n_pocket, 4)),
             rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (n_pocket, 4))],
            axis=1).astype(np.float32)
        out.append((seq, angles, int(rng.integers(5, L_LIG + 1))))
    return out


def bond_errors(coords: np.ndarray) -> np.ndarray:
    """|length - ideal| of every bond NERF placed in (4n, 3) N/CA/C/O
    coordinates: N-CA and CA-C from residue 1 on (residue 0's N, CA and C
    are 1CRN's), C=O and the C -> N peptide bonds everywhere."""
    res = coords.reshape(-1, 4, 3).astype(np.float64)

    def dist(a, b):
        return np.linalg.norm(a - b, axis=-1)

    return np.abs(np.concatenate([
        dist(res[1:, 0], res[1:, 1]) - 1.46, dist(res[1:, 1], res[1:, 2]) - 1.54,
        dist(res[:, 2], res[:, 3]) - 1.22, dist(res[1:, 0], res[:-1, 2]) - 1.34]))


def check_designs(results, requests, label):
    for res, (_, _, n) in zip(results, requests):
        check(len(res.sequence) == n and set(res.sequence)
              <= set("ACDEFGHIKLMNPQRSTVWY"), f"{label}: sequence "
              f"{res.sequence!r} for a peptide of {n}")
        check(res.angles.shape == (n, 8) and np.isfinite(res.angles).all()
              and np.abs(res.angles).max() <= math.pi, f"{label}: angles")
        check(res.pdb is not None, f"{label}: no PDB")
        atoms = np.array([[float(line[30:38]), float(line[38:46]),
                           float(line[46:54])]
                          for line in res.pdb.splitlines()
                          if line.startswith("ATOM")])
        check(atoms.shape == (4 * n, 3) and np.isfinite(atoms).all(),
              f"{label}: PDB atoms {atoms.shape} for {n} residues")
        worst = bond_errors(atoms).max() if n > 1 else 0.0
        check(worst <= PDB_BOND_ATOL, f"{label}: PDB bond length off its "
              f"ideal by {worst:.2e} A")


def design_phase(torch, kernels, model, enc, dec, diffusion, batch, gen,
                 card):
    """Phase 8. Returns the seconds of every design batch."""
    from e3diff_tpu_torch.cli.run_pipeline import main as pipeline_main
    from e3diff_tpu_torch.diffusion import D3PMDiffusion
    from e3diff_tpu_torch.geometry.nerf import (
        nerf_build_backbone_batch,
        nerf_build_backbone_np,
    )
    from e3diff_tpu_torch.models import (
        SequenceDenoiser,
        StructureDenoiser,
        sequence_model_configs,
    )
    from e3diff_tpu_torch.models.structure import state_dict_numel
    from e3diff_tpu_torch.ops.transitions import UniformTransition
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record
    from e3diff_tpu_torch.utils.params_io import cast_inference_params
    from e3diff_tpu_torch.utils.presets import structure_sample_config

    # 8.1 the model and its count
    qenc, qdec = sequence_model_configs(max_seq_len=MAX_POS,
                                        dtype=torch.bfloat16)
    t0 = time.perf_counter()
    qmodel = SequenceDenoiser(qenc, qdec, device="cuda", seed=1)
    torch.cuda.synchronize()
    n_params = state_dict_numel(qmodel)
    want_params = expected_sequence_param_count(qenc, qdec)
    print(f"  SequenceDenoiser built in {time.perf_counter() - t0:.2f} s: "
          f"{n_params:,} values (expected {want_params:,}, JAX "
          f"{SEQUENCE_PARAMS:,})")
    check(n_params == want_params == SEQUENCE_PARAMS,
          "sequence parameter count differs")

    # 8.2 one forward through the kernels against the plain versions, at
    # the main path's batch with the last 3 rows dead slots (all masks 0)
    fwd = dict(batch)
    fwd["ligand_attn_mask"] = batch["ligand_attn_mask"].clone()
    fwd["receptor_attn_mask"] = batch["receptor_attn_mask"].clone()
    fwd["ligand_attn_mask"][-3:] = 0
    fwd["receptor_attn_mask"][-3:] = 0
    x_t = torch.nn.functional.one_hot(torch.randint(
        0, 20, (B, L_LIG), generator=gen, device="cuda"), 20).float()
    ligand_angles = (torch.rand(B, L_LIG, 8, generator=gen, device="cuda")
                     * 2 - 1) * math.pi
    s_t = torch.randint(0, SEQ_T, (B, 1), generator=gen,
                        device="cuda").float()
    qenc32, qdec32 = sequence_model_configs(max_seq_len=MAX_POS)
    qmodel32 = SequenceDenoiser(qenc32, qdec32, device="cuda", seed=None)
    qmodel32.load_state_dict(qmodel.state_dict(), strict=True)
    for m, dname in ((qmodel32, "f32"), (qmodel, "bf16")):
        def forward():
            return m(s_t, x_t, ligand_angles, fwd["ligand_attn_mask"],
                     fwd["receptor_seq"], fwd["receptor_angles"],
                     fwd["receptor_attn_mask"])
        kernels.reset_launch_counts()
        with torch.no_grad():  # as the sampler calls it
            got = forward()
        counts = launch_counts(kernels)
        with plain_versions(kernels), torch.no_grad():
            want = forward()
        torch.cuda.synchronize()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        err = max_err(got, want)
        print(f"  sequence forward {dname}: max_abs_err {err:.3e}, relative "
              f"L2 {rel:.3e}, |logits| max "
              f"{want.float().abs().max().item():.2f}, launches {counts}")
        check(got.isfinite().all().item(), f"forward {dname}: not finite")
        check(counts == with_zeros(kernels, PER_SEQ_FORWARD),
              f"forward {dname}: launches {counts} != {PER_SEQ_FORWARD}")
        if dname == "f32":
            check(err <= DECODE_F32_ATOL, f"forward f32 differs by {err}")
        else:
            check(rel <= DECODE_BF16_REL_L2, f"forward bf16 differs by {rel}")
    del qmodel32

    # 8.3 the batched NERF on the card against the float64 oracle
    rng = np.random.default_rng(3)
    angles = np.concatenate(
        [rng.uniform(-np.pi, np.pi, (B, L_LIG, 4)),
         rng.normal([1.94, 2.03, 2.13, 2.1], 0.05, (B, L_LIG, 4))],
        axis=-1).astype(np.float32)
    coords = nerf_build_backbone_batch(torch.from_numpy(angles).cuda())
    coords = coords.cpu().numpy()
    err = max(np.abs(coords[i] - nerf_build_backbone_np(
        phi=a[:, 0], psi=a[:, 1], omega=a[:, 2], dihedral_o=a[:, 3],
        bond_angle_ca_c=a[:, 4], bond_angle_c_n=a[:, 5],
        bond_angle_n_ca=a[:, 6], bond_angle_c_o=a[:, 7],
        center=False)).max() for i, a in enumerate(angles))
    bonds = max(bond_errors(c).max() for c in coords)
    print(f"  NERF {B}x{L_LIG} on the card: max_abs_err {err:.3e} A against "
          f"the float64 oracle (atol {NERF_ATOL:g}), bond lengths within "
          f"{bonds:.2e} A of ideal (atol {BOND_ATOL:g})")
    check(err <= NERF_ATOL, "NERF disagrees with the oracle")
    check(bonds <= BOND_ATOL, "NERF bond lengths off their ideal values")

    # 8.4-8.5 DesignEngine, both storage modes, two batches each
    cfg = structure_sample_config(ligand_max_len=L_LIG)
    requests = pocket_requests(DESIGN_BATCH, seed=4)
    seconds = {}
    for storage in ("int8_matmul", "f32"):
        smodel = StructureDenoiser(enc, dec, device="cuda", seed=None)
        smodel.load_state_dict(model.state_dict(), strict=True)
        qm = SequenceDenoiser(qenc, qdec, device="cuda", seed=None)
        qm.load_state_dict(qmodel.state_dict(), strict=True)
        for m in (smodel, qm):
            cast_inference_params(m, storage)
        eng = DesignEngine(
            cfg, smodel, diffusion, qm,
            D3PMDiffusion.create(UniformTransition(20), SEQ_T,
                                 device="cuda"),
            device="cuda", batch_size=DESIGN_BATCH, batch_buckets=[8],
            sampler="ddim", ddim_steps=DDIM_STEPS)
        kernels.reset_launch_counts()
        eng.warmup(generator=torch.Generator(device="cuda").manual_seed(5))
        counts = launch_counts(kernels)
        programs = eng.graphs.values()
        want = sum_counts(captured(kernels, STRUCT_CALLS, 2),
                          captured(kernels, SEQ_CALLS, 2))
        print(f"  {storage} warmup: {len(programs)} programs captured "
              f"(batch buckets 8 and {DESIGN_BATCH}), launches {counts}")
        check(counts == want, f"{storage} warmup: launches {counts} != "
              f"{want}")
        check_capture_launches(kernels, programs, f"{storage} engine")
        meter = StageMeter(torch, eng)
        for label, reqs in ((f"{DESIGN_BATCH} records", requests),
                            (f"{SMALL_BATCH} records in batch bucket 8",
                             requests[:SMALL_BATCH])):
            name = f"{label} {storage}"
            records = [pocket_record(*r) for r in reqs]
            meter.calls.clear()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.design_records(
                records, generator=torch.Generator(
                    device="cuda").manual_seed(6))
            secs = time.perf_counter() - t0
            counts = launch_counts(kernels)
            stage_secs = {stage: round(t, 4) for stage, t in meter.calls}
            seconds[name] = secs
            print(f"  {name}: {secs:.3f} s per design batch, "
                  f"{len(reqs) / secs:.2f} designs/s; stage seconds "
                  f"{stage_secs} (NERF, PDB text and host work: "
                  f"{secs - sum(stage_secs.values()):.3f} s); launches "
                  f"from Python {counts} (replays)", flush=True)
            check(len(meter.calls) == 2 and len(eng.graphs) == 4
                  and counts == with_zeros(kernels, {}),
                  f"{name}: a warm engine launched {counts} outside its "
                  f"graphs, or captured anew")
            check_designs(results, reqs, name)
        del eng, smodel, qm

    # 8.6 the pipeline CLI
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        results = pipeline_main([
            "--synthetic", "--sampler", "ddim", "--ddim_steps",
            str(DDIM_STEPS), "--params_dtype", "int8_matmul",
            "--batch_size", str(B), "--max_seq_len", str(MAX_POS),
            "--ligand_max_len", str(L_LIG), "--outdir", tmp])
        secs = time.perf_counter() - t0
        counts = launch_counts(kernels)
        want = sum_counts(captured(kernels, STRUCT_CALLS),
                          captured(kernels, SEQ_CALLS))
        print(f"  cli run_pipeline ddim-{DDIM_STEPS} int8_matmul: {secs:.3f} "
              f"s including both models' build and capture, "
              f"{len(results['predict_sequence'])} designs, launches {counts}")
        check(counts == want, f"pipeline cli: launches {counts} != {want}")
        check(len(results["predict_sequence"]) > 0 and all(
            p and Path(p).is_file() for p in results["pdb_paths"])
            and (Path(tmp) / "results.pkl").is_file(),
            "pipeline cli wrote no designs")
        check([len(s) for s in results["predict_sequence"]]
              == [len(a) for a in results["generated_angles"]],
              "pipeline cli: sequence lengths")
    print(f"  {card}")
    return seconds


# ---------------------------------------------------------------------------
# phase 10: serving
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 40
SERVE_LIGAND_BUCKETS = [8, 16]
MEMORY_LIGAND_BUCKETS, MEMORY_BATCH_BUCKETS = [8, 12, 16], [8, 16]
MEMORY_BATCHES = 20
# Captured against eager on the same draws: the graphs replay the kernels
# and the cuBLAS products that the eager loop launches, on the same
# inputs, so they are held to the same bits (GRAPH_TOL = 0 in every
# comparison: the largest wrapped angle difference, and the logits).
GRAPH_TOL = 0.0
# max_memory_allocated over the second pass through the buckets against
# the first, each pass evicting programs from the cache
MEMORY_SLACK = 0.01


def wrapped_max_diff(torch, a, b) -> float:
    d = a.float() - b.float()
    return ((d + math.pi) % (2 * math.pi) - math.pi).abs().max().item()


def timed(torch, fn):
    """fn()'s result and its seconds, to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def replay_kernel_counts(torch, call, reset=None) -> dict[str, int]:
    """The port's inference kernels in a torch.profiler trace of one
    replay of a captured call, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    if reset is not None:
        reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call.replay()
        torch.cuda.synchronize()
    counts = {"fused_attention": 0, "fused_layernorm": 0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = kernel_name_of(e.key)
        if name.startswith(("attention_mma_kernel", "attention_f32_kernel")):
            counts["fused_attention"] += e.count
        elif name.startswith(("layernorm_vec_kernel", "layernorm_any_kernel")):
            counts["fused_layernorm"] += e.count
    return counts


def check_replays(torch, prog, calls, label):
    """Each captured call's replay runs the kernels its capture launched,
    counted by name in a profiler trace; a step replays at index 0."""
    for name, per in calls.items():
        call = getattr(prog, name)
        got = replay_kernel_counts(
            torch, call, prog.state.i.zero_ if name == "step" else None)
        want = {k: per.get(k, 0) for k in got}
        print(f"  {label} {name}: one replay ran {got} (captured "
              f"{ {k: v for k, v in call.launches.items() if v} })",
              flush=True)
        check(got == want, f"{label} {name}: a replay ran {got}, not {want}")


def serving_phase(torch, kernels, model, enc, dec, diffusion, batch, card,
                  profile_dir):
    """Phase 10. Returns the launches of the server's run (its warmup's
    captures and its requests) and the phase's seconds."""
    import concurrent.futures
    import threading
    import types
    import urllib.error
    import urllib.request

    from e3diff_tpu_torch.data import synthetic_complexes
    from e3diff_tpu_torch.diffusion import D3PMDiffusion
    from e3diff_tpu_torch.models import (
        SequenceDenoiser,
        StructureDenoiser,
        sequence_model_configs,
    )
    from e3diff_tpu_torch.ops.transitions import UniformTransition
    from e3diff_tpu_torch.sampling import (
        make_sequence_sampler,
        make_structure_sampler,
    )
    from e3diff_tpu_torch.serving import (
        DesignEngine,
        DesignServer,
        pocket_record,
    )
    from e3diff_tpu_torch.utils.params_io import cast_inference_params
    from e3diff_tpu_torch.utils.presets import structure_sample_config

    smodel = StructureDenoiser(enc, dec, device="cuda", seed=None)
    smodel.load_state_dict(model.state_dict(), strict=True)
    qenc, qdec = sequence_model_configs(max_seq_len=MAX_POS,
                                        dtype=torch.bfloat16)
    qm = SequenceDenoiser(qenc, qdec, device="cuda", seed=1)  # phase 8's
    for m in (smodel, qm):
        cast_inference_params(m, "int8_matmul")
    d3pm = D3PMDiffusion.create(UniformTransition(20), SEQ_T, device="cuda")
    seconds = {}
    scales = torch.linspace(1.0, 2.0, B, device="cuda")

    # 10.1 the structure sampler, captured against eager
    angles = None
    for sampler, n, guided in (("ddim", DDIM_STEPS, False), ("ddpm", T, False),
                               ("ddim", DDIM_STEPS, True)):
        name = f"structure {sampler}-{n}{' cfg' if guided else ''} int8"
        x_init, z = diffusion.draw_noise(
            (B, L_LIG, 8), n, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(21))
        noise = {"x_init": x_init, "z": z}
        w = scales if guided else None
        kw = dict(sampler=sampler, ddim_steps=n, return_trajectory=False,
                  guided=guided)
        eager = make_structure_sampler(smodel, diffusion, eager=True, **kw)
        run = make_structure_sampler(smodel, diffusion, **kw)
        prog, capture_s = timed(torch, lambda: run.program(batch))
        check_capture_launches(kernels, [prog], name)
        if sampler == "ddim" and not guided:
            check_replays(torch, prog, STRUCT_CALLS, name)
        (want, _), eager_s = timed(torch, lambda: eager(batch, noise=noise,
                                                        scale=w))
        (got, _), graph_s = timed(torch, lambda: run(batch, noise=noise,
                                                     scale=w))
        err = wrapped_max_diff(torch, got, want)
        seconds[name] = {"eager": eager_s, "captured": graph_s,
                         "capture": capture_s}
        print(f"  {name}: eager {eager_s:.3f} s, captured {graph_s:.3f} s "
              f"({eager_s / graph_s:.1f}x; capture {capture_s:.3f} s), "
              f"max wrapped |captured - eager| {err:.3e} (tol "
              f"{GRAPH_TOL:g})", flush=True)
        check(in_angle_range(torch, got), f"{name}: out of range")
        check(err <= GRAPH_TOL, f"{name}: captured differs from eager")
        if sampler == "ddim" and not guided:
            angles = got

    # 10.2 the sequence sampler, captured against eager
    sb = dict(batch, ligand_angles=angles,
              ligand_seq=torch.zeros(B, L_LIG, 20, device="cuda"))
    for guided in (False, True):
        name = f"sequence d3pm-{SEQ_T}{' cfg' if guided else ''} int8"
        x_init, gumbel = d3pm.draw_noise(
            (B, L_LIG, 20), None, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(22))
        noise = {"x_init": x_init, "gumbel": gumbel}
        w = scales if guided else None
        eager = make_sequence_sampler(qm, d3pm, guided=guided, eager=True)
        run = make_sequence_sampler(qm, d3pm, guided=guided)
        prog, capture_s = timed(torch, lambda: run.program(sb))
        check_capture_launches(kernels, [prog], name)
        if not guided:
            check_replays(torch, prog, SEQ_CALLS, name)
        want, eager_s = timed(torch, lambda: eager(sb, noise=noise, scale=w))
        got, graph_s = timed(torch, lambda: run(sb, noise=noise, scale=w))
        prog.load(sb, x_init, gumbel, 1.0 if w is None else w)
        for _ in range(prog.n_steps):
            prog.step.replay()
        prog.final.replay()
        seam = prog.final.out.clone()
        print(f"  {name}: load + {prog.n_steps} step replays + the final "
              f"replay equal run bit for bit: {torch.equal(seam, got)}",
              flush=True)
        check(torch.equal(seam, got), f"{name}: the one-step seam differs "
              "from run")
        err = (got.float() - want.float()).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        seconds[name] = {"eager": eager_s, "captured": graph_s,
                         "capture": capture_s}
        print(f"  {name}: eager {eager_s:.3f} s, captured {graph_s:.3f} s "
              f"({eager_s / graph_s:.1f}x; capture {capture_s:.3f} s), max "
              f"|captured - eager| logits {err:.3e} (tol {GRAPH_TOL:g}), "
              f"argmax agreement {agree:.4f}", flush=True)
        check(bool(got.isfinite().all()), f"{name}: not finite")
        check(err <= GRAPH_TOL, f"{name}: captured differs from eager")

    # 10.3 a design batch, captured and eager samplers
    cfg = structure_sample_config(ligand_max_len=L_LIG)
    records = [pocket_record(*r) for r in pocket_requests(DESIGN_BATCH, 4)]

    def engine(**kw):
        return DesignEngine(cfg, smodel, diffusion, qm, d3pm, device="cuda",
                            batch_size=DESIGN_BATCH, sampler="ddim",
                            ddim_steps=DDIM_STEPS, **kw)

    eng_graph, eng_eager = engine(), engine()
    eng_graph.warmup(generator=torch.Generator(device="cuda").manual_seed(5))
    eng_eager._struct_run = make_structure_sampler(
        smodel, diffusion, sampler="ddim", ddim_steps=DDIM_STEPS,
        return_trajectory=False, guided=False, eager=True)
    eng_eager._seq_run = make_sequence_sampler(qm, d3pm, guided=False,
                                               eager=True)
    designs = {}
    for label, eng in (("eager", eng_eager), ("captured", eng_graph),
                       ("captured", eng_graph), ("eager", eng_eager)):
        res, secs = timed(torch, lambda: eng.design_records(
            records, generator=torch.Generator(device="cuda").manual_seed(6)))
        seconds.setdefault(f"design batch {DESIGN_BATCH} int8 {label}",
                           []).append(secs)
        designs[label] = res
        print(f"  design batch of {DESIGN_BATCH}, {label} samplers: "
              f"{secs:.3f} s", flush=True)
    same = sum(a.sequence == b.sequence and np.array_equal(a.angles, b.angles)
               for a, b in zip(designs["eager"], designs["captured"]))
    print(f"  the same designs from one seed, captured and eager: {same} of "
          f"{DESIGN_BATCH}", flush=True)
    check(same == DESIGN_BATCH, "captured designs differ from eager ones")
    if profile_dir is not None:
        for label, eng in (("captured", eng_graph), ("eager", eng_eager)):
            busy = profile_design(torch, eng, records, profile_dir, label)
            seconds[f"design batch device idle {label}"] = 1 - busy
    del eng_graph, eng_eager

    # 10.4 DesignServer
    eng = engine(ligand_buckets=SERVE_LIGAND_BUCKETS, batch_buckets=[8])
    server = DesignServer(eng, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"

    def http(method, path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = resp.status, json.loads(resp.read()), dict(resp.headers)
        except urllib.error.HTTPError as e:
            out = e.code, json.loads(e.read()), dict(e.headers)
        return (*out, time.perf_counter() - t0)

    try:
        code = http("GET", "/healthz")[0]
        check(code == 503, f"/healthz before warmup: {code}")
        kernels.reset_launch_counts()
        _, warm_s = timed(torch, lambda: eng.warmup(
            generator=torch.Generator(device="cuda").manual_seed(5)))
        code = http("GET", "/healthz")[0]
        print(f"  server warmup: {len(eng.graphs)} programs captured in "
              f"{warm_s:.2f} s; /healthz 503 before, {code} after",
              flush=True)
        check(code == 200 and len(eng.graphs) == 4 * 2,
              f"/healthz after warmup: {code}, {len(eng.graphs)} programs")
        requests = pocket_requests(SERVE_REQUESTS, seed=11)
        check({SERVE_LIGAND_BUCKETS[0] >= n for _, _, n in requests}
              == {True, False}, "the requests do not span both buckets")

        def design(req):
            seq, ang, n = req
            return http("POST", "/design", {
                "pocket": {"sequence": seq, "angles": ang.tolist(),
                           "peptide_length": n},
                "return_angles": True})

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_REQUESTS) as pool:
            answers = list(pool.map(design, requests))
        wall = time.perf_counter() - t0
        codes = [a[0] for a in answers]
        check(codes == [200] * SERVE_REQUESTS, f"/design codes {codes}")
        check_designs([types.SimpleNamespace(
            sequence=a[1]["designs"][0]["sequence"],
            angles=np.asarray(a[1]["designs"][0]["angles"], np.float32),
            pdb=a[1]["designs"][0].get("pdb")) for a in answers], requests,
            "server")
        rec = synthetic_complexes(n=1, seed=12, receptor_len_range=(8, 20),
                                  ligand_len_range=(6, 12))[0]
        code, body, _, _ = http("POST", "/inverse_fold", {"record": {
            "amino_acid": list(rec["amino_acid"]),
            "angle_features": np.asarray(rec["angle_features"]).tolist(),
            "ligand_mask": np.asarray(rec["ligand_mask"]).astype(int).tolist(),
            "pocket_mask": np.asarray(rec["pocket_mask"]).astype(int).tolist(),
        }, "n_samples": 3})
        n_lig = int(np.asarray(rec["ligand_mask"]).sum())
        check(code == 200 and [len(d["sequence"]) for d in body["sequences"]]
              == [n_lig] * 3, f"/inverse_fold: {code} {body}")
        _, stats, _, _ = http("GET", "/stats")
        serve_counts = launch_counts(kernels)
        want = sum_counts(captured(kernels, STRUCT_CALLS, 4),
                          captured(kernels, SEQ_CALLS, 4))
        lat = sorted(a[3] for a in answers)
        p50, p95 = lat[len(lat) // 2], lat[min(int(0.95 * len(lat)),
                                               len(lat) - 1)]
        seconds["server"] = {
            "requests": SERVE_REQUESTS, "wall_s": wall,
            "client_p50_s": p50, "client_p95_s": p95,
            "batches": stats["batches"],
            "mean_batch_occupancy": stats["mean_batch_occupancy"],
            "batcher_p50_ms": stats.get("latency_ms_p50"),
            "batcher_p95_ms": stats.get("latency_ms_p95")}
        print(f"  server: {SERVE_REQUESTS} concurrent /design requests over "
              f"ligand buckets {SERVE_LIGAND_BUCKETS} all 200 in {wall:.3f} "
              f"s; client latency p50 {p50 * 1e3:.1f} ms, p95 "
              f"{p95 * 1e3:.1f} ms; /stats {stats['batches']} batches, mean "
              f"occupancy {stats['mean_batch_occupancy']:.2f}, batcher p50 "
              f"{stats.get('latency_ms_p50', 0):.1f} ms, p95 "
              f"{stats.get('latency_ms_p95', 0):.1f} ms; /inverse_fold 200; "
              f"launches {serve_counts} (warmup captures; replays launch "
              f"none)", flush=True)
        check(stats["batches"] < SERVE_REQUESTS
              and stats["mean_batch_occupancy"] > 1,
              f"the requests were not coalesced: {stats}")
        check(serve_counts == want, f"server: launches {serve_counts} != "
              f"{want}")
        check(len(eng.graphs) == 8, "the requests captured anew")

        # a small queue under a held device: 429 with Retry-After
        gate = threading.Event()
        real = eng.design_slots

        def held(slots, **kw):
            gate.wait(timeout=60)
            return real(slots, **kw)

        eng.design_slots = held
        small = DesignServer(eng, port=0, max_wait_ms=1.0, max_queue=2)
        small.start()
        url = f"http://127.0.0.1:{small.port}/design"
        payload = json.dumps({"pocket": {
            "sequence": requests[0][0], "angles": requests[0][1].tolist(),
            "peptide_length": requests[0][2]}, "return_pdb": False}).encode()

        def post():
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url, data=payload, method="POST"), timeout=300) as r:
                    return r.status, dict(r.headers)
            except urllib.error.HTTPError as e:
                return e.code, dict(e.headers)

        try:
            with concurrent.futures.ThreadPoolExecutor(3) as pool:
                held_futs = []
                for _ in range(3):   # the worker holds one, two fill the queue
                    held_futs.append(pool.submit(post))
                    time.sleep(0.3)
                code, headers = post()
                gate.set()
                held_codes = [f.result(timeout=300)[0] for f in held_futs]
        finally:
            gate.set()
            small.shutdown()
            del eng.design_slots
        print(f"  small queue (max_queue 2) under a held device: {code}, "
              f"Retry-After {headers.get('Retry-After')}; the held requests "
              f"{held_codes}", flush=True)
        check(code == 429 and int(headers.get("Retry-After", 0)) >= 1
              and held_codes == [200] * 3, "no 429 with Retry-After")
    finally:
        server.shutdown()
    del eng
    torch.cuda.empty_cache()

    # 10.5 memory through more buckets than the cache holds
    eng = engine(ligand_buckets=MEMORY_LIGAND_BUCKETS,
                 batch_buckets=MEMORY_BATCH_BUCKETS)
    shapes = [(lig, n) for n in (5, 12, DESIGN_BATCH)
              for lig in MEMORY_LIGAND_BUCKETS]
    pockets = pocket_requests(DESIGN_BATCH, seed=13)
    allocated, peaks = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(MEMORY_BATCHES):
        lig, n = shapes[i % len(shapes)]
        if i == len(shapes):
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        eng.design_records([pocket_record(seq, ang, lig)
                            for seq, ang, _ in pockets[:n]],
                           generator=torch.Generator(
                               device="cuda").manual_seed(i),
                           return_pdb=False)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    peaks.append(torch.cuda.max_memory_allocated())
    secs = time.perf_counter() - t0
    print(f"  {MEMORY_BATCHES} design batches over {len(shapes)} buckets "
          f"({2 * len(shapes)} programs, a cache of "
          f"{eng.graphs.maxsize}) in {secs:.1f} s: max_memory_allocated "
          f"{peaks[0] / 2**20:.1f} MiB over the first pass, "
          f"{peaks[1] / 2**20:.1f} MiB after; memory_allocated after each "
          f"batch (MiB) {[round(a / 2**20, 1) for a in allocated]}",
          flush=True)
    check(len(eng.graphs) == eng.graphs.maxsize, "the cache is not full")
    check(peaks[1] <= (1 + MEMORY_SLACK) * peaks[0],
          f"device memory grew across evictions: {peaks}")
    seconds["memory"] = {"first_pass_peak_mib": peaks[0] / 2**20,
                         "later_peak_mib": peaks[1] / 2**20}
    del eng
    print(f"  {card}")
    return serve_counts, seconds


def check_capture_launches(kernels, programs, label):
    """Each captured call of each program launched, at its capture, the
    kernels of one encode, step or forward exactly (STRUCT_CALLS,
    SEQ_CALLS)."""
    for prog in programs:
        calls = STRUCT_CALLS if hasattr(prog, "encode") else SEQ_CALLS
        for name, per in calls.items():
            got = getattr(prog, name).launches
            check(got == with_zeros(kernels, per), f"{label}: the captured "
                  f"{type(prog).__name__}.{name} launched {got}, not {per}")


def profile_design(torch, eng, records, out: Path, label: str):
    """Device busy share of one 32-record design batch (``label``: the
    engine's samplers, captured or eager), and its device time by stage:
    the structure sampler's kernels, the sequence sampler's, and the rest;
    the chrome trace goes to ``out``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attr, stage in (("_struct_run", "structure stage"),
                        ("_seq_run", "sequence stage")):
        def ranged(*a, _run=getattr(eng, attr), _stage=stage, **kw):
            with record_function(_stage):
                return _run(*a, **kw)
        setattr(eng, attr, ranged)
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.design_records(records, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    stages = ("structure stage", "sequence stage")
    cuda = torch.autograd.DeviceType.CUDA
    # the two ranges also appear on the device's timeline as spans (their
    # length there, not kernel time): kept out of the busy sum
    busy = sum(getattr(e, "device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type == cuda and e.key not in stages)
    print(f"  profile, one {label} design batch of {len(records)}: wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for e in prof.key_averages():
        if e.key in stages and e.device_type != cuda:
            print(f"  {e.key}: host {e.cpu_time_total / 1e3:.2f} ms, its "
                  f"kernels' device time "
                  f"{getattr(e, 'device_time_total', 0) / 1e3:.2f} ms")
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"design_batch_{label}_trace.json"))
    return busy / wall_us


def profile_sampler(torch, model, diffusion, batch, make_structure_sampler,
                    cast_inference_params, StructureDenoiser, enc, dec,
                    out: Path, eager: bool):
    """Device busy share and the kernels by device time over one DDIM-25
    run with int8 storage, its second (captured: replays only; or the eager
    loop); the chrome trace goes to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    m = StructureDenoiser(enc, dec, device="cuda", seed=None)
    m.load_state_dict(model.state_dict(), strict=True)
    cast_inference_params(m, "int8_matmul")
    run = make_structure_sampler(m, diffusion, sampler="ddim",
                                 ddim_steps=DDIM_STEPS,
                                 return_trajectory=False, eager=eager)
    run(batch, generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batch, generator=torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        dev = getattr(e, "device_time_total",
                      getattr(e, "cuda_time_total", 0))
        rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3:9.3f} ms {count:7d}x  {key[:90]}")
    print_port_kernels(rows)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(
        out / f"ddim25_int8_{'eager' if eager else 'captured'}_trace.json"))


def print_port_kernels(rows):
    """The port's kernels among the profiler's (device us, calls, name)
    rows: their sum, then each one's time and time per call."""
    ours = [r for r in rows if re.search(
        r"\b(attention|layernorm)_\w+_kernel|column_sum_kernel"
        r"|table_grad_sum_kernel", r[2])]
    print(f"  the port's kernels: {sum(r[0] for r in ours) / 1e3:.3f} ms "
          f"of device time in {sum(r[1] for r in ours)} calls")
    for dev, count, key in ours:
        print(f"  {dev / 1e3:9.3f} ms {count:7d}x  {dev / count:7.2f} us "
              f"per call  {key[:70]}")



def profile_train_steps(torch, kernels, out: Path, n_steps: int = 3):
    """Device busy share of ``n_steps`` eager structure train steps at the
    preset's full width (after 3 unprofiled ones), the kernels by device
    time, the port's kernels and the random draws, from the
    utils/profiling.py digest of the trace written to ``out``."""
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils import profiling
    from e3diff_tpu_torch.utils.presets import structure_train_config
    from e3diff_tpu_torch.utils.timing import profiler_trace

    cfg = structure_train_config(max_epochs=1)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch, draws = train_batch(torch, cfg, gen, "structure")
    trainer = build_trainer("structure", cfg, "cuda", steps_per_epoch=10_000)
    for _ in range(3):
        trainer.train_step(batch, **draws)
    with profiler_trace(str(out / "structure_train")) as path:
        for _ in range(n_steps):
            trainer.train_step(batch, **draws)
    trace = profiling.load_trace(path)
    d = profiling.digest(trace, n_steps)
    totals = profiling.device_op_totals(trace)
    print(f"  {n_steps} steps: device busy "
          f"{d['roofline']['ms_per_step']:.2f} ms a step, idle "
          f"{100 * d['device_idle_share']:.1f}% of the trace's window")
    for name, bucket, ms, calls, us in profiling.top_ops(totals, 15,
                                                         n_steps):
        print(f"  {ms:9.3f} ms {calls:7.0f}x  [{bucket}] {name[:80]}")
    print_port_kernels([(info["us"], info["count"], name)
                        for name, info in totals.items()])
    # random draws: the hidden Dropout modules' torch.rand (uniform) and the
    # attention cores' seeds (torch.randint); the keep bits themselves are
    # drawn inside the attention kernels
    n_draws = sum(i["count"] for k, i in totals.items()
                  if profiling.bucket_of(k) == "random")
    print(f"  dropout draws: {d['buckets'].get('random', 0.0):.3f} ms a step "
          f"in {n_draws // n_steps} launches")
    del trainer
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

# the training shapes first (timed): B=64, Lq=Lk=128, the table at max_pos
# 128; then the sampler's shapes, a ragged Lk and dead rows
TRAIN_B, TRAIN_L = 64, 128
TRAIN_ATTN_CASES = [
    AttnCase("train self 64x128x128 +table", TRAIN_B, TRAIN_L, TRAIN_L,
             TRAIN_L, True, True),
    AttnCase("train cross 64x128x128", TRAIN_B, TRAIN_L, TRAIN_L, TRAIN_L,
             False, True),
    AttnCase("sampler 32x16x16 +table", B, L_LIG, L_LIG, MAX_POS, True,
             False),
    AttnCase("sampler 32x16x64", B, L_LIG, L_REC, MAX_POS, False, True),
    AttnCase("sampler 32x64x64 +table", B, L_REC, L_REC, MAX_POS, True,
             True),
    AttnCase("ragged 32x16x50 +table", B, L_LIG, 50, MAX_POS, True, True),
    AttnCase("dead rows 8x16x16 +table", 8, L_LIG, L_LIG, MAX_POS, True,
             True, True),
    # Lq != Lk with the table (the bf16 kernel's query and key passes
    # take different warp counts), lengths off the 16-row tiles
    AttnCase("Lq<Lk 8x16x128 +table", 8, 16, TRAIN_L, TRAIN_L, True, True),
    AttnCase("Lq>Lk 8x128x16 +table", 8, TRAIN_L, 16, TRAIN_L, True, True),
    AttnCase("off-tile 8x100x77 +table", 8, 100, 77, TRAIN_L, True, True),
    # without the table the training forward splits the queries over
    # blocks of 64: a last block of 36 rows
    AttnCase("off-tile 8x100x77", 8, 100, 77, TRAIN_L, False, True),
]
TRAIN_LN_ROWS = [TRAIN_B * TRAIN_L, 512]
# A dp=2 x tp=2 rank's attention (phase 13): its 32 of 64 batch rows and
# 6 of 12 heads, general inputs, drawing the second rows' and heads' block
# of the one-device bits.
TP_ATTN_CASE = AttnCase("tp rank 32x128x128 +table, block (32, 64, 6, 12)",
                        TRAIN_B // 2, TRAIN_L, TRAIN_L, TRAIN_L, True, True)
TP_BLOCK = (TRAIN_B // 2, TRAIN_B, HEADS // 2, HEADS)
DROPOUT = 0.1
# The backward kernels against their plain versions, as the largest error
# over the largest |value| of the plain result. f32: both sum the same f32
# products in different orders (the kernels' table gradient over (b, h)
# in a fixed order of their own, the same on every run): 1e-4. bf16: the same
# inputs and f32 arithmetic, but dQ, dK and dV are rounded to bf16 (a step
# of 2^-8 relative) after sums in different orders, and P f is rounded to
# bf16 before dV, so a value near a rounding boundary may land one step
# away: 1e-2. The f32 table and LayerNorm weight gradients in a bf16 run
# differ by summation order only: 1e-3. Dead rows (every key masked) sit
# near -10^4, where an f32 step is 2^-10, so P = exp(x - lse) carries an
# error of ~1e-3: 1e-2 there.
BWD_REL = {"float32": 1e-4, "bfloat16": 1e-2}
BWD_F32_OUT_REL = {"float32": 1e-4, "bfloat16": 1e-3}
BWD_DEAD_REL = 1e-2
# the row log-sum-exp of the training forward, against the plain version's
# (values ~5-15, or ~-10^4 in dead rows where the f32 step is 2^-10)
LSE_TOL = (1e-3, 1e-5)


def compare_rel(label, got, want, rel) -> float:
    """max |got - want| <= rel * max |want| (+ 1e-5, for a gradient that
    is all but zero); returns the max error."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = (bool(got.float().isfinite().all().item())
          and err <= rel * scale + 1e-5)
    print(f"  {label}: max_abs_err {err:.3e} (rel {rel:g} of max "
          f"{scale:.3e}) {'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{label}: kernel disagrees with its plain version")
    return err


def attention_train_check(torch, kernels, gen, case, dtype, p, heads=HEADS,
                          block=None):
    """The training forward and the backward of one case against their
    plain versions (and, in f32, the backward against torch.autograd
    through the plain forward). Returns the errors of the output and of
    dQ. ``heads`` and ``block``: a tp rank's heads and its dropout block
    (row_offset, total_rows, head_offset, total_heads) of the one-device
    bits, which the plain versions take as dropout_keep_plain's block."""
    dname = str(dtype).split(".")[-1]
    q, k, v, mask, tab = attention_inputs(torch, gen, case, dtype, heads)
    kw = dict(num_heads=heads, max_pos=case.max_pos)
    seed = draw_seed(torch, gen) if p > 0 else None
    keep = None if seed is None else kernels.dropout_keep_plain(
        seed, (case.b, heads, case.lq, case.lk), p, block)
    tag = f"{case.label} {dname} p={p}"
    out, lse = kernels.fused_attention_train(q, k, v, mask, tab, seed, p,
                                             dropout_block=block, **kw)
    want_out, want_lse = kernels.attention_train_plain(q, k, v, mask, tab,
                                                       keep, p, **kw)
    torch.cuda.synchronize()
    tol = (ATTN_DEAD_F32_TOL if case.dead and dname == "float32"
           else ATTN_TOL[dname])
    out_err = compare(f"attention train fwd {tag}", out, want_out, *tol)
    compare(f"attention train lse {tag}", lse, want_lse, *LSE_TOL)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = kernels.attention_backward(dout, q, k, v, lse, mask, tab,
                                     seed, p, dropout_block=block, **kw)
    again = kernels.attention_backward(dout, q, k, v, lse, mask, tab,
                                       seed, p, dropout_block=block, **kw)
    want = kernels.attention_backward_plain(dout, q, k, v, lse, mask,
                                            tab, keep, p, **kw)
    torch.cuda.synchronize()
    same = [name for name, a, b in zip(("dq", "dk", "dv", "dtable"), got,
                                       again)
            if a is not None and torch.equal(a, b)]
    print(f"  attention bwd {tag}: a second call gives the same bits in "
          f"{same}", flush=True)
    check(len(same) == (4 if tab is not None else 3),
          f"{tag}: two backward calls on the same inputs differ")
    rel = BWD_DEAD_REL if case.dead else BWD_REL[dname]
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv", "dtable"), got, want):
        if w is None:
            check(g is None, f"{tag}: a table gradient without a table")
            continue
        r = rel
        if name == "dtable":  # f32 in both runs
            r = BWD_DEAD_REL if case.dead else BWD_F32_OUT_REL[dname]
        errs[name] = compare_rel(f"attention bwd {name} {tag}", g, w, r)
    if dtype == torch.float32:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        tab_leaf = None if tab is None else tab.detach().clone(
            ).requires_grad_()
        ref = kernels.attention_autograd_plain(*leaves, mask, tab_leaf,
                                               keep, p, **kw)
        ref.backward(dout)
        grads = [t.grad for t in leaves] + [
            None if tab_leaf is None else tab_leaf.grad]
        for name, g, w in zip(("dq", "dk", "dv", "dtable"), got, grads):
            if w is not None:
                compare_rel(f"attention bwd {name} {tag} vs autograd", g, w,
                            BWD_DEAD_REL if case.dead else BWD_REL[dname])
    return out_err, errs["dq"]


def draw_seed(torch, gen):
    """A dropout seed as kernels.attention draws it: 2 int64 on the card."""
    return torch.randint(0, 2 ** 32, (2,), dtype=torch.int64, generator=gen,
                         device="cuda")


def dropout_bits_check(torch, kernels, gen, case, dtype, p=DROPOUT):
    """Every keep bit the training forward and the backward draw, against
    dropout_keep_plain of the same seed, exactly: with q = k = 0 (and the
    table) every score is equal, P = 1/Lk, and V one-hot, V[r, d] =
    (1 + [r >= 64]) [r mod 64 = d], so the forward's output is
    P f (keep[l, d] + 2 keep[l, d + 64]); with dO one-hot the same way the
    backward's dV is P f (keep[d, r] + 2 keep[d + 64, r]). A single bit
    drawn differently changes one output by P f."""
    dname = str(dtype).split(".")[-1]
    b, lq, lk = case.b, case.lq, case.lk
    kw = dict(num_heads=HEADS, max_pos=case.max_pos)

    def onehot(n):
        r = torch.arange(n, device="cuda")[:, None]
        x = ((r % HEAD_DIM) == torch.arange(HEAD_DIM, device="cuda")[None, :])
        x = x.float() * (1.0 + (r >= HEAD_DIM).float())
        return x.repeat(1, HEADS)[None].expand(b, n, HIDDEN).contiguous().to(
            dtype)

    def code(keep, n):   # (b, H, rows, n) keep bits -> (b, H, rows, 64)
        c = keep[..., :min(n, HEAD_DIM)].long()
        c = torch.nn.functional.pad(c, (0, HEAD_DIM - c.shape[-1]))
        if n > HEAD_DIM:
            c[..., :n - HEAD_DIM] += 2 * keep[..., HEAD_DIM:].long()
        return c

    q = torch.zeros(b, lq, HIDDEN, device="cuda", dtype=dtype)
    k = torch.zeros(b, lk, HIDDEN, device="cuda", dtype=dtype)
    mask = torch.zeros(b, lk, device="cuda")
    tab = (torch.randn(2 * case.max_pos - 1, HEAD_DIM, generator=gen,
                       device="cuda").to(dtype) if case.table else None)
    seed = draw_seed(torch, gen)
    keep = kernels.dropout_keep_plain(seed, (b, HEADS, lq, lk), p)
    pf = torch.tensor(kernels.drop_scale(p) / lk).to(dtype).float()
    out, lse = kernels.fused_attention_train(q, k, onehot(lk), mask, tab,
                                             seed, p, **kw)
    got = torch.round(out.float().view(b, lq, HEADS, HEAD_DIM) / pf).long()
    fwd_ok = torch.equal(got.transpose(1, 2), code(keep, lk))
    _, _, dv, _ = kernels.attention_backward(onehot(lq), q, k, k, lse, mask,
                                             tab, seed, p, **kw)
    got = torch.round(dv.float().view(b, lk, HEADS, HEAD_DIM) / pf).long()
    bwd_ok = torch.equal(got.transpose(1, 2),
                         code(keep.transpose(2, 3), lq))
    print(f"  dropout bits {case.label} {dname}: forward "
          f"{'exact' if fwd_ok else 'DIFFER'}, backward "
          f"{'exact' if bwd_ok else 'DIFFER'} against dropout_keep_plain",
          flush=True)
    check(fwd_ok and bwd_ok, f"dropout bits {case.label} {dname} differ")


# (B, H, Lq, Lk) of the card's keep bits against the plain version: the
# training shape, an odd one (the per-element path) and a single element
KEEP_SHAPES = [(TRAIN_B, HEADS, TRAIN_L, TRAIN_L), (8, HEADS, 100, 77),
               (1, 1, 1, 1)]


def dropout_keep_check(torch, kernels, gen, p=DROPOUT):
    """e3d_dropout_keep (the bits the tensor-core kernels draw, written
    out) against dropout_keep_plain, bit for bit, and the kept share of
    the largest shape within 5 sigma of 1 - p."""
    lib = kernels._build.load_library()
    for shape in KEEP_SHAPES:
        seed = draw_seed(torch, gen)
        got = torch.empty(shape, dtype=torch.uint8, device="cuda")
        code = lib.e3d_dropout_keep(
            ctypes.c_void_p(seed.data_ptr()), *shape, 0, 0, shape[1],
            kernels.dropout_threshold(p), ctypes.c_void_p(got.data_ptr()),
            kernels._stream())
        check(code == 0, f"e3d_dropout_keep failed with cudaError {code}")
        want = kernels.dropout_keep_plain(seed, shape, p)
        same = torch.equal(got.bool(), want)
        n = math.prod(shape)
        rate = got.float().mean().item()
        sigma = math.sqrt(p * (1 - p) / n)
        print(f"  dropout keep {shape}: {'equal' if same else 'DIFFER'} to "
              f"dropout_keep_plain, kept {rate:.6f} (1 - p = {1 - p:g}, "
              f"{abs(rate - (1 - p)) / sigma:.2f} sigma)", flush=True)
        check(same, f"dropout keep bits {shape} differ")
        if n >= 1_000_000:
            check(abs(rate - (1 - p)) <= 5 * sigma,
                  f"dropout keep rate {rate} beyond 5 sigma of {1 - p}")


def layernorm_train_check(torch, kernels, gen, rows, dtype, residual,
                          affine):
    """The LayerNorm backward against its plain version (and, in f32,
    against torch.autograd through layernorm_plain). Returns dx's error."""
    dname = str(dtype).split(".")[-1]
    x, w, b, res, eps = ln_inputs(torch, gen, rows, HIDDEN, dtype, residual,
                                  affine)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    got = kernels.layernorm_backward(dy, x, w, b, res, eps=eps)
    want = kernels.layernorm_backward_plain(dy, x, w, b, res, eps=eps)
    torch.cuda.synchronize()
    label = (f"layernorm bwd {rows}x{HIDDEN}{' +residual' if residual else ''}"
             f"{' +affine' if affine else ''} {dname}")
    err = compare_rel(f"{label} dx", got[0], want[0], BWD_REL[dname])
    for name, g, wnt in zip(("dw", "db"), got[1:], want[1:]):
        check((g is None) == (wnt is None), f"{label}: {name} presence")
        if wnt is not None:
            compare_rel(f"{label} {name}", g, wnt, BWD_F32_OUT_REL[dname])
    if dtype == torch.float32:
        leaves = [None if t is None else t.detach().clone().requires_grad_()
                  for t in (x, w, b, res)]
        kernels.layernorm_plain(*leaves[:3], leaves[3], eps=eps).backward(dy)
        for name, g, leaf in zip(("dx", "dw", "db", "dres"),
                                 (got[0], got[1], got[2], got[0]), leaves):
            if leaf is not None:
                compare_rel(f"{label} {name} vs autograd", g, leaf.grad,
                            BWD_REL[dname])
    return err


def training_kernel_checks(torch, kernels, gen) -> dict:
    """Phase 9.1: the three training kernels against their plain versions
    at the training and sampler shapes, f32 and bf16, dropout 0.1 and 0.
    Returns the bf16 errors of the timed shapes, for the JSON record."""
    errs = {}
    dropout_keep_check(torch, kernels, gen)
    for dtype in (torch.float32, torch.bfloat16):
        for case in TRAIN_ATTN_CASES:
            if not case.dead:
                dropout_bits_check(torch, kernels, gen, case, dtype)
            for p in (DROPOUT, 0.0):
                out_err, dq_err = attention_train_check(torch, kernels, gen,
                                                        case, dtype, p)
                if dtype == torch.bfloat16 and p == DROPOUT:
                    errs["fused_attention_train", case.label] = out_err
                    errs["attention_backward", case.label] = dq_err
        attention_train_check(torch, kernels, gen, TP_ATTN_CASE, dtype,
                              DROPOUT, HEADS // 2, TP_BLOCK)
        for rows in TRAIN_LN_ROWS:
            for residual in (False, True):
                for affine in (False, True):
                    err = layernorm_train_check(torch, kernels, gen, rows,
                                                dtype, residual, affine)
                    if dtype == torch.bfloat16 and residual and affine:
                        errs["layernorm_backward", rows] = err
    return errs


def attention_train_cost(b, lq, lk, with_table, elem, backward):
    """Bytes (each input read once, each output written once) and
    operations (2 per multiply-add) of the training forward or of the
    backward. Forward: q, k, v, the mask, the table window and the 16-byte
    seed read, the output and the lse written; QK^T, the bias and P V.
    Backward: q, k, v, dO, the mask, the seed, the lse and the table
    window read, dQ, dK, dV and the f32 table window written; the
    recomputed scores and bias, dP, dV, dQ, dK, and with a table dQ's
    table term and the table gradient. The dropout bits are drawn in the
    kernels (no mask is read); their integer work is not counted."""
    window = (lq + lk - 1) * HEAD_DIM if with_table else 0
    seed = 16
    lse = 4 * b * HEADS * lq
    mask = 4 * b * lk
    q_bytes, kv_bytes = elem * b * lq * HIDDEN, elem * b * lk * HIDDEN
    product = 2 * b * HEADS * lq * lk * HEAD_DIM
    if not backward:
        nbytes = (2 * q_bytes + 2 * kv_bytes + elem * window + mask + seed
                  + lse)
        return nbytes, product * (3 if with_table else 2)
    nbytes = (3 * q_bytes + 4 * kv_bytes + mask + seed + lse
              + (elem + 4) * window)
    return nbytes, product * (8 if with_table else 5)


def layernorm_bwd_cost(rows, residual, affine, elem):
    """x [, residual] and dy read, dx written, [w read, dw and db
    written]; ~12 operations per element."""
    nbytes = elem * rows * HIDDEN * (4 if residual else 3) \
        + (12 * HIDDEN if affine else 0)
    return nbytes, 12 * rows * HIDDEN


def time_training_kernels(torch, kernels, gen, errs) -> list[dict]:
    """Phase 9.2: the three training kernels' device time at the training
    shapes (bf16, dropout 0.1) beside their plain versions, a PyTorch
    yardstick (SDPA with the bias as a float mask, its forward and its
    backward; the backward of F.layer_norm(x + r)) and the bound. The
    forward is also timed as the model pays for it, the seed draw and the
    kernel, beside ``torch.rand(B, H, Lq, Lk) >= p``, the mask draw the
    seed replaced; the LayerNorm backward's two kernels are split by the
    profiler."""
    record = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for case in TRAIN_ATTN_CASES[:2]:
        q, k, v, mask, tab = attention_inputs(torch, gen, case,
                                              torch.bfloat16)
        kw = dict(num_heads=HEADS, max_pos=case.max_pos)
        seed = draw_seed(torch, gen)
        keep = kernels.dropout_keep_plain(
            seed, (case.b, HEADS, case.lq, case.lk), DROPOUT)
        q4, k4, v4 = (t.view(case.b, -1, HEADS, HEAD_DIM).transpose(1, 2)
                      .detach().requires_grad_() for t in (q, k, v))
        bias = mask[:, None, None, :]
        if case.table:
            idx = (torch.arange(case.lq, device="cuda")[:, None]
                   - torch.arange(case.lk, device="cuda")[None, :]
                   + case.max_pos - 1)
            bias = bias + torch.einsum(
                "bhqd,qkd->bhqk", q4.detach().float(),
                tab.float()[idx]) / math.sqrt(HEAD_DIM)
        bias = bias.to(torch.bfloat16)
        out, lse = kernels.fused_attention_train(q, k, v, mask, tab, seed,
                                                 DROPOUT, **kw)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        fwd = (lambda: kernels.fused_attention_train(
            q, k, v, mask, tab, seed, DROPOUT, **kw))
        fwd_call = (lambda: kernels.fused_attention_train(
            q, k, v, mask, tab, draw_seed(torch, gen), DROPOUT, **kw))
        mask_draw = (lambda: torch.rand(
            (case.b, HEADS, case.lq, case.lk), generator=gen,
            device="cuda") >= DROPOUT)
        fwd_plain = (lambda: kernels.attention_train_plain(
            q, k, v, mask, tab, keep, DROPOUT, **kw))
        bwd = (lambda: kernels.attention_backward(
            dout, q, k, v, lse, mask, tab, seed, DROPOUT, **kw))
        bwd_plain = (lambda: kernels.attention_backward_plain(
            dout, q, k, v, lse, mask, tab, keep, DROPOUT, **kw))
        lib_out = sdpa(q4, k4, v4, attn_mask=bias, dropout_p=DROPOUT)
        dout4 = dout.view(case.b, -1, HEADS, HEAD_DIM).transpose(1, 2)
        lib_fwd = (lambda: sdpa(q4.detach(), k4.detach(), v4.detach(),
                                attn_mask=bias, dropout_p=DROPOUT))
        lib_bwd = (lambda: torch.autograd.grad(
            lib_out, (q4, k4, v4), dout4, retain_graph=True))
        for name, fn, plain, lib, backward in (
                ("fused_attention_train", fwd, fwd_plain, lib_fwd, False),
                ("attention_backward", bwd, bwd_plain, lib_bwd, True)):
            ms, host = time_call(torch, fn, iters=20)
            plain_ms, _ = time_call(torch, plain, iters=3, reps=3)
            lib_ms, _ = time_call(torch, lib, iters=20)
            nbytes, ops = attention_train_cost(case.b, case.lq, case.lk,
                                               case.table, 2, backward)
            b_ms, b_by = bound(nbytes, ops, "bfloat16")
            extra = {}
            if not backward:
                extra["call_ms"], _ = time_call(torch, fwd_call, iters=20)
                extra["mask_draw_ms"], _ = time_call(torch, mask_draw,
                                                     iters=20)
            print(f"  {name} {case.label}: kernel {ms * 1e3:.2f} us (host "
                  f"{host * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
                  f"sdpa {'backward' if backward else 'forward'} "
                  f"{lib_ms * 1e3:.2f} us ({ms / lib_ms:.2f}x), bound "
                  f"{b_ms * 1e3:.2f} us by {b_by} ({nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} Gop)", flush=True)
            if not backward:
                print(f"  {name} {case.label} as the model calls it (seed "
                      f"draw + kernel): {extra['call_ms'] * 1e3:.2f} us; the "
                      f"keep-mask draw it replaced, torch.rand >= p: "
                      f"{extra['mask_draw_ms'] * 1e3:.2f} us", flush=True)
            record.append(dict(
                name=name, route="cuda",
                source=("e3diff_tpu_torch/csrc/attention_backward.cu"
                        if backward else "e3diff_tpu_torch/csrc/attention.cu"),
                replaces="e3diff_tpu/ops/pallas_kernels.py:110",
                launches=0, max_abs_err=errs[name, case.label], ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=f"{case.label} bf16 p={DROPOUT}",
                **extra))
    for rows in TRAIN_LN_ROWS[:1]:
        x, w, b, res, eps = ln_inputs(torch, gen, rows, HIDDEN,
                                      torch.bfloat16, True, True)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        xl, rl = (t.detach().requires_grad_() for t in (x, res))
        wl, bl = (t.to(x.dtype).requires_grad_() for t in (w, b))
        lib_y = torch.nn.functional.layer_norm(xl + rl, (HIDDEN,), wl, bl,
                                               eps)
        ms, host = time_call(torch, lambda: kernels.layernorm_backward(
            dy, x, w, b, res, eps=eps), iters=50)
        plain_ms, _ = time_call(torch, lambda: kernels.layernorm_backward_plain(
            dy, x, w, b, res, eps=eps), iters=10)
        lib_ms, _ = time_call(torch, lambda: torch.autograd.grad(
            lib_y, (xl, rl, wl, bl), dy, retain_graph=True), iters=50)
        nbytes, ops = layernorm_bwd_cost(rows, True, True, 2)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        label = f"{rows}x{HIDDEN} +residual +affine"
        print(f"  layernorm_backward {label}: whole call {ms * 1e3:.2f} us "
              f"(host {host * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, "
              f"F.layer_norm(x + r) backward {lib_ms * 1e3:.2f} us "
              f"({ms / lib_ms:.2f}x), bound {b_ms * 1e3:.2f} us by {b_by} "
              f"({nbytes / 1e6:.1f} MB)", flush=True)
        split = kernel_split(torch, lambda: kernels.layernorm_backward(
            dy, x, w, b, res, eps=eps), n=50)
        for key, us in split.items():
            print(f"    {key}: {us:.2f} us a call (profiler)", flush=True)
        record.append(dict(
            name="layernorm_backward", route="cuda",
            source="e3diff_tpu_torch/csrc/layernorm_backward.cu",
            replaces="e3diff_tpu/ops/pallas_kernels.py:168",
            launches=0, max_abs_err=errs["layernorm_backward", rows], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=f"{label} bf16"))
    return record


# exact launches of one forward and backward of a train step: every
# attention core and LayerNorm of the forward (phases 6 and 8 count the
# same calls) through the training forward kernels, then each one's
# backward kernel; an eval step launches the inference kernels alone
PER_TRAIN_STEP = {
    "structure": {"fused_attention_train": 38, "fused_layernorm": 70,
                  "attention_backward": 38, "layernorm_backward": 70},
    "sequence": {"fused_attention_train": 15, "fused_layernorm": 32,
                 "attention_backward": 15, "layernorm_backward": 32}}
PER_EVAL_STEP = {"structure": {"fused_attention": 38, "fused_layernorm": 70},
                 "sequence": {"fused_attention": 15, "fused_layernorm": 32}}
# and one optimizer update a step, whatever its microbatches: clipping and
# AdamW in one launch (ops/kernels.py::adamw_update; both models' lists
# fit one launch's tensor table)
PER_UPDATE = {"adamw_update": 1}
TRAIN_STEPS = 20
TRAIN_WARMUP = 2            # steps left out of the step-time median
# One step through the kernels against the same step through the plain
# versions: dropout 0, the same weights, batch and draws. A gradient's
# error is its L2 norm relative to the gradient's norm plus 1e-3 of the
# largest parameter gradient norm: the key biases' gradients are zero in
# exact arithmetic (a softmax does not see a constant added to a row) and
# both paths give rounding noise there.
# - f32: both paths sum f32 products in other orders (~1e-6 relative per
#   op) through the forward and back: the loss to 1e-4 relative, each
#   gradient to 1e-3 of the plain path's.
# - bf16: the activations and the gradients between layers are rounded
#   to bf16 (2^-8 relative) in both paths, after sums in other orders, and
#   the flips pass through every layer, so neither bf16 path is the
#   reference: both are held to the f32 plain path's gradient, and the
#   kernel path's error must be at most twice the plain path's own plus
#   1e-3 (BF16_GRAD_FACTOR, BF16_GRAD_SLACK); the loss to 1e-2 relative of
#   the bf16 plain path's.
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
F32_GRAD_TOL = 1e-3
BF16_GRAD_FACTOR, BF16_GRAD_SLACK = 2.0, 1e-3


def train_step_launches(kind, accum: int = 1,
                        extra: dict[str, int] | None = None) -> dict[str, int]:
    """One train step's launches: ``accum`` forwards and backwards (each
    with the ``extra`` launches of remat), then one update."""
    extra = extra or {}
    return {**{k: accum * (n + extra.get(k, 0))
               for k, n in PER_TRAIN_STEP[kind].items()}, **PER_UPDATE}


def kernel_split(torch, fn, n: int) -> dict[str, float]:
    """Device us per call of each kernel that ``fn`` launches, from
    torch.profiler over n calls (after warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {kernel_name_of(e.key): getattr(e, "device_time_total", 0) / n
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_name_of(key: str) -> str:
    """A profiler key cut to its kernel's identifier and template
    arguments."""
    m = re.search(r"(\w+_kernel(<[^()]*>)?)", key)
    return m.group(1) if m else key[:70]


def train_batch(torch, cfg, gen, kind):
    """A batch of B=64 synthetic complexes padded to the preset's
    max_seq_len, on the card, and fixed draws for it (t and eps for the
    structure model, t in {0..T} and Gumbel noise for the sequence
    model)."""
    from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu_torch.data.prefetch import to_device
    from e3diff_tpu_torch.diffusion.d3pm import sample_gumbel
    from e3diff_tpu_torch.ops.angles import wrap_angle

    ds = LigandBindingSiteData(synthetic_complexes(n=TRAIN_B * 5 // 4, seed=8),
                               "train", cfg.max_seq_len, cfg.pocket_ext,
                               cfg.ligand_max_len)
    batch = to_device(next(ds.batches(TRAIN_B)), "cuda")
    check(tuple(batch["ligand_angles"].shape[:2]) == (TRAIN_B, TRAIN_L)
          and tuple(batch["receptor_angles"].shape[:2]) == (TRAIN_B, TRAIN_L),
          f"train batch shapes {batch['ligand_angles'].shape}")
    lig = (TRAIN_B, cfg.max_seq_len)
    if kind == "structure":
        draws = {"t": torch.randint(0, cfg.timesteps, (TRAIN_B,),
                                    generator=gen, device="cuda"),
                 "noise": wrap_angle(torch.randn(*lig, 8, generator=gen,
                                                 device="cuda"))}
    else:
        draws = {"t_int": torch.randint(0, cfg.timesteps + 1, (TRAIN_B,),
                                        generator=gen, device="cuda"),
                 "gumbel": sample_gumbel((*lig, 20), generator=gen,
                                         device="cuda")}
    return batch, draws


def grad_errors(torch, grads, ref):
    """Each parameter's ||g - ref|| over ||ref|| + 1e-3 max ||ref||."""
    norms = torch.stack([r.float().norm() for r in ref])
    diff = torch.stack([(g.float() - r.float()).norm()
                        for g, r in zip(grads, ref)])
    return diff / (norms + 1e-3 * norms.max())


def train_step_grads(torch, kernels, trainer, batch, draws, kind, dname):
    """One forward and backward of the loss at dropout 0 through the
    kernels, then through the plain versions (autograd of the plain
    forward): the kernel path's launches must be one train step's, and
    the two losses agree. Returns both gradients."""
    trainer.model.train()

    def loss_and_grads():
        loss, _ = trainer.loss(batch, **draws)
        return loss.detach().float(), torch.autograd.grad(
            loss, trainer.optimizer.params)

    kernels.reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    counts = launch_counts(kernels)
    with plain_versions(kernels):
        loss_p, grads_p = loss_and_grads()
    torch.cuda.synchronize()
    loss_rel = (abs(loss_k - loss_p) / abs(loss_p)).item()
    print(f"  {kind} {dname} step, kernels vs plain: loss {loss_k.item():.6f}"
          f" vs {loss_p.item():.6f} (rel {loss_rel:.2e}, tol "
          f"{TRAIN_LOSS_TOL[dname]:g}); launches {counts}", flush=True)
    check(bool(torch.isfinite(loss_k)) and loss_rel <= TRAIN_LOSS_TOL[dname],
          f"{kind} {dname}: loss differs from the plain path by {loss_rel}")
    check(counts == with_zeros(kernels, PER_TRAIN_STEP[kind]),
          f"{kind} {dname}: launches {counts} != {PER_TRAIN_STEP[kind]}")
    return grads_k, grads_p


def train_grad_check(torch, kernels, build, batch, draws, kind):
    """Phase 9.3: the gradients of one step through the kernels against
    the plain versions, f32 directly and bf16 through their distance from
    the f32 gradient (see the tolerances above TRAIN_LOSS_TOL). ``build(bf16)`` makes the
    trainer, the same seeded weights at dropout 0."""
    t = build(False)
    names = t.optimizer.names
    k32, p32 = train_step_grads(torch, kernels, t, batch, draws, kind,
                                "float32")
    del t
    rel = grad_errors(torch, k32, p32)
    worst = int(rel.argmax())
    print(f"  {kind} float32 gradients, kernels vs plain: worst relative L2 "
          f"{rel[worst].item():.2e} ({names[worst]}), median "
          f"{rel.median().item():.2e} over {len(rel)} parameters (tol "
          f"{F32_GRAD_TOL:g})", flush=True)
    check(bool((rel <= F32_GRAD_TOL).all()), f"{kind} float32: gradient of "
          f"{names[worst]} differs from the plain path by {rel[worst].item()}")
    del k32
    t = build(True)
    k16, p16 = train_step_grads(torch, kernels, t, batch, draws, kind,
                                "bfloat16")
    del t
    err_k, err_p = grad_errors(torch, k16, p32), grad_errors(torch, p16, p32)
    excess = err_k - BF16_GRAD_FACTOR * err_p
    worst = int(excess.argmax())
    direct = grad_errors(torch, k16, p16)
    print(f"  {kind} bfloat16 gradients against the f32 plain path: kernels "
          f"median {err_k.median().item():.2e}, worst "
          f"{err_k.max().item():.2e} ({names[int(err_k.argmax())]}); plain "
          f"median {err_p.median().item():.2e}, worst "
          f"{err_p.max().item():.2e} ({names[int(err_p.argmax())]}); "
          f"closest to the bound: {names[worst]} (kernels "
          f"{err_k[worst].item():.2e}, plain {err_p[worst].item():.2e}); "
          f"kernels vs bf16 plain directly: median "
          f"{direct.median().item():.2e}, worst {direct.max().item():.2e}",
          flush=True)
    check(bool((excess <= BF16_GRAD_SLACK).all()),
          f"{kind} bfloat16: gradient of {names[worst]} is "
          f"{err_k[worst].item()} from the f32 one, the plain path's "
          f"{err_p[worst].item()}")


def trainer_phase(torch, kernels, kind, gen) -> tuple[dict, dict]:
    """Phases 9.3-9.4 for one model at its preset's full width (B=64,
    length 128, bf16 compute, f32 master weights, dropout 0.1, AdamW):
    the gradient check in f32 and bf16, then TRAIN_STEPS train steps on a
    fixed batch with fixed draws (dropout draws from the trainer's
    generator), one eval step, and one step with accum_steps 2,
    cond_dropout 0.1 and an EMA. Returns the kernels' launches over the
    train steps and the step's timings."""
    import dataclasses

    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import (
        sequence_train_config,
        structure_train_config,
    )

    preset = (structure_train_config if kind == "structure"
              else sequence_train_config)
    # one epoch: Q12's warmup is int(0.1) = 0 epochs, so epoch 0 trains
    cfg = preset(max_epochs=1)
    batch, draws = train_batch(torch, cfg, gen, kind)
    train_grad_check(
        torch, kernels, lambda bf16: build_trainer(kind, dataclasses.replace(
            cfg, dropout_p=0.0, bf16=bf16), "cuda", 1), batch, draws, kind)
    torch.cuda.empty_cache()

    trainer = build_trainer(kind, cfg, "cuda", steps_per_epoch=10_000)
    n_params = sum(p.numel() for p in trainer.optimizer.params)
    check(trainer.optimizer.schedule(0) > 0, "epoch 0 has learning rate 0")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    losses, norms, secs = [], [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m = trainer.train_step(batch, **draws)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = launch_counts(kernels)
        check(counts == with_zeros(kernels, train_step_launches(kind)),
              f"{kind} train step: launches {counts}")
        for k, n in counts.items():
            totals[k] += n
        losses.append(m["train_loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated()
    kernels.reset_launch_counts()
    v = trainer.eval_step(batch, **draws)
    counts = launch_counts(kernels)
    check(counts == with_zeros(kernels, PER_EVAL_STEP[kind]),
          f"{kind} eval step: launches {counts}")
    check(all(math.isfinite(x.item()) for x in v.values()),
          f"{kind} eval step: not finite")
    step_s = statistics.median(secs[TRAIN_WARMUP:])
    print(f"  {kind} trainer, {n_params:,} parameters, B={TRAIN_B}, length "
          f"{cfg.max_seq_len}, {'bf16' if cfg.bf16 else 'f32'} compute, "
          f"dropout {cfg.dropout_p}: losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"  grad_norm {[round(x, 3) for x in norms]}; val_loss "
          f"{v['val_loss'].item():.4f}; launches per train step "
          f"{train_step_launches(kind)}, per eval step {PER_EVAL_STEP[kind]}")
    print(f"  {kind} train step: {step_s * 1e3:.1f} ms (median of "
          f"{TRAIN_STEPS - TRAIN_WARMUP} after {TRAIN_WARMUP} warm-up; "
          f"first {secs[0] * 1e3:.1f} ms), {TRAIN_B / step_s:.1f} samples/s,"
          f" max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    check(all(math.isfinite(x) for x in losses + norms),
          f"{kind}: a loss or grad_norm is not finite")
    first, last = (statistics.mean(losses[:5]), statistics.mean(losses[-5:]))
    check(last < first, f"{kind}: the loss did not fall ({first} -> {last})")
    del trainer
    torch.cuda.empty_cache()

    # one step with two interleaved microbatches, conditioning dropout and
    # an EMA: twice a forward and backward's launches, one update
    trainer = build_trainer(kind, dataclasses.replace(
        cfg, accum_steps=2, cond_dropout=0.1, ema_decay=0.999), "cuda", 1)
    kernels.reset_launch_counts()
    m = trainer.train_step(batch, **draws)
    counts = launch_counts(kernels)
    print(f"  {kind} step with accum_steps 2, cond_dropout 0.1, EMA: loss "
          f"{m['train_loss'].item():.4f}, grad_norm "
          f"{m['grad_norm'].item():.3f}, launches {counts}", flush=True)
    check(counts == with_zeros(kernels, train_step_launches(kind, 2)),
          f"{kind} accumulated step: launches {counts}")
    check(all(math.isfinite(x.item()) for x in m.values()),
          f"{kind} accumulated step: not finite")
    del trainer
    torch.cuda.empty_cache()
    if kind == "structure":
        reproducible_steps(torch, build_trainer, cfg, batch, draws, kind)
    return totals, {"ms_per_step": step_s * 1e3,
                    "samples_per_s": TRAIN_B / step_s,
                    "max_memory_allocated_gib": peak / 2**30}


def reproducible_steps(torch, build_trainer, cfg, batch, draws, kind,
                       n_steps: int = 3):
    """Two runs of ``n_steps`` train steps from one seed (weights, batch,
    draws and the trainer's dropout generator) end in the same weights, bit
    for bit: the table gradient is summed in a fixed order."""
    weights = []
    for _ in range(2):
        trainer = build_trainer(kind, cfg, "cuda", steps_per_epoch=10_000)
        for _ in range(n_steps):
            trainer.train_step(batch, **draws)
        weights.append({k: v.detach().clone()
                        for k, v in trainer.weights().items()})
        del trainer
        torch.cuda.empty_cache()
    differ = [k for k in weights[0] if not torch.equal(weights[0][k],
                                                       weights[1][k])]
    print(f"  {kind}: two {n_steps}-step runs from one seed, "
          f"{len(weights[0])} weight tensors, {len(differ)} differ "
          f"{differ[:3]}", flush=True)
    check(not differ, f"{kind}: two runs from one seed differ in {differ}")


def train_cli_phase(torch, kernels, run_root: Path):
    """Phase 9.5: both train CLIs at their presets, one epoch of synthetic
    complexes (one train and one validation batch of 64), into
    ``run_root`` (phase 11 prunes it); then DesignEngine.from_checkpoints
    on the two final artifacts serves a design batch, held to phase 8's
    checks."""
    from e3diff_tpu_torch.cli.train_sequence import main as train_sequence
    from e3diff_tpu_torch.cli.train_structure import main as train_structure
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record

    tmp = str(run_root)
    for kind, cli in (("structure", train_structure),
                      ("sequence", train_sequence)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = cli(["--synthetic", "--synthetic_n", str(TRAIN_B * 5 // 4),
                    "--max_epochs", "1", "--ema_decay", "0.999",
                    "--ckpt_dir", f"{tmp}/{kind}"])
        secs = time.perf_counter() - t0
        counts = launch_counts(kernels)
        # one batch: the step's capture (with its warm-up steps) and one
        # replay, then the eval step's capture (with its warm-up steps)
        # and one replay
        want = sum_counts(train_capture_launches(kernels, kind),
                          eval_capture_launches(kernels, kind))
        print(f"  cli train_{kind}: {secs:.1f} s including the model "
              f"build and the checkpoints; history {hist}; launches "
              f"{counts}", flush=True)
        check(len(hist) == 1 and all(
            math.isfinite(hist[0][k]) for k in
            ("train_loss", "val_loss", "grad_norm")),
            f"cli train_{kind}: history {hist}")
        check(counts == want, f"cli train_{kind}: launches {counts} != "
              f"{want}")
        for slot in ("config.json", "last.pt", "best_val_model.pt",
                     "final.pt", "final_ema.pt", "history.json"):
            check(Path(tmp, kind, slot).is_file(),
                  f"cli train_{kind} wrote no {slot}")
    eng = DesignEngine.from_checkpoints(
        f"{tmp}/structure/final.pt", f"{tmp}/sequence/final.pt",
        transition="blosum", device="cuda", batch_size=DESIGN_BATCH,
        sampler="ddim", ddim_steps=DDIM_STEPS)
    requests = pocket_requests(DESIGN_BATCH, seed=9)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.design_records([pocket_record(*r) for r in requests],
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(10))
    secs = time.perf_counter() - t0
    counts = launch_counts(kernels)
    want = sum_counts(captured(kernels, STRUCT_CALLS),
                      captured(kernels, SEQ_CALLS))
    print(f"  DesignEngine from the trained final.pt files: {DESIGN_BATCH} "
          f"designs in {secs:.3f} s, capture included, launches {counts}",
          flush=True)
    check(counts == want, f"trained engine: launches {counts} != {want}")
    check_designs(results, requests, "trained checkpoints")


# ---------------------------------------------------------------------------
# phase 12: the train step captured as one CUDA graph
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 20          # replays held to as many eager steps
PROFILED_STEPS = 3
CLI_EPOCHS = 2
# the CUDA kernels each training wrapper launches, by name (bf16: the mma
# kernels; f32: the others)
TRAIN_KERNEL_OF = {
    "attention_mma_kernel": "fused_attention_train",
    "attention_f32_kernel": "fused_attention_train",
    "attention_bwd_mma_kernel": "attention_backward",
    "attention_bwd_dq_kernel": "attention_backward",
    "layernorm_vec_kernel": "fused_layernorm",
    "layernorm_any_kernel": "fused_layernorm",
    "layernorm_bwd_vec_kernel": "layernorm_backward",
    "layernorm_bwd_any_kernel": "layernorm_backward",
    "adamw_kernel": "adamw_update",
}
# utils/profiling.py's PORT_KERNEL names the models' kernels; the
# optimizer's is looked for here
ADAMW_KERNEL = re.compile(r"\b(adamw_kernel)\b")


def train_capture_launches(kernels, kind, accum: int = 1) -> dict[str, int]:
    """The launches of capturing one train step: WARMUP_CALLS eager steps
    and the step under capture, each ``accum`` microbatches."""
    from e3diff_tpu_torch.sampling.graphs import WARMUP_CALLS

    return with_zeros(kernels, {
        k: (WARMUP_CALLS + 1) * n
        for k, n in train_step_launches(kind, accum).items()})


def eval_capture_launches(kernels, kind) -> dict[str, int]:
    """The launches of capturing one eval step: WARMUP_CALLS eager eval
    steps and the step under capture."""
    from e3diff_tpu_torch.sampling.graphs import WARMUP_CALLS

    return with_zeros(kernels, {k: (WARMUP_CALLS + 1) * n
                                for k, n in PER_EVAL_STEP[kind].items()})


def trace_train_kernels(trace, steps: int) -> dict[str, float]:
    """The training wrappers' kernels in a profiler trace, by name, per
    step."""
    from e3diff_tpu_torch.utils import profiling

    counts = dict.fromkeys(train_step_launches("structure"), 0.0)
    for name, info in profiling.device_op_totals(trace).items():
        m = profiling.PORT_KERNEL.search(name) or ADAMW_KERNEL.search(name)
        if m and m.group(1) in TRAIN_KERNEL_OF:
            counts[TRAIN_KERNEL_OF[m.group(1)]] += info["count"] / steps
    return counts


def trainer_state(trainer) -> list:
    """Every tensor a step updates: weights, moments, count, EMA."""
    opt = trainer.optimizer
    return [*opt.params, *opt.mu, *opt.nu, opt.count,
            *(trainer.ema or [])]


def timed_steps(torch, step, batch, n: int):
    """``n`` calls of ``step(batch)``, each synchronised: the losses and
    grad norms (read after each call, before the next: a replay rewrites
    them) and the seconds of each."""
    from e3diff_tpu_torch.utils.timing import device_timer

    losses, norms, secs = [], [], {}
    for i in range(n):
        with device_timer(i, secs, log_fn=None):
            m = step(batch)
        losses.append(m["train_loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, [secs[i] for i in range(n)]


def profiled_steps(torch, step, batch, out: Path, label: str,
                   flops: float | None = None):
    """A utils/timing.py::profiler_trace over PROFILED_STEPS calls and its
    utils/profiling.py digest (``flops``: the GEMMs' operations of the
    calls, where the trace has no host GEMM ops), printed; returns
    (digest, trace)."""
    from e3diff_tpu_torch.utils import profiling
    from e3diff_tpu_torch.utils.timing import profiler_trace

    with profiler_trace(str(out / label)) as path:
        for _ in range(PROFILED_STEPS):
            step(batch)
    trace = profiling.load_trace(path)
    d = profiling.digest(trace, PROFILED_STEPS, flops)
    print(f"  {label}: device idle {100 * d['device_idle_share']:.1f}% of "
          f"the trace's window; {d['roofline']}", flush=True)
    print("    buckets, ms a step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in d["buckets"].items()), flush=True)
    for name, bucket, ms, calls, us in profiling.top_ops(
            profiling.device_op_totals(trace), n=6, steps=PROFILED_STEPS):
        print(f"    {ms:8.3f} ms {calls:6.0f}x {us:8.2f} us  [{bucket}] "
              f"{name[:80]}")
    return d, trace


def state_name(names: list[str], i: int) -> str:
    """The ``i``-th tensor of trainer_state by name."""
    n = len(names)
    if i == 3 * n:
        return "count"
    part = ("param", "mu", "nu", "count", "ema")[i // n if i < 3 * n else 4]
    return f"{part} {names[(i - (1 if i > 3 * n else 0)) % n]}"


def train_run(torch, kernels, build, batch, draws, n, *, capture: bool,
              profile: Path | None = None, label: str = ""):
    """``n`` steps of a trainer from ``build()`` on ``batch`` (with the
    injected ``draws``): eager, or replays of its captured step. Returns
    the losses, grad norms and seconds of each step, the peak memory from
    the build on (a capture's included: its copy of the state and its
    warm-up steps) and the memory reserved after the steps, the final
    state copied to the host and the generator's, and for a capture its
    seconds, its launches by name, its peak memory and the kernels'
    launches from the capture to the last replay; with ``profile``, the
    digest of
    PROFILED_STEPS more steps and the training kernels a step ran by name
    in their trace."""
    trainer = build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = {"names": trainer.optimizer.names}
    if capture:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        step = trainer.capture(batch, **draws)
        torch.cuda.synchronize()
        r["capture_s"] = time.perf_counter() - t0
        r["launches"] = step.launches
        r["capture_peak"] = torch.cuda.max_memory_allocated()
        r["gemm_flops"] = step.gemm_flops

        def call(b):
            return step({**b, **draws})
    else:
        def call(b):
            return trainer.train_step(b, **draws)
    r["losses"], r["norms"], r["secs"] = timed_steps(torch, call, batch, n)
    r["counts"] = launch_counts(kernels)
    # a replay allocates nothing: its graph's pool was allocated at the
    # capture, and stays reserved
    r["peak"] = torch.cuda.max_memory_allocated()
    r["reserved"] = torch.cuda.memory_reserved()
    r["state"] = [t.detach().cpu() for t in trainer_state(trainer)]
    r["generator"] = trainer.generator.get_state()
    if profile is not None:
        r["digest"], trace = profiled_steps(
            torch, call, batch, profile, label,
            PROFILED_STEPS * step.gemm_flops if capture else None)
        r["ran"] = trace_train_kernels(trace, PROFILED_STEPS)
        if not capture:
            from e3diff_tpu_torch.utils import profiling
            r["gemm_flops"] = profiling.gemm_flops(trace) / PROFILED_STEPS
    if capture:
        step.close()
    return r


def compare_runs(torch, label, a, b) -> list[str]:
    """What differs, bit for bit, between two train_run results."""
    differ = []
    if a["losses"] != b["losses"]:
        differ.append(f"losses {a['losses']} != {b['losses']}")
    if a["norms"] != b["norms"]:
        differ.append(f"grad norms {a['norms']} != {b['norms']}")
    bad = [i for i, (x, y) in enumerate(zip(a["state"], b["state"]))
           if not torch.equal(x, y)]
    if bad or len(a["state"]) != len(b["state"]):
        differ.append(f"{len(bad)} of {len(a['state'])} state tensors, "
                      "first " + ", ".join(state_name(a["names"], i)
                                           for i in bad[:3]))
    print(f"  {label}: {'equal bit for bit' if not differ else differ}",
          flush=True)
    return differ


def check_capture(kernels, kind, r, accum: int = 1):
    """The capture launched one step's kernels (``accum`` microbatches),
    and with its warm-up steps and the replays, as many again
    WARMUP_CALLS times: replays launch nothing from Python."""
    want = with_zeros(kernels, train_step_launches(kind, accum))
    check(r["launches"] == want, f"{kind}: the capture launched "
          f"{r['launches']}, not {want}")
    check(r["counts"] == train_capture_launches(kernels, kind, accum),
          f"{kind}: capture, warm-up and replays launched {r['counts']}")


def captured_train_phase(torch, kernels, kind, gen, out: Path):
    """Phase 12 for one model at its preset's full width (B=64, length
    128, bf16 compute, f32 master weights, dropout 0.1, AdamW): 20 replays
    of the captured step against 20 eager steps from one seed (weights,
    batch, generator; every draw from the generator), bit for bit; the
    launches at capture and by kernel name in profiled replays; the
    times, peak memory and digests of both; and 2 captured steps with
    accum_steps 2, cond_dropout 0.1 and an EMA against 2 eager ones.
    Returns the kernels' launches of the main path (the capture with its
    warm-up, and the replays) and the timings."""
    import dataclasses

    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import (
        sequence_train_config,
        structure_train_config,
    )

    preset = (structure_train_config if kind == "structure"
              else sequence_train_config)
    cfg = preset(max_epochs=1)
    batch, injected = train_batch(torch, cfg, gen, kind)

    def build(c=cfg):
        return build_trainer(kind, c, "cuda", steps_per_epoch=10_000)

    runs = {}
    for mode in ("eager", "captured"):
        runs[mode] = train_run(torch, kernels, build, batch, {},
                               CAPTURE_STEPS, capture=mode == "captured",
                               profile=out, label=f"{kind}_train_{mode}")
        torch.cuda.empty_cache()
    cap = runs["captured"]
    differ = compare_runs(
        torch, f"{kind}: {CAPTURE_STEPS} replays against {CAPTURE_STEPS} "
        f"eager steps, dropout {cfg.dropout_p}, every draw from the "
        f"generator", runs["eager"], cap)
    print(f"  {kind} losses {[round(x, 4) for x in cap['losses']]}",
          flush=True)
    if differ:
        # do the draws make the difference? The same comparison at dropout
        # 0 with t and the noise injected
        c0 = dataclasses.replace(cfg, dropout_p=0.0)
        r0 = [train_run(torch, kernels, lambda: build(c0), batch, injected,
                        CAPTURE_STEPS, capture=c) for c in (False, True)]
        differ0 = compare_runs(torch, f"{kind}: dropout 0, draws injected",
                               *r0)
        fail(f"{kind}: the captured step differs from the eager one "
             f"({differ}); at dropout 0 with the draws injected: "
             f"{differ0 or 'equal'}")
    check_capture(kernels, kind, cap)
    check(all(math.isfinite(x) for x in cap["losses"] + cap["norms"]),
          f"{kind}: a loss or grad norm is not finite")
    want = {k: float(train_step_launches(kind).get(k, 0))
            for k in cap["ran"]}
    print(f"  {kind}: a profiled replay ran {cap['ran']} (captured "
          f"{ {k: v for k, v in cap['launches'].items() if v} })",
          flush=True)
    check(cap["ran"] == want, f"{kind}: a replay ran {cap['ran']}, not "
          f"{want}")
    # the GEMMs' operations of a step: counted in the capture's first
    # warm-up call (a replay launches no op from the host), and from the
    # eager steps' traced GEMM shapes
    flops = {m: r["gemm_flops"] for m, r in runs.items()}
    print(f"  {kind}: GEMM operations a step {flops}", flush=True)
    check(flops["captured"] == flops["eager"] > 0,
          f"{kind}: the capture counted {flops['captured']} GEMM operations "
          f"a step, the eager steps' trace {flops['eager']}")
    timing = {"capture_s": cap["capture_s"]}
    for mode, r in runs.items():
        s = statistics.median(r["secs"][TRAIN_WARMUP:])
        roof = r["digest"]["roofline"]
        tflops = roof["gemm_tflops_per_s"]
        t = timing[mode] = {
            "ms_per_step": s * 1e3, "samples_per_s": TRAIN_B / s,
            "max_memory_allocated_gib": r["peak"] / 2**30,
            "memory_reserved_gib": r["reserved"] / 2**30,
            "device_idle_share": r["digest"]["device_idle_share"],
            "device_ms_per_step": roof["ms_per_step"],
            "gemm_ms_per_step": roof["gemm_ms_per_step"],
            "gemm_tflops_per_s": tflops}
        print(f"  {kind} {mode} train step: {t['ms_per_step']:.2f} ms "
              f"(median of {CAPTURE_STEPS - TRAIN_WARMUP} after "
              f"{TRAIN_WARMUP}), {t['samples_per_s']:.1f} samples/s, "
              f"max_memory_allocated {t['max_memory_allocated_gib']:.2f} "
              f"GiB, memory_reserved {t['memory_reserved_gib']:.2f} GiB; "
              f"profiled: device {t['device_ms_per_step']:.2f} ms a "
              f"step, idle {100 * t['device_idle_share']:.1f}%, GEMMs "
              f"{t['gemm_ms_per_step']:.2f} ms at "
              f"{t['gemm_tflops_per_s'] or float('nan'):.1f} TFLOP/s",
              flush=True)
    print(f"  {kind}: the capture (its warm-up steps and the capture) took "
          f"{cap['capture_s']:.2f} s, max_memory_allocated "
          f"{cap['capture_peak'] / 2**30:.2f} GiB", flush=True)

    # accumulated microbatches, conditioning dropout and an EMA
    c2 = dataclasses.replace(cfg, accum_steps=2, cond_dropout=0.1,
                             ema_decay=0.999)
    r2 = [train_run(torch, kernels, lambda: build(c2), batch, {}, 2,
                    capture=c) for c in (False, True)]
    torch.cuda.empty_cache()
    differ2 = compare_runs(
        torch, f"{kind}: 2 captured steps with accum_steps 2, cond_dropout "
        f"0.1, EMA against 2 eager steps", *r2)
    check(not differ2, f"{kind} accumulated step: {differ2}")
    check_capture(kernels, kind, r2[1], accum=2)
    return cap["counts"], timing


def file_hashes(run_dir: Path) -> dict[str, str]:
    import hashlib

    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(run_dir.glob("*.pt"))}


def train_cli_capture_phase(torch, kernels, run_root: Path):
    """Phase 12.3: the structure train CLI (captured on the card, with an
    EMA) for 2 epochs with --profile_dir, snapshot saves on: the digest
    printed, the trace written; 1 epoch then a resume for 1 more ends in
    the same final.pt; the same 2 epochs under E3DIFF_SNAPSHOT_SAVES=0
    write the same files. Returns the peak memory of the first run, its
    capture and up to two snapshots of the state included."""
    import os

    from e3diff_tpu_torch.cli.train_structure import main as train_structure

    args = ["--synthetic", "--synthetic_n", str(TRAIN_B * 5 // 2),
            "--ema_decay", "0.999"]
    runs = {}

    def cli(name, epochs, extra=(), env=None):
        d = run_root / name
        log = io.StringIO()
        old = os.environ.get("E3DIFF_SNAPSHOT_SAVES")
        if env is not None:
            os.environ["E3DIFF_SNAPSHOT_SAVES"] = env
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                hist = train_structure(args + ["--max_epochs", str(epochs),
                                               "--ckpt_dir", str(d),
                                               *extra])
        finally:
            if old is None:
                os.environ.pop("E3DIFF_SNAPSHOT_SAVES", None)
            else:
                os.environ["E3DIFF_SNAPSHOT_SAVES"] = old
        secs = time.perf_counter() - t0
        print(f"  cli {name}: {secs:.1f} s, history "
              f"{[{k: round(r[k], 4) for k in ('epoch', 'train_loss', 'val_loss', 'steps_per_sec', 'ckpt_wait_seconds')} for r in hist]}",
              flush=True)
        return log.getvalue()

    profile = run_root / "profile"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    text = cli("snapshot", CLI_EPOCHS, ["--profile_dir", str(profile)])
    peak = torch.cuda.max_memory_allocated()
    digest = [ln for ln in text.splitlines() if ln.startswith("profile")]
    for ln in digest:
        print(f"  {ln[:300]}")
    check(len(digest) == 2 and "device buckets" in digest[0]
          and (profile / "trace.json").is_file(),
          "cli --profile_dir printed no digest or wrote no trace")
    check("'gemm_tflops_per_s': None" not in digest[1],
          "cli --profile_dir: the digest has no GEMM TFLOP/s")
    print(f"  cli snapshot run: max_memory_allocated {peak / 2**30:.2f} GiB "
          f"(a step, its captured graph and up to two state snapshots)",
          flush=True)
    runs["snapshot"] = file_hashes(run_root / "snapshot")
    shutil.rmtree(profile)
    cli("resumed", 1)
    text = cli("resumed", CLI_EPOCHS)
    check("resumed from epoch 1" in text, "the second call did not resume")
    runs["resumed"] = file_hashes(run_root / "resumed")
    shutil.rmtree(run_root / "resumed")
    cli("synchronous", CLI_EPOCHS, env="0")
    runs["synchronous"] = file_hashes(run_root / "synchronous")
    shutil.rmtree(run_root / "synchronous")
    shutil.rmtree(run_root / "snapshot")
    print(f"  sha256 of the files: {json.dumps(runs)}", flush=True)
    check(runs["resumed"]["final.pt"] == runs["snapshot"]["final.pt"],
          "1 epoch + resume ends in another final.pt than 2 epochs")
    check(runs["synchronous"] == runs["snapshot"],
          "synchronous saves wrote other files than snapshot saves")
    return peak


# ---------------------------------------------------------------------------
# phase 12 (g): remat; (h): the captured eval step
# ---------------------------------------------------------------------------

REMAT_STEPS = 3
# a validation set whose last batch is zero-padded: 2 full batches of
# TRAIN_B and one of EVAL_LAST valid rows
EVAL_LAST = 17
EVAL_REPS = 3               # passes over the validation batches timed


def remat_extra(cfg, kind) -> dict[str, int]:
    """The launches a remat step adds to PER_TRAIN_STEP: the backward runs
    each stack layer's forward again, its attention cores through the
    training forward kernel and its LayerNorms through the LayerNorm
    kernel. The structure model has an encoder of num_hidden_layers
    self-attention layers (1 core and 2 LayerNorms each) and a decoder of
    as many with cross-attention (2 cores, 3 LayerNorms); the sequence
    model that decoder alone (its SELayers are not stack layers)."""
    n = cfg.num_hidden_layers
    enc = n if kind == "structure" else 0
    return {"fused_attention_train": enc + 2 * n,
            "fused_layernorm": 2 * enc + 3 * n}


def remat_phase(torch, kernels, gen, card) -> tuple[dict, dict]:
    """Phase 12 (g): the structure trainer at its preset (B=64, length
    128, bf16, dropout 0.1) from one seed, REMAT_STEPS eager steps and as
    many replays of its captured step at remat none, layer and dots: every
    run's losses, grad norms, weights, moments, count and generator state
    equal the eager none run's bit for bit; each remat step's launches
    against train_step_launches with ``remat_extra``; ms a step and
    max_memory_allocated of each. Then one sequence-trainer step at
    layer against none, bit for bit. Returns the launches of these runs
    and the numbers."""
    import dataclasses

    from e3diff_tpu_torch.sampling.graphs import WARMUP_CALLS
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import (
        sequence_train_config,
        structure_train_config,
    )

    total = with_zeros(kernels, {})
    numbers = {}
    for kind, preset, modes, n in (
            ("structure", structure_train_config, ("eager", "captured"),
             REMAT_STEPS),
            ("sequence", sequence_train_config, ("eager",), 1)):
        cfg = preset(max_epochs=1)
        batch, _ = train_batch(torch, cfg, gen, kind)
        extra = remat_extra(cfg, kind)
        print(f"  {kind}: a remat step launches {extra} more than "
              f"{PER_TRAIN_STEP[kind]} ({cfg.num_hidden_layers} layers a "
              f"stack)", flush=True)
        ref = None
        for remat in ("none", "layer", "dots") if kind == "structure" \
                else ("none", "layer"):
            c = dataclasses.replace(cfg, remat=remat)
            step = train_step_launches(
                kind, extra=extra if remat != "none" else None)
            for mode in modes:
                kernels.reset_launch_counts()
                r = train_run(torch, kernels, lambda: build_trainer(
                    kind, c, "cuda", steps_per_epoch=10_000), batch, {}, n,
                    capture=mode == "captured")
                torch.cuda.empty_cache()
                total = sum_counts(total, r["counts"])
                if mode == "captured":
                    check(r["launches"] == with_zeros(kernels, step),
                          f"{kind} remat {remat}: the capture launched "
                          f"{r['launches']}, not {step}")
                    want = with_zeros(kernels, {
                        k: (WARMUP_CALLS + 1) * v for k, v in step.items()})
                else:
                    want = with_zeros(kernels, {k: n * v
                                                for k, v in step.items()})
                check(r["counts"] == want, f"{kind} remat {remat} {mode}: "
                      f"launches {r['counts']}, not {want}")
                label = f"{kind} remat {remat} {mode}"
                if ref is None:
                    ref = r
                else:
                    differ = compare_runs(torch, f"{label} against none "
                                          "eager", ref, r)
                    if not torch.equal(r["generator"], ref["generator"]):
                        differ.append("the generator's state")
                    check(not differ, f"{label}: {differ}")
                ms = statistics.median(r["secs"]) * 1e3
                numbers[label] = {
                    "ms_per_step": ms,
                    "max_memory_allocated_gib": r["peak"] / 2**30}
                print(f"  {label}: {ms:.2f} ms a step (median of {n}), "
                      f"max_memory_allocated {r['peak'] / 2**30:.2f} GiB"
                      + (f" (the capture alone "
                         f"{r['capture_peak'] / 2**30:.2f} GiB)"
                         if mode == "captured" else "")
                      + f"; launches {r['counts']}", flush=True)
                if r is not ref:
                    del r
    print(f"  {card}")
    return total, numbers


def eval_batches(torch, cfg):
    """A validation set of 2 TRAIN_B + EVAL_LAST synthetic complexes as
    the loop batches it: three batches of TRAIN_B rows, the last one
    zero-padded (num_valid EVAL_LAST), on the card."""
    from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu_torch.data.prefetch import to_device

    ds = LigandBindingSiteData(
        synthetic_complexes(n=2 * TRAIN_B + EVAL_LAST, seed=12), None,
        cfg.max_seq_len, cfg.pocket_ext, cfg.ligand_max_len)
    raw = list(ds.batches(TRAIN_B))
    check([int(b["num_valid"]) for b in raw] == [TRAIN_B, TRAIN_B,
                                                  EVAL_LAST],
          f"validation batches of {[int(b['num_valid']) for b in raw]}")
    return [to_device(b, "cuda") for b in raw]


def eval_sequence(torch, trainer, train, evaluate, batch, val):
    """A train step, two passes of eval steps over ``val`` and a train
    step, read to the host after each call (a replay rewrites its
    metrics): the values, the epoch means of each pass through the loop's
    MetricSums, and the trainer's final state with its generator."""
    from e3diff_tpu_torch.training.loop import MetricSums

    out = {"train": [], "eval": [], "means": []}
    for phase_ in ("train", "eval", "eval", "train"):
        if phase_ == "train":
            m = train(batch)
            out["train"].append({k: v.item() for k, v in m.items()})
            continue
        sums = MetricSums()
        for b in val:
            m = evaluate(b)
            sums.add(m)
            out["eval"].append({k: v.item() for k, v in m.items()})
        out["means"].append(sums.means())
    out["state"] = [t.detach().cpu() for t in trainer_state(trainer)]
    out["state"].append(trainer.generator.get_state())
    return out


def eval_capture_phase(torch, kernels, gen, card) -> tuple[dict, dict]:
    """Phase 12 (h): for both trainers at their presets, over a validation
    set whose last batch is zero-padded: captured eval metrics against
    eager eval_step's bit for bit, batch by batch and in the loop's epoch
    means; a train step, two eval passes and a train step, captured
    against eager, bit for bit (the second train step's loss checks the
    generator's position after eval); eval ms a batch eager and captured,
    and the number of eval graphs. Returns the launches of both runs (the
    timing passes left out) and the numbers."""
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import (
        sequence_train_config,
        structure_train_config,
    )

    total = with_zeros(kernels, {})
    numbers = {}
    for kind, preset in (("structure", structure_train_config),
                         ("sequence", sequence_train_config)):
        cfg = preset(max_epochs=1)
        batch, _ = train_batch(torch, cfg, gen, kind)
        val = eval_batches(torch, cfg)
        runs = {}
        for mode in ("eager", "captured"):
            trainer = build_trainer(kind, cfg, "cuda",
                                    steps_per_epoch=10_000)
            kernels.reset_launch_counts()
            if mode == "eager":
                train, evaluate = trainer.train_step, trainer.eval_step
                graphs = {}
            else:
                pool = torch.cuda.graph_pool_handle()
                step = trainer.capture(batch, pool=pool)
                graphs = {}
                for b in val:   # one eval graph per batch shape
                    key = tuple((k, tuple(v.shape)) for k, v in b.items())
                    if key not in graphs:
                        graphs[key] = trainer.capture_eval(b, pool=pool)
                    check(graphs[key].launches == with_zeros(
                        kernels, PER_EVAL_STEP[kind]),
                        f"{kind}: the eval capture launched "
                        f"{graphs[key].launches}")

                def train(b):
                    return step(b)

                def evaluate(b):
                    return graphs[tuple((k, tuple(v.shape))
                                        for k, v in b.items())](b)
            runs[mode] = eval_sequence(torch, trainer, train, evaluate,
                                       batch, val)
            counts = launch_counts(kernels)
            total = sum_counts(total, counts)
            if mode == "eager":   # 2 train steps, 2 passes of eval steps
                want = {k: 2 * train_step_launches(kind).get(k, 0)
                        + 2 * len(val) * PER_EVAL_STEP[kind].get(k, 0)
                        for k in counts}
            else:   # the captures with their warm-ups; replays launch none
                want = sum_counts(train_capture_launches(kernels, kind),
                                  *(eval_capture_launches(kernels, kind)
                                    for _ in graphs))
            check(counts == want, f"{kind} eval {mode}: launches {counts}, "
                  f"not {want}")
            # eval ms a batch: EVAL_REPS passes over the batches, each
            # ended by a synchronize
            secs = []
            for _ in range(EVAL_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in val:
                    evaluate(b)
                torch.cuda.synchronize()
                secs.append((time.perf_counter() - t0) / len(val))
            ms = statistics.median(secs) * 1e3
            numbers[f"{kind} eval {mode}"] = {
                "ms_per_batch": ms, "graphs": len(graphs)}
            print(f"  {kind} eval {mode}: {ms:.2f} ms a batch of {TRAIN_B} "
                  f"(median of {EVAL_REPS} passes over {len(val)} "
                  f"batches), {len(graphs)} eval graphs; launches {counts}",
                  flush=True)
            if mode == "captured":
                step.close()
                for g in graphs.values():
                    g.close()
            del trainer
            torch.cuda.empty_cache()
        e, c = runs["eager"], runs["captured"]
        for part in ("train", "eval", "means"):
            check(e[part] == c[part], f"{kind}: captured {part} metrics "
                  f"{c[part]} != eager {e[part]}")
        bad = [i for i, (x, y) in enumerate(zip(e["state"], c["state"]))
               if not torch.equal(x, y)]
        check(not bad, f"{kind}: {len(bad)} state tensors differ after "
              "train, eval, eval, train (the generator's is the last)")
        print(f"  {kind}: train step, 2 eval passes over {len(val)} batches "
              f"(the last {EVAL_LAST} rows and padding), train step: "
              f"captured equal to eager bit for bit (val_loss means "
              f"{[round(m['val_loss'], 5) for m in c['means']]}, second "
              f"train loss {c['train'][1]['train_loss']:.6f})", flush=True)
    print(f"  {card}")
    return total, numbers


# ---------------------------------------------------------------------------
# phase 12 (i): clipping and AdamW in one pass
# ---------------------------------------------------------------------------

# the gradients' global norm at each of a case's updates, against
# grad_clip 1: the clip taken, left, taken
ADAMW_NORMS = (5.0, 0.5, 5.0)
ADAMW_CASES = [(mu, wd) for mu in ("f32", "bf16") for wd in (0.1, 0.0)]
# an edge list: tails off the kernel's 4-wide vectors and off a chunk
# (ops/kernels.py::ADAMW_CHUNK, 4096),
# and more tensors than one launch takes (small ones)
ADAMW_EDGE_SIZES = [1, 3, 768, 768 * 1024, 2 * 4096 + 5]
ADAMW_MANY = 1100
# bytes an element: read g, p, mu, nu, write p, mu, nu (f32 mu)
ADAMW_BYTES = 28


def adamw_param_shapes(torch, kind) -> list[tuple]:
    """The shapes of the ``kind`` trainer's parameters at its preset (the
    train cells' lists)."""
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import (
        sequence_train_config,
        structure_train_config,
    )

    preset = (structure_train_config if kind == "structure"
              else sequence_train_config)
    trainer = build_trainer(kind, preset(max_epochs=1), "cuda", 1)
    shapes = [tuple(p.shape) for p in trainer.optimizer.params]
    del trainer
    torch.cuda.empty_cache()
    return shapes


def adamw_pair(torch, shapes, mu_dtype: str, weight_decay: float, gen):
    """Two AdamW (grad_clip 1, lr 5e-5 from the first step) over equal
    copies of seeded parameters of ``shapes``."""
    from e3diff_tpu_torch.training.optim import AdamW

    base = [torch.randn(s, generator=gen, device="cuda") * 0.02
            for s in shapes]
    return [AdamW({str(i): t.clone() for i, t in enumerate(base)},
                  base_lr=5e-5, weight_decay=weight_decay, max_epochs=1,
                  steps_per_epoch=1000, grad_clip=1.0, mu_dtype=mu_dtype)
            for _ in range(2)]


def adamw_grads(torch, shapes, norm: float, gen, flat: bool = False):
    """Seeded gradients of ``shapes`` scaled to the global ``norm``;
    ``flat``: views of one buffer, as a dp all-reduce returns them (not
    16-byte aligned after a size off the 4-wide vectors)."""
    from e3diff_tpu_torch.training.optim import global_norm

    sizes = [math.prod(s) for s in shapes]
    if flat:
        buf = torch.randn(sum(sizes), generator=gen, device="cuda")
        grads = [v.view(s) for v, s in zip(buf.split(sizes), shapes)]
    else:
        grads = [torch.randn(s, generator=gen, device="cuda")
                 for s in shapes]
    torch._foreach_mul_(grads, norm / float(global_norm(grads)))
    return grads


def adamw_plain_step(kernels, opt, grads):
    """``opt.step(grads)`` through the plain chain."""
    from e3diff_tpu_torch.training.optim import global_norm

    norm = global_norm(grads)
    kernels.adamw_update_plain(
        opt.params, grads, opt.mu, opt.nu, norm, opt.table, opt.count,
        grad_clip=opt.grad_clip, b1=opt.b1, b2=opt.b2, eps=opt.eps,
        weight_decay=opt.weight_decay)
    return norm


def adamw_against_plain(torch, kernels, label, shapes, mu_dtype, wd, gen,
                        flat: bool = False) -> list[str]:
    """len(ADAMW_NORMS) updates through the kernel and through the plain
    chain from equal states and gradients: p, mu, nu and count held equal
    bit for bit after every update. Returns what differed."""
    fused, plain = adamw_pair(torch, shapes, mu_dtype, wd, gen)
    before = kernels.adamw_update.launches
    differ = []
    for k, target in enumerate(ADAMW_NORMS):
        grads = adamw_grads(torch, shapes, target, gen, flat)
        norm = fused.step(grads)
        check(torch.equal(norm, adamw_plain_step(kernels, plain, grads)),
              f"{label}: the global norms differ")
        for name in ("params", "mu", "nu"):
            bad = [i for i, (x, y) in enumerate(zip(getattr(fused, name),
                                                    getattr(plain, name)))
                   if not torch.equal(x, y)]
            if bad:
                x, y = (getattr(o, name)[bad[0]].float() for o in (fused,
                                                                   plain))
                differ.append(
                    f"update {k + 1}: {name} of {len(bad)} tensors, first "
                    f"{tuple(x.shape)}: {int((x != y).sum())} values, max "
                    f"|diff| {float((x - y).abs().max()):.3e}")
        if not torch.equal(fused.count, plain.count):
            differ.append(f"update {k + 1}: count")
        if differ:
            break
    torch.cuda.synchronize()
    n = sum(math.prod(s) for s in shapes)
    print(f"  {label}, mu {mu_dtype}, weight decay {wd}, norms "
          f"{ADAMW_NORMS}{', flat gradients' if flat else ''}: "
          f"{len(shapes)} tensors, {n:,} values, "
          f"{kernels.adamw_update.launches - before} launches: "
          f"{'; '.join(differ) or 'p, mu, nu and count equal bit for bit'}",
          flush=True)
    return [f"{label} {mu_dtype} {wd}: {d}" for d in differ]


def adamw_timing(torch, kernels, label, shapes, gen) -> dict:
    """Device ms a call of the kernel, of the plain chain and of
    torch.optim.AdamW(fused=True) (the library yardstick, no clipping),
    f32 mu, weight decay 0.1, the clip taken; and the kernel's bound: its
    row of the kernels line."""
    fused, plain = adamw_pair(torch, shapes, "f32", 0.1, gen)
    grads = adamw_grads(torch, shapes, 5.0, gen)
    norm = fused.step(grads)
    kw = dict(grad_clip=1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)

    def kernel_call():
        kernels.adamw_update(fused.params, grads, fused.mu, fused.nu, norm,
                             fused.table, fused.count, **kw)

    def plain_call():
        kernels.adamw_update_plain(plain.params, grads, plain.mu, plain.nu,
                                   norm, plain.table, plain.count, **kw)

    ms, host_ms = time_call(torch, kernel_call, 20)
    # the chain enqueues hundreds of launches a call: few calls suffice
    plain_ms, _ = time_call(torch, plain_call, 2, reps=3)
    del plain
    torch.cuda.empty_cache()
    lib_params = [torch.nn.Parameter(p.detach().clone())
                  for p in fused.params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    lib = torch.optim.AdamW(lib_params, lr=5e-5, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1, fused=True)
    lib_ms, _ = time_call(torch, lib.step, 20)
    n = sum(math.prod(s) for s in shapes)
    bound_ms, bound_by = bound(n * ADAMW_BYTES, 0, "bfloat16")
    print(f"  {label}: {len(shapes)} tensors, {n:,} values: kernel "
          f"{ms:.4f} ms a call (enqueue {host_ms:.3f} ms), bound "
          f"{bound_ms:.4f} ms ({n * ADAMW_BYTES / 1e9:.3f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {100 * bound_ms / ms:.1f}%), "
          f"plain chain {plain_ms:.4f} ms, torch.optim.AdamW(fused=True) "
          f"{lib_ms:.4f} ms", flush=True)
    # the kernels line's row; main() sums its launches over the trainers'
    # runs, and the kernel equals the chain bit for bit (max_abs_err 0)
    return dict(
        name="adamw_update", route="cuda",
        source="e3diff_tpu_torch/csrc/adamw.cu", replaces=None, launches=0,
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms,
        shape=f"{label} list, {len(shapes)} tensors, {n} values, f32 mu, "
              f"weight decay 0.1, clipped", host_ms=host_ms)


def adamw_capture_check(torch, kernels, gen) -> int:
    """A captured structure train step at its preset: the adamw_launches
    of its graphs.capture span, which are the capture's launches of the
    kernel."""
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils import telemetry
    from e3diff_tpu_torch.utils.presets import structure_train_config

    cfg = structure_train_config(max_epochs=1)
    batch, _ = train_batch(torch, cfg, gen, "structure")
    trainer = build_trainer("structure", cfg, "cuda", steps_per_epoch=10_000)
    step = trainer.capture(batch)
    span = [s for s in telemetry.recorder().spans("graphs.capture")
            if s.attrs.get("owner") == "train"][-1]
    got = span.attrs.get("adamw_launches")
    print(f"  a captured structure train step's graphs.capture span: "
          f"adamw_launches {got}", flush=True)
    check(got is not None and got >= 1, f"the captured structure train "
          f"step's adamw_launches is {got}, not 1 or more")
    check(got == step.launches["adamw_update"], f"adamw_launches {got}, "
          f"the capture's launches {step.launches}")
    step.close()
    del trainer, step
    torch.cuda.empty_cache()
    return got


def adamw_phase(torch, kernels, gen) -> tuple[dict, list[dict]]:
    """Phase 12 (i): the fused clipping and AdamW update against the plain
    chain, bit for bit, at both train cells' parameter lists and an edge
    list; its time, bound, the chain's and the library's (a row of the
    kernels line for each list); and a captured train step's
    adamw_launches; ``launches``: the kernel's launches in the phase."""
    numbers, failures, rows = {}, [], []
    before = kernels.adamw_update.launches
    lists = {kind: adamw_param_shapes(torch, kind)
             for kind in ("sequence", "structure")}
    for kind, shapes in lists.items():
        for mu_dtype, wd in ADAMW_CASES:
            failures += adamw_against_plain(torch, kernels, kind, shapes,
                                            mu_dtype, wd, gen)
            torch.cuda.empty_cache()
    many = [(int(n),) for n in torch.randint(
        1, 50, (ADAMW_MANY,), generator=torch.Generator().manual_seed(3))]
    for mu_dtype in ("f32", "bf16"):
        failures += adamw_against_plain(
            torch, kernels, "edge", [(n,) for n in ADAMW_EDGE_SIZES],
            mu_dtype, 0.1, gen, flat=True)
        failures += adamw_against_plain(torch, kernels, f"{ADAMW_MANY} small",
                                        many, mu_dtype, 0.1, gen)
    check(not failures, "the fused AdamW update differs from the plain "
          "chain: " + " | ".join(failures))
    for kind, shapes in lists.items():
        rows.append(adamw_timing(torch, kernels, kind, shapes, gen))
        torch.cuda.empty_cache()
    numbers["capture_adamw_launches"] = adamw_capture_check(torch, kernels,
                                                            gen)
    numbers["launches"] = kernels.adamw_update.launches - before
    return numbers, rows


# ---------------------------------------------------------------------------
# phase 6.2: --trajectory_bf16 and the overlapped host copies
# ---------------------------------------------------------------------------

OVERLAP_BATCHES = 3


def serial_batches(torch, run, batches, seed: int) -> list:
    """sampling/structure.py::sample_structure_batches as it was before its
    host copies overlapped the next batch: each batch's trajectory copied
    to the host before the next batch is sampled."""
    from e3diff_tpu_torch.data.dataset import strip_meta

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = []
    for batch in batches:
        tbatch = {k: torch.as_tensor(np.asarray(v), device="cuda")
                  for k, v in strip_meta(batch).items()}
        _, traj = run(tbatch, gen)
        lengths = np.asarray(batch["ligand_attn_mask"]).sum(1).astype(int)
        traj = traj.float().cpu().numpy()
        results.extend(traj[:, i, :lengths[i], :]
                       for i in range(int(batch["num_valid"])))
    return results


def trajectory_phase(torch, kernels, cli_main, model, diffusion, batch,
                     struct_capture) -> dict:
    """Phase 6.2: the sample_structure CLI (DDPM-1000, captured,
    int8_matmul, B=32, ligand 16, the trajectory kept) from one seed
    without and with --trajectory_bf16: the bf16 pickle is the f32 one
    rounded to bf16, exactly; a captured DDIM-25 run with a bf16
    trajectory buffer against the eager loop on the same draws, bit for
    bit; then DDPM-1000 over OVERLAP_BATCHES batches of B through
    sample_structure_batches (batch n's host copy overlapping batch
    n+1) against the serial loop it replaced, in turns (serial,
    overlapped, overlapped, serial), the same arrays, their seconds.
    Returns the seconds."""
    import pickle

    from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu_torch.sampling import (
        make_structure_sampler,
        sample_structure_batches,
    )

    numbers = {}
    pickles = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("f32", []), ("bf16", ["--trajectory_bf16"])):
            out = Path(tmp) / f"{name}.pkl"
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli_main(["--synthetic", "--params_dtype", "int8_matmul",
                      "--batch_size", str(B), "--max_seq_len", str(MAX_POS),
                      "--ligand_max_len", str(L_LIG), "--output", str(out),
                      *extra])
            numbers[f"cli ddpm-{T} trajectory {name} s"] = (
                time.perf_counter() - t0)
            counts = launch_counts(kernels)
            check(counts == struct_capture,
                  f"cli trajectory {name}: launches {counts}")
            with open(out, "rb") as f:
                pickles[name] = pickle.load(f)
    f32, bf16 = pickles["f32"], pickles["bf16"]
    check(len(f32) == len(bf16) > 0 and all(
        a.dtype == b.dtype == np.float32 and a.shape == b.shape
        and a.shape[0] == T for a, b in zip(f32, bf16)),
        "cli trajectory pickles: layouts differ")
    check(all(np.array_equal(
        b, torch.from_numpy(a).bfloat16().float().numpy())
        for a, b in zip(f32, bf16)),
        "the --trajectory_bf16 pickle is not the f32 one rounded to bf16")
    print(f"  cli ddpm-{T} int8_matmul, trajectory f32 and bf16: "
          f"{len(bf16)} samples of {bf16[0].shape}, f32 "
          f"{numbers[f'cli ddpm-{T} trajectory f32 s']:.2f} s, bf16 "
          f"{numbers[f'cli ddpm-{T} trajectory bf16 s']:.2f} s (model "
          f"build and capture included); the bf16 pickle is the f32 one "
          f"rounded to bf16, exactly", flush=True)

    got = {}
    for eager in (False, True):
        run = make_structure_sampler(
            model, diffusion, sampler="ddim", ddim_steps=DDIM_STEPS,
            return_trajectory=True, trajectory_dtype=torch.bfloat16,
            eager=eager)
        got[eager] = run(batch, generator=torch.Generator(
            device="cuda").manual_seed(4))
    (fc, tc), (fe, te) = got[False], got[True]
    check(tc.dtype == te.dtype == torch.bfloat16
          and torch.equal(tc, te) and torch.equal(fc, fe),
          "ddim with a bf16 trajectory: captured differs from eager")
    print(f"  ddim-{DDIM_STEPS} with a bf16 trajectory buffer "
          f"{tuple(tc.shape)}: captured equal to the eager loop bit for "
          "bit", flush=True)
    del got, run

    ds = LigandBindingSiteData(
        synthetic_complexes(n=OVERLAP_BATCHES * B, seed=13), None, MAX_POS,
        0, L_LIG)
    batches = list(ds.batches(B))
    check(len(batches) == OVERLAP_BATCHES, f"{len(batches)} batches")
    secs, results = {"serial": [], "overlapped": []}, {}
    for how in ("serial", "overlapped", "overlapped", "serial"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "serial":
            results[how] = serial_batches(
                torch, make_structure_sampler(model, diffusion), batches, 5)
        else:
            results[how] = sample_structure_batches(
                model, diffusion, batches, device="cuda", seed=5,
                first_batch_only=False)
        secs[how].append(time.perf_counter() - t0)
        torch.cuda.empty_cache()
    check(len(results["serial"]) == len(results["overlapped"]) > 0 and all(
        np.array_equal(a, b) for a, b in zip(results["serial"],
                                             results["overlapped"])),
        "sample_structure_batches differs from the serial loop")
    numbers["ddpm batches serial s"] = secs["serial"]
    numbers["ddpm batches overlapped s"] = secs["overlapped"]
    print(f"  ddpm-{T} int8_matmul over {OVERLAP_BATCHES} batches of {B} "
          f"with the f32 trajectory, capture included: serial host copies "
          f"{[round(x, 3) for x in secs['serial']]} s, overlapped "
          f"{[round(x, 3) for x in secs['overlapped']]} s (in turns: "
          "serial, overlapped, overlapped, serial); the same arrays",
          flush=True)
    return numbers


# ---------------------------------------------------------------------------
# phase 11: structure files to evaluated designs
# ---------------------------------------------------------------------------

CORPUS_N, CORPUS_CIF, CORPUS_GZ = 64, 8, 4
CORPUS_LOW_RES = 1            # rows with a resolution >= 5, dropped
CORPUS_DUPLICATES = 2         # repeated pdb_ids, dropped after the first
DSSP_CHECK_N = 8              # structures whose C++ kernels meet numpy's
DSSP_TOL = 1e-12
PREPROCESS_WORKERS = 4
ONE_TO_THREE = dict(zip("ACDEFGHIKLMNPQRSTVWY", (
    "ALA CYS ASP GLU PHE GLY HIS ILE LYS LEU MET ASN PRO GLN ARG SER THR "
    "VAL TRP TYR").split()))
BB_ATOMS = (("N", "N"), ("CA", "C"), ("C", "C"), ("O", "O"))
CIF_FIELDS = ("group_PDB", "id", "type_symbol", "label_atom_id",
              "label_alt_id", "label_comp_id", "label_asym_id",
              "label_seq_id", "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y",
              "Cartn_z", "occupancy", "auth_seq_id", "auth_comp_id",
              "auth_asym_id", "auth_atom_id", "pdbx_PDB_model_num")


def corpus_chain(rng, n, helix):
    """(n, 4, 3) N/CA/C/O coordinates by the port's float64 NERF from
    torsions around the helix or the strand basin, and a sequence."""
    from e3diff_tpu_torch.geometry.nerf import nerf_build_backbone_np

    center = np.array([(-63.0, -43.0) if rng.uniform() < helix
                       else (-120.0, 130.0) for _ in range(n)])
    phi = np.deg2rad(center[:, 0] + rng.normal(0, 12, n))
    psi = np.deg2rad(center[:, 1] + rng.normal(0, 12, n))
    coords = nerf_build_backbone_np(
        phi, psi, np.pi + np.deg2rad(rng.normal(0, 3, n)),
        psi + np.pi + np.deg2rad(rng.normal(0, 2, n)), center=False)
    return coords.reshape(n, 4, 3), "".join(rng.choice(list(ONE_TO_THREE), n))


def structure_text(chains, fmt: str) -> str:
    """PDB or mmCIF (``_atom_site``) text of {chain id: (coords, seq)}."""
    lines, serial = [], 0
    if fmt == "cif":
        lines = ["data_corpus", "#", "loop_",
                 *(f"_atom_site.{f}" for f in CIF_FIELDS)]
    for chain_id, (coords, seq) in chains.items():
        for i, aa in enumerate(seq):
            for j, (name, element) in enumerate(BB_ATOMS):
                serial += 1
                x, y, z = coords[i, j]
                res3 = ONE_TO_THREE[aa]
                if fmt == "cif":
                    lines.append(
                        f"ATOM {serial} {element} {name} . {res3} {chain_id} "
                        f"{i + 1} ? {x:.3f} {y:.3f} {z:.3f} 1.00 {i + 1} "
                        f"{res3} {chain_id} {name} 1")
                else:
                    lines.append(
                        f"ATOM  {serial:5d}  {name:<3s}{res3:>4s} "
                        f"{chain_id}{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                        f"  1.00  5.00          {element:>2s}")
        if fmt == "pdb":
            lines.append("TER")
    lines.append("#" if fmt == "cif" else "END")
    return "\n".join(lines) + "\n"


def write_corpus(folder: Path, seed: int = 12):
    """CORPUS_N complexes as structure files (most .pdb, CORPUS_CIF as
    .cif, CORPUS_GZ as .pdb.gz): a receptor chain A of 30-90 residues
    whose 16-64 residues nearest the peptide form the pocket, and a
    peptide chain B of 5-16 residues; then the BioLiP metadata TSV with
    CORPUS_DUPLICATES repeated pdb_ids and CORPUS_LOW_RES resolution >= 5.
    Returns (meta path, the pdb_ids preprocessing must keep, the paths of
    the structures the DSSP check reads)."""
    import gzip

    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    rows, keep, dssp_paths = [], [], []
    for i in range(CORPUS_N):
        pdb_id = f"c{i:03d}"
        n_rec = int(rng.integers(30, 91))
        n_lig = int(rng.integers(5, 17))
        rec, rec_seq = corpus_chain(rng, n_rec, rng.uniform(0.2, 0.8))
        lig, lig_seq = corpus_chain(rng, n_lig, rng.uniform(0.2, 0.8))
        anchor = rec[int(rng.integers(1, n_rec - 1)), 1]
        direction = rng.normal(size=3)
        lig = (lig - lig[:, 1].mean(0) + anchor
               + 9.0 * direction / np.linalg.norm(direction))
        # the pocket: the receptor's interior residues nearest the peptide
        n_pocket = int(rng.integers(16, min(64, n_rec - 2) + 1))
        # (a chain's first and last residue carry no angles, and the
        # reference's pocket index is not shifted by that trim, so a site
        # on the second-last residue would land on the peptide)
        n_pocket = min(n_pocket, n_rec - 3)
        d = np.linalg.norm(rec[1:-2, None, 1] - lig[None, :, 1],
                           axis=-1).min(1)
        site = np.sort(np.argsort(d)[:n_pocket]) + 1
        chains = {"A": (rec, rec_seq), "B": (lig, lig_seq)}
        if i < CORPUS_CIF:
            path = folder / f"{pdb_id}.cif"
            path.write_text(structure_text(chains, "cif"))
        elif i < CORPUS_CIF + CORPUS_GZ:
            # read by the port's readers, but parse_record looks only for
            # {pdb_id}.pdb and {pdb_id}.cif, as the JAX package does
            path = folder / f"{pdb_id}.pdb.gz"
            with gzip.open(path, "wt") as f:
                f.write(structure_text(chains, "pdb"))
        else:
            path = folder / f"{pdb_id}.pdb"
            path.write_text(structure_text(chains, "pdb"))
        if i < DSSP_CHECK_N // 2 or CORPUS_CIF <= i < CORPUS_CIF + CORPUS_GZ:
            dssp_paths.append(path)
        resolution = 6.5 if i == CORPUS_N - 1 else rng.uniform(1.2, 3.5)
        site_ids = " ".join(f"{rec_seq[j]}{j + 1}" for j in site)
        row = [pdb_id, "A", f"{resolution:.2f}", "bs1", "PEP", "B", "1",
               site_ids, site_ids, *([""] * 10), str(n_lig), rec_seq]
        rows.append("\t".join(row))
        if resolution < 5 and not str(path).endswith(".gz"):
            keep.append(pdb_id)
    for j in range(CORPUS_DUPLICATES):   # a later row of an earlier id
        dup = rows[CORPUS_CIF + CORPUS_GZ + j].split("\t")
        dup[7] = dup[8] = "A2"
        rows.append("\t".join(dup))
    meta = folder / "meta.tsv"
    meta.write_text("\n".join(rows) + "\n")
    return meta, keep, dssp_paths


@contextlib.contextmanager
def recorded_casts():
    """Record, for each cast_inference_params call, its storage mode and
    the dtypes of the model's floating leaves after it (the CLIs look the
    function up in utils/params_io.py when they run)."""
    from e3diff_tpu_torch.utils import params_io

    cast, seen = params_io.cast_inference_params, []

    def recording(model, dtype):
        out = cast(model, dtype)
        seen.append((dtype, {str(t.dtype) for t in (
            *model.parameters(), *(b for b in model.buffers()
                                   if b is not None))
            if t.is_floating_point()}))
        return out

    params_io.cast_inference_params = recording
    try:
        yield seen
    finally:
        params_io.cast_inference_params = cast


def dssp_engines_check(paths) -> float:
    """The C++ H-bond scan and ASA against the numpy engine on ``paths``:
    the same bonds in the same order, values within DSSP_TOL."""
    from e3diff_tpu_torch import native
    from e3diff_tpu_torch.data import dssp
    from e3diff_tpu_torch.data.native_structure import parse_structure_chains

    lib, worst, n_bonds = native.load_native_lib(), 0.0, 0
    check(lib is not None, "the native DSSP library is off")
    for path in paths:
        chains = parse_structure_chains(str(path))
        entries = dssp._flatten(chains)
        dssp._mark_connectivity(entries)
        a, b = dssp.hbond_scan_native(entries, lib), dssp.hbond_scan_numpy(
            entries)
        check([x[:2] for x in a] == [x[:2] for x in b] and a,
              f"{path.name}: the C++ H-bond scan's pairs or order differ")
        n_bonds += len(a)
        worst = max(worst, *(abs(x[2] - y[2]) for x, y in zip(a, b)))
        residues, coords, radii, owner = dssp.asa_inputs(chains)
        args = (np.stack(coords), np.asarray(radii), np.asarray(owner),
                dssp._fibonacci_sphere(dssp.N_SPHERE_POINTS), len(residues))
        worst = max(worst, float(np.abs(dssp.asa_native(*args, lib)
                                        - dssp.asa_numpy(*args)).max()))
    print(f"  C++ against numpy on {len(paths)} structures "
          f"({', '.join(p.name for p in paths)}): {n_bonds} H-bonds in the "
          f"same order, max abs diff {worst:.3e} (tol {DSSP_TOL:g})")
    check(worst <= DSSP_TOL, f"C++ DSSP differs from numpy by {worst}")
    return worst


def evaluation_numbers(text: str) -> list[float]:
    return [float(x) for x in re.findall(
        r"(?<![\w.])[-+]?(?:\d+\.\d+|\d+|nan|inf)(?![\w.=])", text)]


def files_to_designs_phase(torch, kernels, model, run_root: Path,
                           card: str, design_seconds: dict) -> dict:
    """Phase 11: structure files -> preprocessing -> full-width sampling
    in bf16 storage -> PDB files -> inverse folding on the generated
    angles -> evaluation; prune_ckpt on phase 9's run directory;
    convert_data. Returns the seconds of each stage."""
    from e3diff_tpu_torch import native
    from e3diff_tpu_torch.cli import (
        convert_data,
        create_pdb,
        evaluate,
        sample_by_generated_angles,
        sample_structure,
    )
    from e3diff_tpu_torch.data.dataset import load_complexes
    from e3diff_tpu_torch.data.native_structure import parse_pdb_chains
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record
    from e3diff_tpu_torch.utils.builders import build_sequence_model
    from e3diff_tpu_torch.utils.presets import (
        save_config,
        sequence_sample_config,
        structure_sample_config,
    )

    secs = {}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        # 11.1 the corpus
        t0 = time.perf_counter()
        meta, keep, dssp_paths = write_corpus(tmp / "structures")
        secs["corpus"] = time.perf_counter() - t0
        print(f"  corpus: {CORPUS_N} complexes ({CORPUS_CIF} .cif, "
              f"{CORPUS_GZ} .pdb.gz) and {CORPUS_N + CORPUS_DUPLICATES} TSV "
              f"rows in {secs['corpus']:.2f} s", flush=True)

        # 11.2 preprocessing: the library from the repo's source, then the
        # CLI in its own process with worker processes
        t0 = time.perf_counter()
        lib_path = native.build_library()
        build_s = time.perf_counter() - t0
        check(lib_path.parent == ROOT / "e3diff_tpu_torch" / "_build" /
              "native" and lib_path.name == native.library_path().name
              and lib_path.is_file(),
              f"native library {lib_path} is not the build of "
              f"{native.SOURCE.relative_to(ROOT)}")
        print(f"  g++ built {lib_path.relative_to(ROOT)} from "
              f"{native.SOURCE.relative_to(ROOT)} in {build_s:.2f} s "
              f"(BUILD_INFO {native.BUILD_INFO})")
        corpus = tmp / "corpus.pkl"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "e3diff_tpu_torch.cli.preprocess",
             "--meta_file", str(meta), "--structure_folder",
             str(meta.parent), "--output", str(corpus), "--engine",
             "native", "--workers", str(PREPROCESS_WORKERS)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        secs["preprocess"] = time.perf_counter() - t0
        print("  " + proc.stdout.strip().replace("\n", "\n  "))
        check(proc.returncode == 0, f"preprocess exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        check(f"native DSSP library: {lib_path} (loaded" in proc.stdout,
              "preprocess did not load the library built from the repo")
        records = load_complexes(str(corpus))
        got_ids = [r["structure_ids"]["pdb_id"] for r in records]
        rows = CORPUS_N - CORPUS_LOW_RES
        print(f"  preprocess, {PREPROCESS_WORKERS} workers: "
              f"{len(records)} records from {rows} rows in "
              f"{secs['preprocess']:.2f} s wall, process start included: "
              f"{rows / secs['preprocess']:.1f} complexes/s")
        check(got_ids == keep and all(
            r["preprocess_engine"] == "native" for r in records),
            f"preprocess kept {got_ids}, expected {keep}")
        dssp_engines_check(dssp_paths)

        # 11.3 full-width sampling from the preprocessed data, bf16 storage
        cfg = structure_sample_config(ligand_max_len=L_LIG)
        qcfg = sequence_sample_config(ligand_max_len=L_LIG)
        sdir, qdir = tmp / "models" / "structure", tmp / "models" / "sequence"
        t0 = time.perf_counter()
        check(all(v.dtype == torch.float32
                  for v in model.state_dict().values()),
              "the structure model is not f32")
        save_config(cfg, str(sdir))
        torch.save(model.state_dict(), sdir / "final.pt")
        qmodel = build_sequence_model(qcfg, device="cuda", seed=1)
        save_config(qcfg, str(qdir))
        torch.save(qmodel.state_dict(), qdir / "final.pt")
        del qmodel
        secs["save_models"] = time.perf_counter() - t0

        angles = tmp / "angles.pkl"
        with recorded_casts() as casts:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            sampled = sample_structure.main([
                "--data_file", str(corpus), "--ckpt", str(sdir / "final.pt"),
                "--all_batches", "--sampler", "ddim", "--ddim_steps",
                str(DDIM_STEPS), "--params_dtype", "bf16", "--batch_size",
                str(B), "--no_trajectory", "--output", str(angles)])
            secs["sample_structure"] = time.perf_counter() - t0
            counts = launch_counts(kernels)
        want = captured(kernels, STRUCT_CALLS)
        print(f"  cli sample_structure ddim-{DDIM_STEPS} bf16: "
              f"{len(sampled)} samples in {secs['sample_structure']:.2f} s "
              f"(model load and capture included), launches {counts}; "
              f"stored {casts}", flush=True)
        check(counts == want, f"sample_structure: launches {counts} != "
              f"{want}")
        check(casts == [("bf16", {"torch.bfloat16"})],
              f"sample_structure stored {casts}, not all bf16")
        check(len(sampled) > 0 and all(
            s.ndim == 2 and s.shape[1] == 8 and in_angle_range(torch, s)
            for s in sampled), "sample_structure: samples malformed")

        pdb_dir = tmp / "pdbs"
        t0 = time.perf_counter()
        written = create_pdb.main(["--input", str(angles), "--outdir",
                                   str(pdb_dir)])
        worst = 0.0
        for path, s in zip(written, sampled):
            check(bool(path), "create_pdb: a NaN reconstruction")
            chains = parse_pdb_chains(path)
            res = chains.get("A", [])
            check(list(chains) == ["A"] and len(res) == len(s) and all(
                list(r.atoms) == ["N", "CA", "C", "O"] for r in res),
                f"{path}: not 4 backbone atoms for each of {len(s)} "
                "residues")
            coords = np.stack([r[a].get_coord() for r in res
                               for a in ("N", "CA", "C", "O")])
            check(np.isfinite(coords).all(), f"{path}: coordinates")
            if len(s) > 1:
                worst = max(worst, float(bond_errors(coords).max()))
        secs["create_pdb"] = time.perf_counter() - t0
        print(f"  cli create_pdb: {len(written)} PDBs read back by the "
              f"port's reader in {secs['create_pdb']:.2f} s, bond lengths "
              f"within {worst:.2e} A of ideal (atol {PDB_BOND_ATOL:g})")
        check(worst <= PDB_BOND_ATOL, "create_pdb: bond lengths")

        seqs = tmp / "sequences.pkl"
        with recorded_casts() as casts:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = sample_by_generated_angles.main([
                "--data_file", str(corpus), "--ckpt", str(qdir / "final.pt"),
                "--generated", str(angles), "--output", str(seqs),
                "--params_dtype", "bf16", "--batch_size", str(B)])
            secs["sample_by_generated_angles"] = time.perf_counter() - t0
            counts = launch_counts(kernels)
        want = captured(kernels, SEQ_CALLS)
        print(f"  cli sample_by_generated_angles bf16: "
              f"{len(results['predict_sequence'])} sequences in "
              f"{secs['sample_by_generated_angles']:.2f} s, launches "
              f"{counts}; stored {casts}", flush=True)
        check(counts == want, f"sample_by_generated_angles: launches "
              f"{counts} != {want}")
        check(casts == [("bf16", {"torch.bfloat16"})],
              f"sample_by_generated_angles stored {casts}, not all bf16")
        check([len(q) for q in results["predict_sequence"]]
              == [len(s) for s in sampled] and all(
                  set(q) <= set(ONE_TO_THREE)
                  for q in results["predict_sequence"]),
              "sample_by_generated_angles: sequences invalid")

        report = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(report):
            evaluate.main(["--data_file", str(corpus), "--angles",
                           str(angles), "--sequences", str(seqs),
                           "--geometry", "--config", str(sdir)])
        secs["evaluate"] = time.perf_counter() - t0
        text = report.getvalue()
        print("  cli evaluate:\n    " + text.strip().replace("\n", "\n    "))
        numbers = evaluation_numbers(text)
        tvs = [float(x) for x in re.findall(
            r"^\s+\S+\s+([-\d.]+)$", text.split("mean TV")[0], re.M)]
        tvs += [float(x) for x in re.findall(r"TV distance: ([-\d.]+)", text)]
        rates = [float(x) for x in re.findall(
            r"(?:mean|median|max)=([-\d.]+)", text)]
        check(numbers and all(math.isfinite(x) for x in numbers),
              "evaluate printed a number that is not finite")
        check(len(tvs) == 10 and all(0 <= x <= 1 for x in tvs),
              f"evaluate: TV distances {tvs}")
        check(len(rates) == 3 and all(0 <= x <= 1 for x in rates),
              f"evaluate: recovery rates {rates}")
        check(re.search(r"sampled backbone geometry.* nan=0/", text)
              is not None, "evaluate: a NaN reconstruction")

        # the bf16 design batch beside phase 8's int8_matmul one
        t0 = time.perf_counter()
        eng = DesignEngine.from_checkpoints(
            str(sdir / "final.pt"), str(qdir / "final.pt"),
            params_dtype="bf16", device="cuda", batch_size=DESIGN_BATCH,
            batch_buckets=[8], sampler="ddim", ddim_steps=DDIM_STEPS)
        kernels.reset_launch_counts()
        eng.warmup(generator=torch.Generator(device="cuda").manual_seed(5))
        counts = launch_counts(kernels)
        want = sum_counts(captured(kernels, STRUCT_CALLS, 2),
                          captured(kernels, SEQ_CALLS, 2))
        secs["engine_load_warmup"] = time.perf_counter() - t0
        check(counts == want, f"bf16 engine warmup: launches {counts} != "
              f"{want}")
        requests = pocket_requests(DESIGN_BATCH, seed=4)
        pockets = [pocket_record(*r) for r in requests]
        for rep in range(2):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            designs = eng.design_records(pockets, generator=torch.Generator(
                device="cuda").manual_seed(6))
            secs[f"design_batch_bf16_{rep}"] = time.perf_counter() - t0
            check(launch_counts(kernels) == with_zeros(kernels, {}),
                  "a warm bf16 engine launched outside its graphs")
        check_designs(designs, requests, "bf16 engine")
        int8 = design_seconds[f"{DESIGN_BATCH} records int8_matmul"]
        print(f"  DesignEngine bf16: {DESIGN_BATCH} records in "
              f"{secs['design_batch_bf16_0']:.3f} / "
              f"{secs['design_batch_bf16_1']:.3f} s per design batch, "
              f"beside phase 8's int8_matmul {int8:.3f} s (load and "
              f"capture {secs['engine_load_warmup']:.2f} s, warmup "
              f"launches {counts})", flush=True)
        del eng
        torch.cuda.empty_cache()

        # 11.4 prune_ckpt on phase 9's run directory
        run = run_root / "structure"
        before = sorted(p.name for p in run.iterdir())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "e3diff_tpu_torch.cli.prune_ckpt",
             str(run)], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        after = sorted(p.name for p in run.iterdir())
        print(f"  cli prune_ckpt: {before} -> {after}: "
              f"{proc.stdout.strip().splitlines()[-1:]}")
        check(proc.returncode == 0, f"prune_ckpt failed: {proc.stderr}")
        check("last.pt" not in after and {
            "final.pt", "best_val_model.pt", "final_ema.pt", "config.json",
            "history.json"} <= set(after) and not any(
                n.endswith(".tmp") for n in after),
            f"prune_ckpt left {after}")
        eng = DesignEngine.from_checkpoints(
            str(run / "final.pt"), str(run_root / "sequence" / "final.pt"),
            transition="blosum", device="cuda", batch_size=DESIGN_BATCH)
        check(eng.structure_model is not None,
              "DesignEngine did not load the pruned final.pt")
        del eng
        empty = tmp / "no_artifacts"
        empty.mkdir()
        (empty / "last.pt").write_bytes(b"")
        refused = subprocess.run(
            [sys.executable, "-m", "e3diff_tpu_torch.cli.prune_ckpt",
             str(empty)], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        secs["prune_ckpt"] = time.perf_counter() - t0
        print(f"  prune_ckpt without an inference artifact: exit "
              f"{refused.returncode}, {refused.stderr.strip()[-90:]!r}")
        check(refused.returncode != 0 and (empty / "last.pt").is_file(),
              "prune_ckpt pruned a directory with no inference artifact")

        # 11.5 convert_data: the corpus as a torch .pt of tensors -> pickle
        t0 = time.perf_counter()
        as_pt = tmp / "corpus.pt"
        torch.save([{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                     else v for k, v in r.items()} for r in records], as_pt)
        convert_data.main(["--input", str(as_pt), "--output",
                           str(tmp / "converted.pkl")])
        back = load_complexes(str(tmp / "converted.pkl"))
        same = len(back) == len(records) and all(
            list(a) == list(b) and all(
                np.array_equal(a[k], b[k]) if isinstance(b[k], np.ndarray)
                else a[k] == b[k] for k in b)
            for a, b in zip(back, records))
        secs["convert_data"] = time.perf_counter() - t0
        check(same, "convert_data: the converted corpus differs")
    print(f"  {card}")
    return secs


# ---------------------------------------------------------------------------
# phase 13: multi-device on one card
# ---------------------------------------------------------------------------

# Several ranks share cuda:0 over gloo (NCCL refuses two ranks on one GPU),
# spawned with torch.multiprocessing; each joins through a file in a
# temporary directory and writes what it measured there.
PAR_STEPS = 3
PAR_SEED = 21                # the tp samplers' weights
PAR_TIMEOUT = 420            # seconds a world may take before it is killed
# A mesh step against the one-process step, both bf16 compute, dropout 0.1
# and every draw from one seed: the two differ only in the order of their
# sums (a GEMM over 32 rows or a partial product of half the heads, then an
# all-reduce, against one over 64 rows), so the bf16 rounding flips land
# elsewhere, as in phase 9.3. Neither bf16 run is the reference: each
# parameter's first moment (0.1 of its clipped gradient, and after 3 steps
# their running mean) is held to the f32 one-process run's, the mesh
# run's error at most BF16_GRAD_FACTOR times the one-process bf16 run's
# plus BF16_GRAD_SLACK (phase 9.3's rule); the losses to TRAIN_LOSS_TOL's
# bf16 1e-2 of the one-process bf16 run's; the first step's grad norm (the
# same weights in every run) by phase 9.3's rule, |mesh - f32| at most
# BF16_GRAD_FACTOR |one process - f32| + BF16_GRAD_SLACK |f32| (later
# steps' norms are printed, not held: from the first update on, the runs'
# weights differ, so their gradients are other models'); each weight's
# change over the steps by the moments' rule, held to the f32 run's change
# (all three runs start from the same weights): Adam divides each
# gradient by its own size, so an update follows the signs of the
# gradient's elements, and a wrong gradient moves many weights the other
# way, where the bf16 roundings move only those whose gradient is all but
# zero; a tensor whose whole gradient is rounding noise, as the key
# biases' is, takes random signs in every run, and its errors are alike.
# tp=2 sampling in f32 against one process on the same noise: the f32
# sums in another order (~1e-6 per op). A whole DDIM-25 run at T=1000 is
# not held element by element: its first step divides the network's
# rounding by sqrt(alpha_bar_999) and wraps the x0 prediction, so a few
# angles land across the +-pi seam and their rows part (the final
# difference is printed; so is a one-process step's from the tp run's
# state, which multiplies a 1e-6 noise prediction difference the same way).
# Held instead, step by step along the tp run's own trajectory: the
# network, the one-process model's noise prediction at each step's input
# against the tp model's to PAR_EPS_REL in relative L2; and the sampler,
# each recorded step against the DDIM update of the tp model's prediction
# to PAR_STEP_ANGLE_TOL wrapped (the same arithmetic on the same inputs);
# the D3PM's final classes on at least 99% of the valid tokens (a near tie
# in one token's logits flips its class, and the later steps of its row
# follow it).
PAR_EPS_REL = 1e-4
PAR_STEP_ANGLE_TOL = 1e-6
PAR_SEQ_AGREE = 0.99


def _par_rank(rank, world, dp, tp, backend, workdir, task, spawned):
    """One rank of a phase-13 world (a spawned process at wall time
    ``spawned``): joins the job, builds the mesh on cuda:0, runs ``task``,
    writes its results; ``setup_s`` counts from the spawn."""
    global _CYCLES_PER_MS
    t_start = time.perf_counter() - (time.time() - spawned)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    _CYCLES_PER_MS = _cycles_per_ms(torch)
    dist.init_process_group(backend, init_method=f"file://{workdir}/rdv_"
                            f"{task}", rank=rank, world_size=world)
    from e3diff_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp, tp, backend=backend, device="cuda:0")
    out = PAR_TASKS[task](torch, mesh, Path(workdir), t_start)
    with open(Path(workdir) / f"{task}_rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _par_world(torch, task, dp, tp, backend, workdir) -> list[dict]:
    """Spawn the dp x tp ranks of ``task`` on cuda:0; wait (killing them
    past PAR_TIMEOUT); return each rank's results."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    world = dp * tp
    spawned = time.time()
    procs = [ctx.Process(target=_par_rank, args=(r, world, dp, tp, backend,
                                                 str(workdir), task, spawned))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"phase 13 {task}: ranks exited "
          f"with {codes}")
    outs = []
    for r in range(world):
        with open(Path(workdir) / f"{task}_rank{r}.json") as f:
            outs.append(json.load(f))
    print(f"  {task}: {world} ranks ({dp} x {tp}, {backend}) done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return outs


class AllReduceClock:
    """Times every torch.distributed.all_reduce (synchronised around the
    call, which gloo's staging through the host does anyway)."""

    def __init__(self, torch):
        import torch.distributed as dist

        self.torch, self.dist, self.secs = torch, dist, 0.0
        self.calls = 0
        self._orig = dist.all_reduce

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self._orig(*a, **kw)
            torch.cuda.synchronize()
            self.secs += time.perf_counter() - t0
            self.calls += 1
            return res

        dist.all_reduce = timed

    def close(self):
        self.dist.all_reduce = self._orig


def _par_steps(torch, kernels, trainer, batch, n):
    """``n`` eager train steps; the losses, grad norms, step seconds and
    the kernels' launches over them."""
    kernels.reset_launch_counts()
    losses, norms, secs = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["train_loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, secs, launch_counts(kernels)


def _same_across(torch, mesh, tensors, src: int) -> bool:
    """Whether rank 0's tensors equal rank ``src``'s bit for bit: ``src``
    broadcasts their concatenation, every rank takes part."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    theirs = flat.clone()
    dist.broadcast(theirs, src=src)
    return bool(torch.equal(flat, theirs))


def _par_references(torch, kernels, batch, mesh_res):
    """Rank 0: the one-process f32 and bf16 runs of the same steps, and
    the mesh run held to them (the tolerances above PAR_STEPS)."""
    import dataclasses

    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import structure_train_config

    cfg = structure_train_config(max_epochs=1)
    ref = {}
    for dname, bf16 in (("float32", False), ("bfloat16", True)):
        t = build_trainer("structure", dataclasses.replace(cfg, bf16=bf16),
                          "cuda", 10_000)
        w0 = [p.detach().clone() for p in t.optimizer.params]
        losses, norms, _, _ = _par_steps(torch, kernels, t, batch, PAR_STEPS)
        ref[dname] = dict(losses=losses, norms=norms,
                          mu=[m.detach().clone() for m in t.optimizer.mu],
                          w=[p.detach().clone() for p in t.optimizer.params],
                          w0=w0, names=t.optimizer.names)
        del t
        torch.cuda.empty_cache()
    f32, b16 = ref["float32"], ref["bfloat16"]
    names = f32["names"]
    mu = [mesh_res["mu"][n] for n in names]
    err_m = grad_errors(torch, mu, f32["mu"])
    err_o = grad_errors(torch, b16["mu"], f32["mu"])
    excess = err_m - BF16_GRAD_FACTOR * err_o
    worst = int(excess.argmax())
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(mesh_res["losses"], b16["losses"]))
    a, b, c = mesh_res["norms"][0], b16["norms"][0], f32["norms"][0]
    norm_excess = (abs(a - c) - BF16_GRAD_FACTOR * abs(b - c)
                   - BF16_GRAD_SLACK * abs(c))
    # the weights' changes: every run starts from the f32 run's weights
    check(all(torch.equal(a, b) for a, b in zip(f32["w0"], b16["w0"])),
          "phase 13: the one-process runs start from other weights")
    moved = [w - w0 for w, w0 in zip(f32["w"], f32["w0"])]
    werr_m = grad_errors(torch, [mesh_res["w"][n] - w0 for n, w0
                                 in zip(names, f32["w0"])], moved)
    werr_o = grad_errors(torch, [w - w0 for w, w0 in zip(b16["w"],
                                                         f32["w0"])], moved)
    w_excess = werr_m - BF16_GRAD_FACTOR * werr_o
    w_worst = int(w_excess.argmax())
    return dict(
        loss_rel=loss_rel, norm_excess=norm_excess,
        mu_err_median=err_m.median().item(), mu_err_max=err_m.max().item(),
        one_err_median=err_o.median().item(), one_err_max=err_o.max().item(),
        worst=names[worst], worst_mesh=err_m[worst].item(),
        worst_one=err_o[worst].item(), excess=excess.max().item(),
        w_err_median=werr_m.median().item(), w_err_max=werr_m.max().item(),
        w_one_median=werr_o.median().item(), w_one_max=werr_o.max().item(),
        w_worst=names[w_worst], w_worst_mesh=werr_m[w_worst].item(),
        w_worst_one=werr_o[w_worst].item(), w_excess=w_excess.max().item(),
        ref_losses=b16["losses"],
        ref_norms=b16["norms"], f32_losses=f32["losses"],
        f32_norms=f32["norms"])


def _dropout_draw_cost(torch, trainer, batch, mesh):
    """The hidden Dropout draws of one step at the global shape (a mesh
    rank's) against its own shape: device ms per step, the calls counted
    by hooks in one forward, each shape timed with CUDA events."""
    from e3diff_tpu_torch.models.blocks import Dropout

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((tuple(inp[0].shape),
                                             mod.split_cols)))
        for m in trainer.model.modules() if isinstance(m, Dropout)]
    trainer.model.train()
    with torch.no_grad():   # a dp-only forward: no collective
        trainer.model(torch.zeros(batch["ligand_angles"].shape[0],
                                  dtype=torch.int64, device="cuda"),
                      batch["ligand_angles"], batch["ligand_attn_mask"],
                      batch["receptor_seq"], batch["receptor_angles"],
                      batch["receptor_attn_mask"])
    for h in hooks:
        h.remove()
    ms = {"global": 0.0, "local": 0.0}
    for (shape, split), n in Counter(shapes).items():
        x = torch.randn(shape, device="cuda").to(trainer.model.encoder_config
                                                  .dtype)
        for label, m in (("global", mesh), ("local", None)):
            d = Dropout(0.1, m, split_cols=split and m is not None).train()
            d.generator = torch.Generator(device="cuda").manual_seed(0)
            ms[label] += n * time_call(torch, lambda: d(x), 20)[0]
    return dict(calls=len(shapes), global_ms=ms["global"],
                local_ms=ms["local"])


def _keep_bits_check(torch, kernels, mesh, gen) -> bool:
    """A tp rank's attention keep bits: its training forward's and
    backward's (q = k = 0 and one-hot V and dO, as phase 9.1 reads them)
    and e3d_dropout_keep's, at the rank's block (rows 32..63 of 64, its 6
    of 12 heads), against the matching block of dropout_keep_plain's
    one-device draw, exactly; bf16 and f32, 128 x 128 with the table."""
    b, lq, lk, h = TRAIN_B // 2, TRAIN_L, TRAIN_L, HEADS // mesh.tp
    block = (b, TRAIN_B, mesh.tp_rank * h, HEADS)
    seed = draw_seed(torch, gen)
    want = kernels.dropout_keep_plain(seed, (TRAIN_B, HEADS, lq, lk),
                                      DROPOUT)[b:, block[2]:block[2] + h]
    ok = True
    got = torch.empty((b, h, lq, lk), dtype=torch.uint8, device="cuda")
    code = kernels._build.load_library().e3d_dropout_keep(
        ctypes.c_void_p(seed.data_ptr()), b, h, lq, lk, block[0], block[2],
        block[3], kernels.dropout_threshold(DROPOUT),
        ctypes.c_void_p(got.data_ptr()), kernels._stream())
    ok &= code == 0 and torch.equal(got.bool(), want)
    width = h * HEAD_DIM

    def onehot(n, dtype):
        r = torch.arange(n, device="cuda")[:, None]
        x = ((r % HEAD_DIM) == torch.arange(HEAD_DIM, device="cuda")[None])
        x = x.float() * (1.0 + (r >= HEAD_DIM).float())
        return x.repeat(1, h)[None].expand(b, n, width).contiguous().to(dtype)

    def code_of(keep, n):
        c = keep[..., :min(n, HEAD_DIM)].long()
        c = torch.nn.functional.pad(c, (0, HEAD_DIM - c.shape[-1]))
        if n > HEAD_DIM:
            c[..., :n - HEAD_DIM] += 2 * keep[..., HEAD_DIM:].long()
        return c

    kw = dict(num_heads=h, max_pos=TRAIN_L, dropout_block=block)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(b, lq, width, device="cuda", dtype=dtype)
        mask = torch.zeros(b, lk, device="cuda")
        tab = torch.randn(2 * TRAIN_L - 1, HEAD_DIM, generator=gen,
                          device="cuda").to(dtype)
        pf = torch.tensor(kernels.drop_scale(DROPOUT) / lk).to(dtype).float()
        out, lse = kernels.fused_attention_train(q, q, onehot(lk, dtype),
                                                 mask, tab, seed, DROPOUT,
                                                 **kw)
        bits = torch.round(out.float().view(b, lq, h, HEAD_DIM) / pf).long()
        ok &= torch.equal(bits.transpose(1, 2), code_of(want, lk))
        _, _, dv, _ = kernels.attention_backward(onehot(lq, dtype), q, q, q,
                                                 lse, mask, tab, seed,
                                                 DROPOUT, **kw)
        bits = torch.round(dv.float().view(b, lk, h, HEAD_DIM) / pf).long()
        ok &= torch.equal(bits.transpose(1, 2),
                          code_of(want.transpose(2, 3), lq))
    return bool(ok)


def _par_train(torch, mesh, workdir: Path, t_start):
    """Worlds (a) dp=2 and (b) tp=2: PAR_STEPS eager structure train steps
    at the preset (B=64 over the mesh, length 128, bf16, dropout 0.1), the
    replicas compared bit for bit, rank 0 against the one-process runs;
    then (b) the keep bits and the tp samplers, (a) the engine."""
    import torch.distributed as dist

    from e3diff_tpu_torch.ops import kernels
    from e3diff_tpu_torch.parallel import shard_batch
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import structure_train_config

    cfg = structure_train_config(max_epochs=1)
    batch = {k: v.to("cuda") for k, v in
             torch.load(workdir / "batch.pt").items()}
    trainer = build_trainer("structure", cfg, mesh.device, 10_000, mesh)
    local = shard_batch(batch, mesh)
    torch.cuda.synchronize()
    res = {"setup_s": time.perf_counter() - t_start}
    torch.cuda.reset_peak_memory_stats()
    clock = AllReduceClock(torch)
    losses, norms, secs, counts = _par_steps(torch, kernels, trainer, local,
                                             PAR_STEPS)
    clock.close()
    res.update(losses=losses, norms=norms, step_ms=[1e3 * s for s in secs],
               allreduce_ms_per_step=1e3 * clock.secs / PAR_STEPS,
               allreduce_calls_per_step=clock.calls / PAR_STEPS,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               train_launches=counts,
               launches_ok=counts == {k: PAR_STEPS * n for k, n in
                                      with_zeros(kernels, train_step_launches(
                                          "structure")).items()})
    # replicas: the dp ranks hold everything alike, the tp ranks the
    # replicated tensors (the distance tables among them)
    sd = trainer.model.state_dict()
    rules = trainer.model.sharding_rules
    keys = (list(sd) if mesh.tp == 1 else
            [k for k in sd if rules[k] == "replicated"])
    res["replicas_equal"] = _same_across(torch, mesh, [sd[k] for k in keys],
                                         src=1)
    res["replicated_tables"] = sum("distance_embedding" in k for k in keys)
    state = trainer.full_state_dict()
    if mesh.rank == 0:
        full = {"w": {k: v for k, v in state["model"].items()},
                "mu": state["optimizer"]["mu"], "losses": losses,
                "norms": norms}
        res["dropout_draws"] = (_dropout_draw_cost(torch, trainer, local,
                                                   mesh)
                                if mesh.dp > 1 else None)
        del trainer, state
        torch.cuda.empty_cache()
        res["vs_one_process"] = _par_references(torch, kernels, batch, full)
        del full
        torch.cuda.empty_cache()
    else:
        del trainer, state
        torch.cuda.empty_cache()
    dist.barrier()
    if mesh.tp > 1:
        res["keep_bits_exact"] = _keep_bits_check(
            torch, kernels, mesh,
            torch.Generator(device="cuda").manual_seed(31))
        res.update(_par_sample(torch, kernels, mesh, workdir))
    else:
        res.update(_par_engine(torch, kernels, mesh, workdir))
    return res


def _par_sample(torch, kernels, mesh, workdir: Path) -> dict:
    """World (b), tp=2: a DDIM-25 structure batch of 32 and a D3PM-50
    batch, f32, eager on the mesh, against the one-process samples on the
    same noise (rank 0)."""
    import torch.distributed as dist

    from e3diff_tpu_torch.diffusion import D3PMDiffusion
    from e3diff_tpu_torch.diffusion import GaussianAngleDiffusion
    from e3diff_tpu_torch.models import (
        SequenceDenoiser,
        StructureDenoiser,
        sequence_model_configs,
        structure_model_configs,
    )
    from e3diff_tpu_torch.ops.transitions import UniformTransition
    from e3diff_tpu_torch.sampling import (
        make_sequence_sampler,
        make_structure_sampler,
    )
    from e3diff_tpu_torch.sampling.structure import make_denoise_fn

    data = torch.load(workdir / "sample.pt")
    batch = {k: v.to("cuda") for k, v in data["batch"].items()}
    diffusion = GaussianAngleDiffusion.cosine(T, device="cuda")
    d3pm = D3PMDiffusion.create(UniformTransition(20), SEQ_T, device="cuda")
    models = {"structure": (StructureDenoiser, structure_model_configs),
              "sequence": (SequenceDenoiser, sequence_model_configs)}
    res, outs = {}, {}
    for name, (cls, configs) in models.items():
        enc, dec = configs(max_seq_len=MAX_POS)
        shard = cls(enc, dec, device="cuda", seed=PAR_SEED, mesh=mesh)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "structure":
            run = make_structure_sampler(shard, diffusion, sampler="ddim",
                                         ddim_steps=DDIM_STEPS,
                                         return_trajectory=True, eager=True)
            got, traj = run(batch, noise=data["structure_noise"])
        else:
            run = make_sequence_sampler(shard, d3pm, eager=True)
            got = run(batch, noise=data["sequence_noise"])
        torch.cuda.synchronize()
        res[f"{name}_sample_s"] = time.perf_counter() - t0
        res[f"{name}_launches"] = launch_counts(kernels)
        res[f"{name}_tp_equal"] = _same_across(torch, mesh, [got], src=1)
        outs[name] = got
        if name == "structure":
            # the tp model's noise prediction at each step's input
            ts, t_prev = diffusion.ladder("ddim", n_steps=DDIM_STEPS)
            inputs = [data["structure_noise"]["x_init"].cuda(),
                      *traj[:-1]]
            denoise = make_denoise_fn(shard, batch, guided=False)
            eps_tp = [denoise(torch.full((B,), int(t), device="cuda"), x)
                      for t, x in zip(ts, inputs)]
            z = data["structure_noise"]["z"].cuda()
            step_err = []
            for i, (t, tp_, x) in enumerate(zip(ts, t_prev, inputs)):
                x_out = diffusion.ddim_step(
                    x, eps_tp[i], torch.full((B,), int(t), device="cuda"),
                    torch.full((B,), int(tp_), device="cuda"), 1.0, z[i])
                d = (traj[i] - x_out + math.pi) % (2 * math.pi) - math.pi
                step_err.append(d.abs().max().item())
            res["structure_step_err"] = max(step_err)
        del shard, run
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        for name, (cls, configs) in models.items():
            enc, dec = configs(max_seq_len=MAX_POS)
            whole = cls(enc, dec, device="cuda", seed=PAR_SEED)
            if name == "structure":
                denoise = make_denoise_fn(whole, batch, guided=False)
                eps_rel, one_err = [], []
                for i, (t, tp_, x) in enumerate(zip(ts, t_prev, inputs)):
                    tv = torch.full((B,), int(t), device="cuda")
                    eps = denoise(tv, x)
                    eps_rel.append(((eps_tp[i] - eps).norm()
                                    / eps.norm()).item())
                    x_out = diffusion.ddim_step(
                        x, eps, tv, torch.full((B,), int(tp_), device="cuda"),
                        1.0, z[i])
                    d = (traj[i] - x_out + math.pi) % (2 * math.pi) - math.pi
                    one_err.append(d.abs().max().item())
                want = make_structure_sampler(
                    whole, diffusion, sampler="ddim", ddim_steps=DDIM_STEPS,
                    return_trajectory=False, eager=True)(
                    batch, noise=data["structure_noise"])[0]
                d = (outs[name] - want + math.pi) % (2 * math.pi) - math.pi
                res["structure_final_max_diff"] = d.abs().max().item()
                res["structure_final_median_diff"] = d.abs().median().item()
                res["structure_eps_rel"] = max(eps_rel)
                res["structure_one_step_err"] = max(one_err)
                res["structure_in_range"] = in_angle_range(torch,
                                                           outs[name])
            else:
                want = make_sequence_sampler(whole, d3pm, eager=True)(
                    batch, noise=data["sequence_noise"])
                valid = batch["ligand_attn_mask"].bool()
                same = outs[name].argmax(-1) == want.argmax(-1)
                res["sequence_agree"] = same[valid].float().mean().item()
            del whole
            torch.cuda.empty_cache()
    dist.barrier()
    return res


def _par_engine(torch, kernels, mesh, workdir: Path) -> dict:
    """World (a), dp=2: DesignEngine(mesh=) from phase 9's final.pt files,
    eager (gloo); rank 0 leads one design batch of 32, rank 1 follows; the
    designs held to phase 8's checks, beside a one-process engine's from
    the same seed."""
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record

    paths = json.loads((workdir / "ckpts.json").read_text())
    kw = dict(transition="blosum", batch_size=DESIGN_BATCH, sampler="ddim",
              ddim_steps=DDIM_STEPS)
    eng = DesignEngine.from_checkpoints(paths["structure"],
                                        paths["sequence"], mesh=mesh,
                                        **kw)
    kernels.reset_launch_counts()
    if mesh.rank != 0:
        eng.follow()
        return {"engine_launches": launch_counts(kernels)}
    requests = pocket_requests(DESIGN_BATCH, seed=9)
    t0 = time.perf_counter()
    results = eng.design_records([pocket_record(*r) for r in requests],
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(10))
    secs = time.perf_counter() - t0
    eng.stop_followers()
    counts = launch_counts(kernels)
    check_designs(results, requests, "DesignEngine(mesh=) dp=2")
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator(
        device="cuda").manual_seed(10), device="cuda").item())
    one = DesignEngine.from_checkpoints(paths["structure"],
                                        paths["sequence"], **kw)
    want = one.design_records([pocket_record(*r) for r in requests],
                              generator=torch.Generator(
                                  device="cuda").manual_seed(seed))
    same = sum(a.sequence == b.sequence for a, b in zip(results, want))
    diff = max(float(np.abs((a.angles - b.angles + np.pi) % (2 * np.pi)
                            - np.pi).max()) for a, b in zip(results, want))
    return {"engine_s": secs, "engine_launches": counts,
            "engine_same_sequences": same, "engine_angle_max_diff": diff}


def _par_capture(torch, mesh, workdir: Path, t_start):
    """World (d): an NCCL world of one. The captured structure train step
    (its gradient and metric all-reduces inside the graph) against the
    mesh-free captured step from the same seed, over PAR_STEPS replays:
    losses, grad norms and every weight and moment bit for bit."""
    from e3diff_tpu_torch.ops import kernels
    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import structure_train_config

    cfg = structure_train_config(max_epochs=1)
    batch = {k: v.to("cuda") for k, v in
             torch.load(workdir / "batch.pt").items()}
    res = {}
    runs = {}
    for label, m in (("plain", None), ("mesh", mesh)):
        trainer = build_trainer("structure", cfg, "cuda", 10_000, m)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        step = trainer.capture(batch, pool=torch.cuda.graph_pool_handle())
        torch.cuda.synchronize()
        res[f"{label}_capture_s"] = time.perf_counter() - t0
        res[f"{label}_capture_launches"] = launch_counts(kernels)
        losses, norms = [], []
        secs = []
        for _ in range(PAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(met["train_loss"].item())
            norms.append(met["grad_norm"].item())
        res[f"{label}_replay_ms"] = [1e3 * s for s in secs]
        runs[label] = (losses, norms, [t.detach().clone() for t in
                                       trainer_state(trainer)])
        step.close()
        del trainer, step
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["plain"]
    res["losses"] = a[0]
    res["equal"] = (a[0] == b[0] and a[1] == b[1] and len(a[2]) == len(b[2])
                    and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))
    return res


PAR_TASKS = {"train_dp": _par_train, "train_tp": _par_train,
             "capture_nccl": _par_capture}


def multidevice_phase(torch, kernels, card, run_root: Path) -> dict:
    """Phase 13. Returns the ranks' launches on the main paths (train
    steps, tp samplers, the engine) and the phase's numbers."""
    from e3diff_tpu_torch.diffusion import D3PMDiffusion
    from e3diff_tpu_torch.ops.transitions import UniformTransition
    from e3diff_tpu_torch.utils.presets import structure_train_config

    totals = {k.__name__: 0 for k in kernels.KERNELS}
    numbers = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    cfg = structure_train_config(max_epochs=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        work = Path(tmp)
        batch, _ = train_batch(torch, cfg, gen, "structure")
        torch.save({k: v.cpu() for k, v in batch.items()}, work / "batch.pt")
        sbatch = make_batch(torch, gen)
        sbatch["ligand_seq"] = torch.nn.functional.one_hot(
            torch.randint(0, 20, (B, L_LIG), generator=gen, device="cuda"),
            20).float()
        d3pm = D3PMDiffusion.create(UniformTransition(20), SEQ_T,
                                    device="cuda")
        x_init = torch.rand(B, L_LIG, 8, generator=gen, device="cuda")
        torch.save({
            "batch": {k: v.cpu() for k, v in sbatch.items()},
            "structure_noise": {
                "x_init": ((x_init * 2 - 1) * math.pi).cpu(),
                "z": torch.randn(DDIM_STEPS, B, L_LIG, 8, generator=gen,
                                 device="cuda").cpu()},
            "sequence_noise": {
                k: v.cpu() for k, v in zip(("x_init", "gumbel"),
                                           d3pm.draw_noise(
                    (B, L_LIG, 20), None, generator=gen, device="cuda"))}},
            work / "sample.pt")
        (work / "ckpts.json").write_text(json.dumps({
            "structure": str(run_root / "structure" / "final.pt"),
            "sequence": str(run_root / "sequence" / "final.pt")}))
        del batch, sbatch
        torch.cuda.empty_cache()

        for task, dp, tp in (("train_dp", 2, 1), ("train_tp", 1, 2)):
            outs = _par_world(torch, task, dp, tp, "gloo", work)
            numbers[task] = _report_train_world(torch, task, outs)
            for o in outs:
                for key in ("train_launches", "structure_launches",
                            "sequence_launches", "engine_launches"):
                    for k, n in o.get(key, {}).items():
                        totals[k] += n
        outs = _par_world(torch, "capture_nccl", 1, 1, "nccl", work)
        r = outs[0]
        print(f"  (d) NCCL world of one, the captured step with its "
              f"all-reduces in the graph against the mesh-free captured "
              f"step, {PAR_STEPS} replays: "
              f"{'bit for bit' if r['equal'] else 'DIFFER'}; losses "
              f"{r['losses']}; capture {r['mesh_capture_s']:.2f} s against "
              f"{r['plain_capture_s']:.2f} s; replays ms "
              f"{[round(x, 2) for x in r['mesh_replay_ms']]} against "
              f"{[round(x, 2) for x in r['plain_replay_ms']]}", flush=True)
        check(r["equal"], "phase 13 (d): the NCCL mesh's captured step "
              "differs from the mesh-free one")
        check(r["mesh_capture_launches"] == r["plain_capture_launches"],
              "phase 13 (d): the captures launched differently")
        numbers["capture_nccl"] = r
        numbers["torchrun_cli"] = _torchrun_cli(torch, kernels, work,
                                                run_root)
    print(f"  {card}")
    return totals, numbers


def _report_train_world(torch, task, outs) -> dict:
    """Print and check one training world's results (rank 0's
    comparisons, every rank's launches, replicas, memory, times)."""
    r0 = outs[0]
    label = "(a) dp=2" if task == "train_dp" else "(b) tp=2"
    over = ("every tensor" if task == "train_dp"
            else "the replicated tensors")
    v = r0["vs_one_process"]
    for i, o in enumerate(outs):
        print(f"  {label} rank {i}: setup {o['setup_s']:.1f} s, step ms "
              f"{[round(x, 1) for x in o['step_ms']]}, gloo all-reduce "
              f"{o['allreduce_ms_per_step']:.1f} ms a step in "
              f"{o['allreduce_calls_per_step']:.0f} calls, peak "
              f"{o['peak_gib']:.2f} GiB, launches {o['train_launches']}",
              flush=True)
        check(o["launches_ok"], f"phase 13 {label} rank {i}: launches "
              f"{o['train_launches']}")
    print(f"  {label}: losses {r0['losses']} against one process "
          f"{v['ref_losses']} (rel {v['loss_rel']:.2e}, tol "
          f"{TRAIN_LOSS_TOL['bfloat16']:g}); grad norms {r0['norms']} "
          f"against {v['ref_norms']} (f32 {v['f32_norms']}); first moments "
          f"against the f32 run: "
          f"mesh median {v['mu_err_median']:.2e} worst {v['mu_err_max']:.2e},"
          f" one process median {v['one_err_median']:.2e} worst "
          f"{v['one_err_max']:.2e}; closest to the bound {v['worst']} "
          f"({v['worst_mesh']:.2e} against {v['worst_one']:.2e}); weight "
          f"changes against the f32 run's: mesh median "
          f"{v['w_err_median']:.2e} worst {v['w_err_max']:.2e}, one process "
          f"median {v['w_one_median']:.2e} worst {v['w_one_max']:.2e}; "
          f"closest to the bound {v['w_worst']} ({v['w_worst_mesh']:.2e} "
          f"against {v['w_worst_one']:.2e}); replicas "
          f"{'bit for bit' if r0['replicas_equal'] else 'DIFFER'} over "
          f"{over} ({r0['replicated_tables']} distance tables)", flush=True)
    check(v["loss_rel"] <= TRAIN_LOSS_TOL["bfloat16"],
          f"phase 13 {label}: losses differ by {v['loss_rel']}")
    check(v["norm_excess"] <= 0, f"phase 13 {label}: the first step's grad "
          f"norm {r0['norms'][0]}")
    check(v["excess"] <= BF16_GRAD_SLACK, f"phase 13 {label}: the first "
          f"moment of {v['worst']}: {v['worst_mesh']} against the one-"
          f"process run's {v['worst_one']}")
    check(v["w_excess"] <= BF16_GRAD_SLACK, f"phase 13 {label}: the weights "
          f"of {v['w_worst']} moved {v['w_worst_mesh']} from the f32 run's, "
          f"the one-process run's {v['w_worst_one']}")
    check(all(o["replicas_equal"] for o in outs),
          f"phase 13 {label}: replicas differ")
    check(r0["replicated_tables"] > 0 or task == "train_dp",
          f"phase 13 {label}: no replicated distance table compared")
    if task == "train_dp":
        d = r0["dropout_draws"]
        print(f"  (a) hidden dropout draws at the global shape: {d['calls']}"
              f" calls a forward, {d['global_ms']:.3f} ms against "
              f"{d['local_ms']:.3f} ms at the rank's own shape", flush=True)
        print(f"  (f) DesignEngine(mesh=) dp=2, eager: {DESIGN_BATCH} designs"
              f" in {r0['engine_s']:.2f} s; {r0['engine_same_sequences']} of"
              f" {DESIGN_BATCH} sequences and angles within "
              f"{r0['engine_angle_max_diff']:.2e} of a one-process engine "
              f"from the same seed; launches rank 0 "
              f"{r0['engine_launches']}, rank 1 "
              f"{outs[1]['engine_launches']}", flush=True)
        for o in outs:
            check(o["engine_launches"]["fused_attention"] > 0,
                  "phase 13 (f): a rank launched no attention kernel")
    else:
        print(f"  (b) keep bits at the tp ranks' blocks: "
              f"{[o['keep_bits_exact'] for o in outs]}", flush=True)
        check(all(o["keep_bits_exact"] for o in outs),
              "phase 13 (b): keep bits differ from dropout_keep_plain's")
        tp_equal = [o["structure_tp_equal"] and o["sequence_tp_equal"]
                    for o in outs]
        print(f"  (c) tp=2 f32 eager: DDIM-{DDIM_STEPS} B={B} in "
              f"{r0['structure_sample_s']:.2f} s; each step against one "
              f"process from the tp run's state: noise prediction within "
              f"{r0['structure_eps_rel']:.2e} relative L2 (tol "
              f"{PAR_EPS_REL:g}); each recorded step within "
              f"{r0['structure_step_err']:.2e} of the DDIM update of the tp "
              f"prediction (tol {PAR_STEP_ANGLE_TOL:g}); a one-process step "
              f"from the same state within "
              f"{r0['structure_one_step_err']:.2e}; whole runs: final "
              f"angles apart by {r0['structure_final_median_diff']:.2e} "
              f"median, {r0['structure_final_max_diff']:.2e} at most; "
              f"D3PM-{SEQ_T} in "
              f"{r0['sequence_sample_s']:.2f} s, classes agree on "
              f"{100 * r0['sequence_agree']:.2f}% of valid tokens (tol "
              f"{100 * PAR_SEQ_AGREE:g}%); tp ranks bit for bit: "
              f"{tp_equal}", flush=True)
        check(r0["structure_in_range"]
              and r0["structure_eps_rel"] <= PAR_EPS_REL
              and all(o["structure_step_err"] <= PAR_STEP_ANGLE_TOL
                      for o in outs), "phase 13 (c): structure steps")
        check(r0["sequence_agree"] >= PAR_SEQ_AGREE,
              "phase 13 (c): sequence samples")
        check(all(tp_equal), "phase 13 (c): tp ranks differ")
        for o in outs:
            for name in ("structure", "sequence"):
                check(o[f"{name}_launches"]["fused_attention"] > 0,
                      f"phase 13 (c): no {name} attention launch")
    return {k: v for k, v in r0.items() if not k.endswith("launches")}


def _torchrun_cli(torch, kernels, work: Path, run_root: Path) -> dict:
    """World (e): the structure train CLI under torch.distributed.run, 2
    ranks on the card over gloo, one epoch; its final.pt has the
    one-process key set and serves DesignEngine.from_checkpoints."""
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record

    ckpt = work / "torchrun"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           "e3diff_tpu_torch.cli.train_structure", "--multihost", "--dp", "2",
           "--dist_backend", "gloo", "--synthetic", "--synthetic_n",
           str(TRAIN_B * 5 // 4), "--max_epochs", "1", "--ckpt_dir",
           str(ckpt)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=PAR_TIMEOUT)
    secs = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
    print(f"  (e) torch.distributed.run --nproc_per_node 2 train_structure "
          f"--multihost --dp 2 --dist_backend gloo: exit {proc.returncode} "
          f"in {secs:.1f} s; {tail}", flush=True)
    check(proc.returncode == 0, "phase 13 (e): the 2-rank train CLI failed")
    got = torch.load(ckpt / "final.pt", weights_only=True)
    want = torch.load(run_root / "structure" / "final.pt", weights_only=True)
    check(set(got) == set(want) and all(
        got[k].shape == want[k].shape for k in want),
        "phase 13 (e): final.pt's keys or shapes differ from one process'")
    for name in ("config.json", "last.pt", "history.json"):
        check((ckpt / name).is_file(), f"phase 13 (e): no {name}")
    eng = DesignEngine.from_checkpoints(
        str(ckpt / "final.pt"), str(run_root / "sequence" / "final.pt"),
        transition="blosum", device="cuda", batch_size=DESIGN_BATCH,
        sampler="ddim", ddim_steps=DDIM_STEPS)
    requests = pocket_requests(DESIGN_BATCH, seed=11)
    results = eng.design_records([pocket_record(*r) for r in requests],
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(12))
    check_designs(results, requests, "engine from the 2-rank final.pt")
    print(f"  (e) final.pt: the one-process key set ({len(got)} tensors); "
          f"DesignEngine.from_checkpoints served {DESIGN_BATCH} designs",
          flush=True)
    return {"seconds": secs}


if __name__ == "__main__":
    sys.exit(main())
