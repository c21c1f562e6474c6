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
   weight storage, plus the sampling CLI -- checking that every sample is
   finite and in [-pi, pi) and that the kernels were launched exactly
   13 + 29 times per encode and 25 + 41 times per reverse step;
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
   finite, ideal bond lengths) and the exact launches of both kernels in
   each stage (13 + 29 per encode and 25 + 41 per DDIM step; 15 + 32 per
   sequence forward, 50 forwards), and printing seconds per design batch;
9. training at full width: the dropout bits the kernels draw from a seed
   (Philox4x32-10, written out by ``e3d_dropout_keep``) against
   ``dropout_keep_plain`` bit for bit, and the bits the training forward
   and the backward apply, read back exactly; the training forward of the
   attention kernel (dropout 0.1 from a seed, and 0, with the row
   log-sum-exp), its backward and the LayerNorm backward against their
   plain versions (and in f32 against torch.autograd) at the training
   shapes (B=64, 128 x 128), the sampler's, Lq != Lk, lengths off the
   16-row tiles, ragged and dead rows, f32 and bf16, then their times
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
   memory; both train CLIs for one epoch, and DesignEngine serving a
   design batch from the two final.pt files they wrote.

The last three lines are the kernels' JSON record, the card, and
``{"ok": true, "device": {...}}``.

Usage, from the root of a checkout:
    python3 chip_smoke.py              # what the checks above need
    python3 chip_smoke.py --profile DIR  # also torch.profiler breakdowns
                                         # of a DDIM run, a design batch and
                                         # 3 structure train steps (device
                                         # busy ms a step, the dropout draws'
                                         # ms), traces written to DIR
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


def attention_inputs(torch, gen, case, dtype):
    """Seeded q, k, v, mask and table for one ``AttnCase``. A ragged mask
    keeps a random prefix of 1..Lk keys, and a single key in every fourth
    batch row; a dead row masks every key."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    b, lq, lk = case.b, case.lq, case.lk
    q, k, v = randn(b, lq, HIDDEN), randn(b, lk, HIDDEN), randn(b, lk, HIDDEN)
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
    def autograd_plain(q, k, v, mask, table, seed, p, *, num_heads, max_pos):
        keep = None if seed is None else kernels.dropout_keep_plain(
            seed, (q.shape[0], num_heads, q.shape[1], k.shape[1]), p)
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
          f"{torch.cuda.device_count()}")

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
            secs = time.perf_counter() - t0
            counts = launch_counts(kernels)
            want = with_zeros(kernels, {
                k: PER_ENCODE[k] + n_steps * PER_STEP[k] for k in PER_STEP})
            seconds[name] = secs
            print(f"  {name}: {secs:.3f} s ({secs / n_steps * 1e3:.2f} ms "
                  f"per step), launches {counts}", flush=True)
            check(counts == want, f"{name}: launches {counts} != {want}")
            check(tuple(final.shape) == (B, L_LIG, 8), f"{name}: shape")
            check(in_angle_range(torch, final),
                  f"{name}: output not finite or outside [-pi, pi)")
            if (sampler, storage) == ("ddpm", "int8_matmul"):
                main_counts = counts

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
        want = with_zeros(kernels, {k: PER_ENCODE[k] + DDIM_STEPS * PER_STEP[k]
                                    for k in PER_STEP})
        print(f"  cli ddim-{DDIM_STEPS} int8_matmul: {secs:.3f} s including "
              f"model build, {len(results)} samples, launches {counts}")
        check(counts == want, f"cli: launches {counts} != {want}")
        check(out.is_file() and len(results) > 0, "cli wrote no samples")
        check(all(r.ndim == 2 and r.shape[1] == 8
                  and in_angle_range(torch, r) for r in results),
              "cli samples malformed")
    del model8

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
    design_counts, design_seconds = design_phase(
        torch, kernels, model, enc, dec, diffusion, batch, gen, card,
        None if args.profile is None else Path(args.profile))
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
    train_cli_phase(torch, kernels)
    print(f"  {card}")
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    # the launches of the main paths' runs: the DDPM-1000 structure run,
    # the 32-record int8 design batch and the two trainers' train steps
    for entry in record:
        entry["launches"] = (main_counts[entry["name"]]
                             + design_counts[entry["name"]]
                             + train_counts[entry["name"]])

    if args.profile:
        phase("profile: DDIM-25 int8_matmul, torch.profiler")
        profile_sampler(torch, model, diffusion, batch,
                        make_structure_sampler, cast_inference_params,
                        StructureDenoiser, enc, dec, Path(args.profile))
        phase("profile: structure train steps, B=64, torch.profiler")
        profile_train_steps(torch, kernels, Path(args.profile))

    print(f"\nsampler seconds: {json.dumps(seconds)}")
    print(f"design seconds per batch: {json.dumps(design_seconds)}")
    print(f"train steps: {json.dumps(train_timing)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class StageMeter:
    """Wraps a DesignEngine's two samplers to read, for each call, the
    launches of both kernels and the seconds to the end of its device
    work (synchronised at the stage's end, where the engine reads its
    result anyway)."""

    def __init__(self, torch, kernels, engine):
        self.torch, self.kernels, self.calls = torch, kernels, []
        for stage, attr in (("structure", "_struct_run"),
                            ("sequence", "_seq_run")):
            setattr(engine, attr, self._wrap(stage, getattr(engine, attr)))

    def _wrap(self, stage, run):
        def counted(*args, **kwargs):
            before = {k.__name__: k.launches for k in self.kernels.KERNELS}
            t0 = time.perf_counter()
            out = run(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.calls.append((stage, time.perf_counter() - t0, {
                k.__name__: k.launches - before[k.__name__]
                for k in self.kernels.KERNELS}))
            return out
        return counted


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
                 card, profile_dir):
    """Phase 8. Returns the launches of the 32-record int8_matmul design
    batch and the seconds of every design batch."""
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
    want_stage = {
        "structure": with_zeros(kernels, {
            k: PER_ENCODE[k] + DDIM_STEPS * PER_STEP[k] for k in PER_STEP}),
        "sequence": with_zeros(kernels, {
            k: SEQ_T * PER_SEQ_FORWARD[k] for k in PER_STEP})}
    seconds, main_design = {}, None
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
        eng.warmup(generator=torch.Generator(device="cuda").manual_seed(5))
        meter = StageMeter(torch, kernels, eng)
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
            stages = {stage: c for stage, _, c in meter.calls}
            stage_secs = {stage: round(t, 4) for stage, t, _ in meter.calls}
            seconds[name] = secs
            print(f"  {name}: {secs:.3f} s per design batch, "
                  f"{len(reqs) / secs:.2f} designs/s; stage seconds "
                  f"{stage_secs} (NERF, PDB text and host work: "
                  f"{secs - sum(stage_secs.values()):.3f} s); launches "
                  f"{stages}", flush=True)
            check(len(meter.calls) == 2 and stages == want_stage,
                  f"{name}: stage launches {meter.calls} != {want_stage}")
            check(counts == {k: sum(c[k] for c in stages.values())
                             for k in counts},
                  f"{name}: launches outside the two samplers: {counts}")
            check_designs(results, reqs, name)
            if (storage, label) == ("int8_matmul", f"{DESIGN_BATCH} records"):
                main_design = counts
        if profile_dir is not None and storage == "int8_matmul":
            profile_design(torch, eng, [pocket_record(*r) for r in requests],
                           profile_dir)
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
        want = {k: want_stage["structure"][k] + want_stage["sequence"][k]
                for k in counts}
        print(f"  cli run_pipeline ddim-{DDIM_STEPS} int8_matmul: {secs:.3f} "
              f"s including both models' build, "
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
    return main_design, seconds


def profile_design(torch, eng, records, out: Path):
    """Device busy share of one 32-record design batch, and its device
    time by stage: the structure sampler's kernels, the sequence
    sampler's, and the rest; the chrome trace goes to ``out``."""
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
    print(f"  profile, one design batch of {len(records)}: wall "
          f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"{100 * (1 - busy / wall_us):.1f}%")
    for e in prof.key_averages():
        if e.key in stages and e.device_type != cuda:
            print(f"  {e.key}: host {e.cpu_time_total / 1e3:.2f} ms, its "
                  f"kernels' device time "
                  f"{getattr(e, 'device_time_total', 0) / 1e3:.2f} ms")
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "design_batch_trace.json"))


def profile_sampler(torch, model, diffusion, batch, make_structure_sampler,
                    cast_inference_params, StructureDenoiser, enc, dec,
                    out: Path):
    """Device busy share and the kernels by device time over one DDIM-25
    run with int8 storage; the chrome trace goes to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    m = StructureDenoiser(enc, dec, device="cuda", seed=None)
    m.load_state_dict(model.state_dict(), strict=True)
    cast_inference_params(m, "int8_matmul")
    run = make_structure_sampler(m, diffusion, sampler="ddim",
                                 ddim_steps=DDIM_STEPS,
                                 return_trajectory=False)
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
    prof.export_chrome_trace(str(out / "ddim25_int8_trace.json"))


def print_port_kernels(rows):
    """The port's kernels among the profiler's (device us, calls, name)
    rows: their sum, then each one's time and time per call."""
    ours = [r for r in rows if re.search(
        r"\b(attention|layernorm)_\w+_kernel|column_sum_kernel", r[2])]
    print(f"  the port's kernels: {sum(r[0] for r in ours) / 1e3:.3f} ms "
          f"of device time in {sum(r[1] for r in ours)} calls")
    for dev, count, key in ours:
        print(f"  {dev / 1e3:9.3f} ms {count:7d}x  {dev / count:7.2f} us "
              f"per call  {key[:70]}")



def profile_train_steps(torch, kernels, out: Path, n_steps: int = 3):
    """Device busy share of ``n_steps`` structure train steps at the
    preset's full width (after 3 unprofiled ones), the kernels by device
    time, and the port's kernels' share; the chrome trace goes to
    ``out``."""
    from torch.profiler import ProfilerActivity, profile

    from e3diff_tpu_torch.training.run import build_trainer
    from e3diff_tpu_torch.utils.presets import structure_train_config

    cfg = structure_train_config(max_epochs=1)
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch, draws = train_batch(torch, cfg, gen, "structure")
    trainer = build_trainer("structure", cfg, "cuda", steps_per_epoch=10_000)
    for _ in range(3):
        trainer.train_step(batch, **draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            trainer.train_step(batch, **draws)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "device_time_total", 0), e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"  {n_steps} steps: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle {100 * (1 - busy / wall_us):.1f}%; per "
          f"step device busy {busy / 1e3 / n_steps:.2f} ms")
    for dev, count, key in rows[:15]:
        print(f"  {dev / 1e3:9.3f} ms {count:7d}x  {key[:90]}")
    print_port_kernels(rows)
    # random draws: the hidden Dropout modules' torch.rand (uniform) and the
    # attention cores' seeds (torch.randint); the keep bits themselves are
    # drawn inside the attention kernels
    draws = [r for r in rows if re.search(r"distribution|random|uniform",
                                          r[2], re.IGNORECASE)]
    print(f"  dropout draws: {sum(r[0] for r in draws) / 1e3 / n_steps:.3f} "
          f"ms a step in {sum(r[1] for r in draws) // n_steps} launches")
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "structure_train_trace.json"))
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
DROPOUT = 0.1
# The backward kernels against their plain versions, as the largest error
# over the largest |value| of the plain result. f32: both sum the same f32
# products in different orders (and the table gradient over (b, h) with
# atomics, in an order that changes from run to run): 1e-4. bf16: the same
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


def attention_train_check(torch, kernels, gen, case, dtype, p):
    """The training forward and the backward of one case against their
    plain versions (and, in f32, the backward against torch.autograd
    through the plain forward). Returns the errors of the output and of
    dQ."""
    dname = str(dtype).split(".")[-1]
    q, k, v, mask, tab = attention_inputs(torch, gen, case, dtype)
    kw = dict(num_heads=HEADS, max_pos=case.max_pos)
    seed = draw_seed(torch, gen) if p > 0 else None
    keep = None if seed is None else kernels.dropout_keep_plain(
        seed, (case.b, HEADS, case.lq, case.lk), p)
    tag = f"{case.label} {dname} p={p}"
    out, lse = kernels.fused_attention_train(q, k, v, mask, tab, seed, p,
                                             **kw)
    want_out, want_lse = kernels.attention_train_plain(q, k, v, mask, tab,
                                                       keep, p, **kw)
    torch.cuda.synchronize()
    tol = (ATTN_DEAD_F32_TOL if case.dead and dname == "float32"
           else ATTN_TOL[dname])
    out_err = compare(f"attention train fwd {tag}", out, want_out, *tol)
    compare(f"attention train lse {tag}", lse, want_lse, *LSE_TOL)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = kernels.attention_backward(dout, q, k, v, lse, mask, tab,
                                     seed, p, **kw)
    want = kernels.attention_backward_plain(dout, q, k, v, lse, mask,
                                            tab, keep, p, **kw)
    torch.cuda.synchronize()
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
            ctypes.c_void_p(seed.data_ptr()), *shape,
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


# exact launches of one train step: every attention core and LayerNorm of
# the forward (phases 6 and 8 count the same calls) through the training
# forward kernels, then each one's backward kernel; an eval step launches
# the inference kernels alone
PER_TRAIN_STEP = {
    "structure": {"fused_attention_train": 38, "fused_layernorm": 70,
                  "attention_backward": 38, "layernorm_backward": 70},
    "sequence": {"fused_attention_train": 15, "fused_layernorm": 32,
                 "attention_backward": 15, "layernorm_backward": 32}}
PER_EVAL_STEP = {"structure": {"fused_attention": 38, "fused_layernorm": 70},
                 "sequence": {"fused_attention": 15, "fused_layernorm": 32}}
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
        check(counts == with_zeros(kernels, PER_TRAIN_STEP[kind]),
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
          f"{PER_TRAIN_STEP[kind]}, per eval step {PER_EVAL_STEP[kind]}")
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
    # an EMA: twice a step's launches
    trainer = build_trainer(kind, dataclasses.replace(
        cfg, accum_steps=2, cond_dropout=0.1, ema_decay=0.999), "cuda", 1)
    kernels.reset_launch_counts()
    m = trainer.train_step(batch, **draws)
    counts = launch_counts(kernels)
    print(f"  {kind} step with accum_steps 2, cond_dropout 0.1, EMA: loss "
          f"{m['train_loss'].item():.4f}, grad_norm "
          f"{m['grad_norm'].item():.3f}, launches {counts}", flush=True)
    check(counts == with_zeros(kernels, {
        k: 2 * n for k, n in PER_TRAIN_STEP[kind].items()}),
        f"{kind} accumulated step: launches {counts}")
    check(all(math.isfinite(x.item()) for x in m.values()),
          f"{kind} accumulated step: not finite")
    del trainer
    torch.cuda.empty_cache()
    return totals, {"ms_per_step": step_s * 1e3,
                    "samples_per_s": TRAIN_B / step_s,
                    "max_memory_allocated_gib": peak / 2**30}


def train_cli_phase(torch, kernels):
    """Phase 9.5: both train CLIs at their presets, one epoch of synthetic
    complexes (one train and one validation batch of 64), into a temporary
    directory; then DesignEngine.from_checkpoints on the two final
    artifacts serves a design batch, held to phase 8's checks."""
    from e3diff_tpu_torch.cli.train_sequence import main as train_sequence
    from e3diff_tpu_torch.cli.train_structure import main as train_structure
    from e3diff_tpu_torch.serving import DesignEngine, pocket_record

    with tempfile.TemporaryDirectory() as tmp:
        for kind, cli in (("structure", train_structure),
                          ("sequence", train_sequence)):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            hist = cli(["--synthetic", "--synthetic_n", str(TRAIN_B * 5 // 4),
                        "--max_epochs", "1", "--ema_decay", "0.999",
                        "--ckpt_dir", f"{tmp}/{kind}"])
            secs = time.perf_counter() - t0
            counts = launch_counts(kernels)
            want = with_zeros(kernels, {
                k: PER_TRAIN_STEP[kind].get(k, 0) + PER_EVAL_STEP[kind].get(k, 0)
                for k in (*PER_TRAIN_STEP[kind], *PER_EVAL_STEP[kind])})
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
    want = with_zeros(kernels, {
        k: PER_ENCODE[k] + DDIM_STEPS * PER_STEP[k] + SEQ_T * PER_SEQ_FORWARD[k]
        for k in PER_STEP})
    print(f"  DesignEngine from the trained final.pt files: {DESIGN_BATCH} "
          f"designs in {secs:.3f} s, launches {counts}", flush=True)
    check(counts == want, f"trained engine: launches {counts} != {want}")
    check_designs(results, requests, "trained checkpoints")


if __name__ == "__main__":
    sys.exit(main())
