// Backward of the attention core (csrc/attention.cu's training forward).
//
// The Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_attention is
// forward-only; the JAX package trains through XLA's autodiff of its einsum
// attention (e3diff_tpu/models/blocks.py:154-165, probability dropout at
// :162). This is the counterpart of that autodiff for the port's kernel.
// Per (batch b, head h), with x = (q k^T + q . table[l - r + max_pos - 1]) *
// scale + mask the forward's logits, P = exp(x - lse), f = keep / (1 - p)
// (1 without dropout; keep redrawn from the forward's seed with the same
// Philox4x32-10 mapping, philox.cuh) and dO the output's gradient:
//   dV     = (P f)^T dO        (P f rounded to v's type, as the forward
//                               rounds it before P V)
//   dP     = (dO V^T) f
//   delta  = rowsum(P dP)      (= rowsum(dO O) for the exact O = (P f) V)
//   dS     = P (dP - delta) * scale
//   dQ     = dS K + sum_r dS[l, r] table[l - r + max_pos - 1]
//   dK     = dS^T Q
//   dtable[l - r + max_pos - 1] += sum_{b, h} dS[b, h, l, r] q[b, l, h, :]
// S and P are recomputed from q, k, the table window, the mask and the
// forward's row log-sum-exp, and the keep bits from the seed: nothing of
// size Lq x Lk is read or written. delta is summed from P and dP in f32,
// as autograd differentiates a softmax, not from the forward's output,
// which is rounded to bf16 in a bf16 run: then each row of dS sums to
// zero up to f32 rounding (bf16 rounding once the bf16 path rounds dS),
// and the gradient of a key bias, zero in exact arithmetic, stays at
// rounding noise.
//
// bf16 design (the main path trains in bf16): tensor cores, one kernel,
// attention_bwd_mma_kernel, one block per (h, b) (768 blocks at B=64,
// H=12), one warp per 16 query rows and, after a __syncthreads, per 16 keys.
// dS is rounded to bf16 before the products that take it (dQ, dK, the
// table), as JAX's bf16 autodiff of the einsum attention rounds it and as
// the plain version does; P f is rounded before dV, as before.
// - Staging: the head's 128-byte slices of Q, dO, K and V and the
//   Lq + Lk - 1 table rows the block reaches go to shared memory as bf16,
//   kRow apart (csrc/mma.cuh), with 16-byte cp.async copies all in flight
//   at once; the f32 mask row and the lse too. Padding rows (to 16 queries
//   and keys, and the table window's last k-step) are zeroed.
// - Query pass, warp w on queries 16w..16w+15: S = Q K^T on the tensor
//   cores; the relative bias as R = Q_tile E^T over the tile's window,
//   written to the warp's f32 scratch and gathered as attention.cu does;
//   P = exp(x - lse) in the accumulator fragments (0 on padded rows and
//   keys); dP = dO V^T on the tensor cores, times keep * drop_scale (the
//   fragment's keep bits drawn while the staging copies fly, keep_frag2); delta
//   by quad shuffles in f32; dS = P (dP - delta) scale, rounded to bf16,
//   used from registers as the A operand of dQ = dS K (K through
//   ldmatrix.trans). P f and dS, both bf16, are written over the warp's
//   bias scratch (its region: 16 rows of P f and 16 of dS, Lk_pad + 8
//   apart), where the key pass reads them: nothing is recomputed there,
//   and the lse and delta never leave the block (the delta argument is
//   the f32 kernels' scratch, unused here). The table term of dQ,
//   sum_e dS[l, l + Lk - 1 - e] E[e], is one more product whose A
//   fragments are gathered from the warp's dS rows along their diagonals,
//   against the window rows l0 .. l0 + Lk + 15.
// - Key pass, warp w on keys 16w..16w+15: dV = (P f)^T dO and
//   dK = dS^T Q, the A operands read transposed from the stored P f and
//   dS (ldmatrix.trans), over the query tiles.
// - Table gradient: warp w takes diagonal tiles m = 16w.., 16 diagonals
//   m = l - r + Lk - 1 each, as dtable[m] = sum_l dS[l, l - m + Lk - 1]
//   q[l]: A fragments gathered from the stored dS, B = Q rows through
//   ldmatrix.trans.
// - The table gradient is summed in a fixed order, so every run gives the
//   same bits (as a jitted JAX step does): a block takes head h and a group
//   of a.group consecutive batch rows, one after the other, and keeps the
//   group's f32 window in its own slice of dtable_part (the lane that owns
//   four elements stores them with one 16-byte store for the group's first
//   row and adds to them for each later row, in order); then
//   table_grad_sum_kernel adds the G x H slices in a fixed order. The
//   wrapper picks G so that G x H blocks fill the card once (at B = 64,
//   H = 12 and one block per SM: 11 groups of 6 rows, 8.6 MB of slices,
//   which stay in L2).
// Shared memory at Lq = Lk = 128 with the table: Q, dO, K, V 73.7 KB, the
// window 36.9 KB, the warps' regions 75.8 KB (the f32 bias scratch, 16 x
// 148 floats, is the larger of its two uses), mask and lse 1 KB: 187 KB,
// one block per SM. The f32 window of the table
// gradient is never staged: each warp's 16 x 64 tile of it goes from
// registers to the global atomics.
//
// f32 (chip_smoke.py's accuracy path and f32 training): CUDA-core FMA,
// two kernels on one stream:
// - attention_bwd_dq_kernel, one block per (h, b), one warp per query row:
//   K, V and the table window staged in shared memory as f32 (rows 68
//   floats apart, so a lane's float4 reads of its own key row fall in
//   distinct banks); lane j owns keys j, j+32, ..: it recomputes x, P and
//   dP for them (held in registers), the warp sums delta, the lane writes
//   dS to the warp's row buffer, then the warp sums dQ over the keys with
//   lanes on the 64 columns. It also writes delta for the second kernel.
// - attention_bwd_dkv_kernel, one block per (h, b), one warp per key row:
//   Q, dO and the table window staged; lane i owns queries i, i+32, ..: it
//   recomputes P and dS for its column, then the warp sums dK and dV over
//   the queries. With a table the block also keeps dS (Lq x Lk, f32) in
//   shared memory; once every column is done, each warp sums dS q along
//   its diagonals l - r = const, one table row each, and stores the row in
//   the (b, h) slice of dtable_part; table_grad_sum_kernel adds the B x H
//   slices in a fixed order.
// Bound: at the training shape (B=64, Lq=Lk=128, H=12, bf16) the bytes
// (q, k, v, dO read, dQ, dK, dV written, the lse) are ~89 MB, ~26 us at
// 3.35 TB/s; its 12.9 Gop (with the table) take 13 us
// at the bf16 tensor-core peak. The f32 kernels are held back by their
// arithmetic on CUDA cores; PERF.md has the bf16 kernel's time against
// the bound.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;          // head dim
constexpr int kMaxLen = 128;    // Lq, Lk <= kMaxLen
constexpr int kWarps = 8;       // warps per block
constexpr int kRowF = kD + 4;   // shared row stride in floats (float4-aligned)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* mask;
  const void* table;
  const int64_t* seed;  // dropout's Philox key, or null: no dropout
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dtable;
  float* dtable_part;  // (G, H, Lq + Lk - 1, 64) f32: G = ceil(B / group)
  int B, Lq, Lk, H, max_pos, group;
  // the block of the forward's dropout draw (philox.cuh, drop_bh)
  int drop_b0, drop_h0, drop_H;
  uint32_t threshold;
  float scale, drop_scale;
};

__device__ __forceinline__ float ld(const void* p, size_t i) {
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, float v) {
  static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// rows [0, n) of one head's 64-wide slice of a (., F) tensor -> shared f32
__device__ void stage_rows(float* dst, const void* src, size_t base, int n,
                           int F) {
  for (int c = threadIdx.x; c < n * kD; c += blockDim.x) {
    const int r = c / kD, d = c % kD;
    dst[r * kRowF + d] = ld(src, base + static_cast<size_t>(r) * F + d);
  }
}

// table rows max_pos - Lk .. max_pos + Lq - 2: Es[l - r + Lk - 1] is the row
// biasing query l against key r
__device__ void stage_table(float* dst, const BwdArgs& a, int ne) {
  const size_t first = static_cast<size_t>(a.max_pos - a.Lk) * kD;
  for (int c = threadIdx.x; c < ne * kD; c += blockDim.x)
    dst[(c / kD) * kRowF + c % kD] = ld(a.table, first + c);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

size_t dq_smem_bytes(int Lq, int Lk, bool table) {
  const int ne = table ? Lq + Lk - 1 : 0;
  return sizeof(float) *
         (static_cast<size_t>(2 * Lk + ne) * kRowF + round4(Lk) +
          kWarps * (2 * kD + kMaxLen));
}

size_t dkv_smem_bytes(int Lq, int Lk, bool table) {
  const int ne = table ? Lq + Lk - 1 : 0;
  return sizeof(float) *
         (static_cast<size_t>(2 * Lq + ne) * kRowF +
          (table ? round4(Lq * (Lk + 1)) : 0) + 2 * round4(Lq) +
          kWarps * (2 * kD + 2 * kMaxLen));
}

template <bool kTable>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int Lq = a.Lq, Lk = a.Lk, F = a.H * kD;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ne = kTable ? Lq + Lk - 1 : 0;
  float* Ks = sm;
  float* Vs = Ks + Lk * kRowF;
  float* Es = Vs + Lk * kRowF;
  float* Ms = Es + ne * kRowF;
  float* Ws = Ms + round4(Lk);

  const size_t kv_base = static_cast<size_t>(b) * Lk * F + h * kD;
  stage_rows(Ks, a.k, kv_base, Lk, F);
  stage_rows(Vs, a.v, kv_base, Lk, F);
  if (kTable) stage_table(Es, a, ne);
  for (int r = threadIdx.x; r < Lk; r += blockDim.x)
    Ms[r] = a.mask[static_cast<size_t>(b) * Lk + r];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = Ws + warp * (2 * kD + kMaxLen);  // the row's q
  float* gw = qw + kD;                         // the row's dO
  float* dsw = gw + kD;                        // the row's dS, by key
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const bool drop = a.seed != nullptr;
  const uint64_t dbh = drop_bh(b, h, a.drop_b0, a.drop_h0, a.drop_H);
  const PhiloxKey key = drop ? philox_key(a.seed) : PhiloxKey{0u, 0u};

  for (int l = warp; l < Lq; l += kWarps) {
    const size_t off = (static_cast<size_t>(b) * Lq + l) * F + h * kD;
    qw[lane] = ld(a.q, off + lane);
    qw[lane + 32] = ld(a.q, off + lane + 32);
    gw[lane] = ld(a.dout, off + lane);
    gw[lane + 32] = ld(a.dout, off + lane + 32);
    const float lse = a.lse[bh * Lq + l];
    __syncwarp();
    float p[kMaxLen / 32], dp[kMaxLen / 32], part = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      const int r = lane + 32 * j;
      p[j] = dp[j] = 0.f;
      if (r < Lk) {
        float s = dot64(qw, Ks + r * kRowF);
        if (kTable) s += dot64(qw, Es + (l - r + Lk - 1) * kRowF);
        p[j] = expf(s * a.scale + Ms[r] - lse);
        dp[j] = dot64(gw, Vs + r * kRowF);
        if (drop)
          dp[j] = dropout_keep(key, (dbh * Lq + l) * Lk + r, a.threshold)
                      ? dp[j] * a.drop_scale
                      : 0.f;
        part = fmaf(p[j], dp[j], part);
      }
    }
    const float delta = warp_sum(part);
    if (lane == 0) a.delta[bh * Lq + l] = delta;
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      const int r = lane + 32 * j;
      if (r < Lk) dsw[r] = p[j] * (dp[j] - delta) * a.scale;
    }
    __syncwarp();
    float acc0 = 0.f, acc1 = 0.f;
    for (int r = 0; r < Lk; ++r) {
      const float ds = dsw[r];
      acc0 = fmaf(ds, Ks[r * kRowF + lane], acc0);
      acc1 = fmaf(ds, Ks[r * kRowF + lane + 32], acc1);
      if (kTable) {
        const float* e = Es + (l - r + Lk - 1) * kRowF;
        acc0 = fmaf(ds, e[lane], acc0);
        acc1 = fmaf(ds, e[lane + 32], acc1);
      }
    }
    st(a.dq, off + lane, acc0);
    st(a.dq, off + lane + 32, acc1);
    __syncwarp();  // qw, gw and dsw are rewritten for the warp's next row
  }
}

template <bool kTable>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int Lq = a.Lq, Lk = a.Lk, F = a.H * kD;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ne = kTable ? Lq + Lk - 1 : 0;
  float* Qs = sm;
  float* Gs = Qs + Lq * kRowF;
  float* Es = Gs + Lq * kRowF;
  const int ss = Lk + 1;        // dS row stride: column writes hit 32 banks
  float* Ss = Es + ne * kRowF;  // dS, Lq x Lk, only with a table
  float* Ls = Ss + (kTable ? round4(Lq * ss) : 0);
  float* Ds = Ls + round4(Lq);
  float* Ws = Ds + round4(Lq);

  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t q_base = static_cast<size_t>(b) * Lq * F + h * kD;
  stage_rows(Qs, a.q, q_base, Lq, F);
  stage_rows(Gs, a.dout, q_base, Lq, F);
  if (kTable) stage_table(Es, a, ne);
  for (int l = threadIdx.x; l < Lq; l += blockDim.x) {
    Ls[l] = a.lse[bh * Lq + l];
    Ds[l] = a.delta[bh * Lq + l];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kw = Ws + warp * (2 * kD + 2 * kMaxLen);  // the key's k
  float* vw = kw + kD;                             // the key's v
  float* dsc = vw + kD;                            // dS[:, r], by query
  float* pdc = dsc + kMaxLen;                      // (P f)[:, r], by query
  const bool drop = a.seed != nullptr;
  const uint64_t dbh = drop_bh(b, h, a.drop_b0, a.drop_h0, a.drop_H);
  const PhiloxKey key = drop ? philox_key(a.seed) : PhiloxKey{0u, 0u};

  for (int r = warp; r < Lk; r += kWarps) {
    const size_t koff = (static_cast<size_t>(b) * Lk + r) * F + h * kD;
    kw[lane] = ld(a.k, koff + lane);
    kw[lane + 32] = ld(a.k, koff + lane + 32);
    vw[lane] = ld(a.v, koff + lane);
    vw[lane + 32] = ld(a.v, koff + lane + 32);
    const float mr = a.mask[static_cast<size_t>(b) * Lk + r];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxLen / 32; ++i) {
      const int l = lane + 32 * i;
      if (l < Lq) {
        float s = dot64(Qs + l * kRowF, kw);
        if (kTable) s += dot64(Qs + l * kRowF, Es + (l - r + Lk - 1) * kRowF);
        const float p = expf(s * a.scale + mr - Ls[l]);
        float f = 1.f;
        if (drop)
          f = dropout_keep(key, (dbh * Lq + l) * Lk + r, a.threshold)
                  ? a.drop_scale
                  : 0.f;
        const float dp = dot64(Gs + l * kRowF, vw) * f;
        const float ds = p * (dp - Ds[l]) * a.scale;
        dsc[l] = ds;
        if (kTable) Ss[l * ss + r] = ds;
        pdc[l] = p * f;
      }
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int l = 0; l < Lq; ++l) {
      const float ds = dsc[l], pd = pdc[l];
      const float qa = Qs[l * kRowF + lane], qb = Qs[l * kRowF + lane + 32];
      k0 = fmaf(ds, qa, k0);
      k1 = fmaf(ds, qb, k1);
      v0 = fmaf(pd, Gs[l * kRowF + lane], v0);
      v1 = fmaf(pd, Gs[l * kRowF + lane + 32], v1);
    }
    st(a.dk, koff + lane, k0);
    st(a.dk, koff + lane + 32, k1);
    st(a.dv, koff + lane, v0);
    st(a.dv, koff + lane + 32, v1);
    __syncwarp();  // kw, vw, dsc and pdc are rewritten for the next key
  }
  if (kTable) {
    // table row max_pos - Lk + m gathers the pairs l - r + Lk - 1 = m
    __syncthreads();
    float* dst = a.dtable_part + bh * ne * kD;
    for (int m = warp; m < ne; m += kWarps) {
      const int lo = max(0, m - (Lk - 1)), hi = min(Lq - 1, m);
      float t0 = 0.f, t1 = 0.f;
      for (int l = lo; l <= hi; ++l) {
        const float ds = Ss[l * ss + l - m + Lk - 1];
        t0 = fmaf(ds, Qs[l * kRowF + lane], t0);
        t1 = fmaf(ds, Qs[l * kRowF + lane + 32], t1);
      }
      dst[m * kD + lane] = t0;
      dst[m * kD + lane + 32] = t1;
    }
  }
}

// The table gradient from the kernels' slices: rows max_pos - Lk ..
// max_pos + Lq - 2 of dtable = the sum of the nparts (ne, 64) slices of
// part. A block takes 32 float4 columns; its threadIdx.y = c sums the
// slices c, c + kSumChunks, .. in order, then the chunks are added in the
// order c = 0, 1, ..: the same bits on every run.
constexpr int kSumChunks = 8;

__global__ void __launch_bounds__(32 * kSumChunks)
table_grad_sum_kernel(const float4* __restrict__ part, int nparts, int n4,
                      float4* __restrict__ dst) {
  __shared__ float4 chunk[kSumChunks][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
#pragma unroll 4
    for (int p = threadIdx.y; p < nparts; p += kSumChunks) {
      const float4 v = part[static_cast<size_t>(p) * n4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  chunk[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < n4) {
    for (int c = 1; c < kSumChunks; ++c) {
      const float4 v = chunk[c][threadIdx.x];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dst[i] = acc;
  }
}

// after the backward kernel(s): dtable's window from nparts slices
int launch_table_sum(const BwdArgs& a, int nparts, cudaStream_t stream) {
  const int n4 = (a.Lq + a.Lk - 1) * kD / 4;
  table_grad_sum_kernel<<<(n4 + 31) / 32, dim3(32, kSumChunks), 0,
                          stream>>>(
      reinterpret_cast<const float4*>(a.dtable_part), nparts, n4,
      reinterpret_cast<float4*>(a.dtable +
                                static_cast<size_t>(a.max_pos - a.Lk) * kD));
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_dq_kernel<kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem_bytes(kMaxLen, kMaxLen, kTable)));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(
        attention_bwd_dkv_kernel<kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkv_smem_bytes(kMaxLen, kMaxLen, kTable)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(a.H, a.B);
  attention_bwd_dq_kernel<kTable>
      <<<grid, kWarps * 32, dq_smem_bytes(a.Lq, a.Lk, kTable), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkv_kernel<kTable>
      <<<grid, kWarps * 32, dkv_smem_bytes(a.Lq, a.Lk, kTable), stream>>>(a);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || !kTable) return static_cast<int>(e2);
  return launch_table_sum(a, a.B * a.H, stream);
}

int launch_f32(const BwdArgs& a, cudaStream_t stream) {
  return a.table != nullptr ? launch_bwd<true>(a, stream)
                            : launch_bwd<false>(a, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;                 // query or key rows per warp
constexpr int kMaxTiles = kMaxLen / kTile;

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Shared memory of one block: Q, dO, K, V and the table window as bf16
// rows kRow apart; one region per query tile (the f32 bias scratch, then
// P f and dS); the f32 mask row and lse.
struct MmaLayout {
  int lq_pad, lk_pad, nr, nr16, e_rows, rs, ps, region;
  __host__ __device__ MmaLayout(int Lq, int Lk, bool table) {
    lq_pad = round16(Lq);
    lk_pad = round16(Lk);
    nr = (Lk + kTile - 1 + 7) / 8 * 8;  // bias columns a query tile reaches
    nr16 = round16(Lk + kTile - 1);     // the same, in k-steps of 16
    e_rows = table ? lq_pad - kTile + nr16 : 0;
    rs = nr + 4;
    ps = lk_pad + 8;                    // an odd multiple of 16 bytes
    const int pds = 2 * kTile * ps * 2;
    const int bias = table ? kTile * rs * 4 : 0;
    region = round16(pds > bias ? pds : bias);
  }
  __host__ __device__ size_t bf16_bytes() const {
    return static_cast<size_t>(2 * lq_pad + 2 * lk_pad + e_rows) * kRow * 2;
  }
  __host__ __device__ size_t bytes() const {
    return bf16_bytes() + static_cast<size_t>(lq_pad / kTile) * region +
           (lk_pad + lq_pad) * sizeof(float);
  }
};

// rows [0, n) of a 64-wide bf16 slice, src_stride apart, to shared rows
// kRow apart with 16-byte cp.async; rows [n, n_pad) zeroed
__device__ void stage_bf16(bf16* dst, const bf16* src, int n, int n_pad,
                           int src_stride) {
  for (int c = threadIdx.x; c < n_pad * 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    if (r < n)
      cp_async16(dst + r * kRow + col,
                 src + static_cast<size_t>(r) * src_stride + col);
    else
      *reinterpret_cast<uint4*>(dst + r * kRow + col) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ uint32_t bits_bf16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The backward of one (h, b); first: b is the first row of the block's
// group, whose table gradient starts the group's slice (later rows add to
// it).
template <int NK, bool kTable>
__device__ __forceinline__ void bwd_mma_row(const BwdArgs& a, int h, int b,
                                            bool first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lq = a.Lq, Lk = a.Lk, F = a.H * kD;
  const MmaLayout lay(Lq, Lk, kTable);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + lay.lq_pad * kRow;  // dO
  bf16* Ks = Gs + lay.lq_pad * kRow;
  bf16* Vs = Ks + lay.lk_pad * kRow;
  bf16* Es = Vs + lay.lk_pad * kRow;  // Es[e]: table row e + max_pos - Lk
  unsigned char* Ws = smem + lay.bf16_bytes();
  float* Ms = reinterpret_cast<float*>(Ws + (lay.lq_pad / kTile) * lay.region);
  float* Ls = Ms + lay.lk_pad;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t q_base = static_cast<size_t>(b) * Lq * F + h * kD;
  const size_t k_base = static_cast<size_t>(b) * Lk * F + h * kD;
  stage_bf16(Qs, static_cast<const bf16*>(a.q) + q_base, Lq, lay.lq_pad, F);
  stage_bf16(Gs, static_cast<const bf16*>(a.dout) + q_base, Lq, lay.lq_pad,
             F);
  stage_bf16(Ks, static_cast<const bf16*>(a.k) + k_base, Lk, lay.lk_pad, F);
  stage_bf16(Vs, static_cast<const bf16*>(a.v) + k_base, Lk, lay.lk_pad, F);
  if (kTable)
    stage_bf16(Es, static_cast<const bf16*>(a.table) +
                       static_cast<size_t>(a.max_pos - Lk) * kD,
               Lq + Lk - 1, lay.e_rows, kD);
  const float* mg = a.mask + static_cast<size_t>(b) * Lk;
  for (int r = tid; r < lay.lk_pad; r += nthr)
    Ms[r] = r < Lk ? mg[r] : -INFINITY;
  for (int l = tid; l < lay.lq_pad; l += nthr)
    Ls[l] = l < Lq ? a.lse[bh * Lq + l] : 0.f;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row, column pair
  const float scale = a.scale;
  // the query pass's dropout bits (4 bits per 8-key tile j at bit 4 j),
  // drawn while the copies are in flight
  const bool drop = a.seed != nullptr;
  uint64_t kb = 0;
  if (drop && warp * kTile < Lq)
    kb = keep_frags<NK>(
        a.seed,
        (drop_bh(b, h, a.drop_b0, a.drop_h0, a.drop_H) * Lq + warp * kTile +
         g) *
            static_cast<uint64_t>(Lk),
        Lk, t, a.threshold);
  cp_async_wait_all();
  __syncthreads();

  // ---- query pass: dQ, and P f and dS into the warp's region ----
  if (warp * kTile < Lq) {
    const int l0 = warp * kTile;
    bf16* Pw = reinterpret_cast<bf16*>(Ws + warp * lay.region);
    bf16* Sw = Pw + kTile * lay.ps;
    float* Rw = reinterpret_cast<float*>(Pw);  // bias, until P f is written

    // S = Q K^T over 2*NK tiles of 8 keys; element e of tile j is row
    // g + 8 (e >> 1), key 8 j + 2 t + (e & 1)
    float s[2 * NK][4];
    {
      uint32_t qa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(qa[kk],
                Qs + (l0 + (lane & 15)) * kRow + 16 * kk + 8 * (lane >> 4));
      if (kTable) {
        // R[i, c] = q[l0 + i] . Es[l0 + c], c < nr <= 16 NK + 16
#pragma unroll
        for (int n8 = 0; n8 < 2 * NK + 2; ++n8) {
          if (n8 >= lay.nr / 8) break;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_rows(acc, qa, Es + (l0 + 8 * n8) * kRow, lane);
          *reinterpret_cast<float2*>(Rw + g * lay.rs + 8 * n8 + 2 * t) =
              make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(Rw + (g + 8) * lay.rs + 8 * n8 + 2 * t) =
              make_float2(acc[2], acc[3]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        mma_rows(s[j], qa, Ks + 8 * j * kRow, lane);
      }
    }
    // P = exp(x - lse), x = (s + bias) scale + mask; 0 on padded rows
    const float lse_r[2] = {Ls[l0 + g], Ls[l0 + g + 8]};
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + 8 * (e >> 1), r = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if (kTable && r < Lk) x += Rw[i * lay.rs + i - r + Lk - 1];
        x = x * scale + Ms[r];
        s[j][e] = l0 + i < Lq ? expf(x - lse_r[e >> 1]) : 0.f;
      }
    }
    __syncwarp();  // the bias is read: P f and dS go over it

    // dP = (dO V^T) f; P f (bf16) to the region; delta = rowsum(P dP)
    float dp[2 * NK][4];
    {
      uint32_t ga[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(ga[kk],
                Gs + (l0 + (lane & 15)) * kRow + 16 * kk + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        mma_rows(dp[j], ga, Vs + 8 * j * kRow, lane);
      }
    }
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int r = 8 * j + 2 * t;
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (drop) {
        // P is 0 on padded rows and keys: their bits do not matter
        const uint32_t bits = static_cast<uint32_t>(kb >> (4 * j));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = (bits >> e & 1u) ? a.drop_scale : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] *= f[e];
        delta[e >> 1] = fmaf(s[j][e], dp[j][e], delta[e >> 1]);
      }
      *reinterpret_cast<uint32_t*>(Pw + g * lay.ps + r) =
          pack_bf16(s[j][0] * f[0], s[j][1] * f[1]);
      *reinterpret_cast<uint32_t*>(Pw + (g + 8) * lay.ps + r) =
          pack_bf16(s[j][2] * f[2], s[j][3] * f[3]);
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      delta[hr] += __shfl_xor_sync(0xffffffffu, delta[hr], 1);
      delta[hr] += __shfl_xor_sync(0xffffffffu, delta[hr], 2);
    }

    // dS = P (dP - delta) scale, rounded to bf16; dQ = dS K
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      float d[2][4];
#pragma unroll
      for (int hj = 0; hj < 2; ++hj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[hj][e] = s[2 * kk + hj][e] *
                     (dp[2 * kk + hj][e] - delta[e >> 1]) * scale;
      const uint32_t da[4] = {pack_bf16(d[0][0], d[0][1]),
                              pack_bf16(d[0][2], d[0][3]),
                              pack_bf16(d[1][0], d[1][1]),
                              pack_bf16(d[1][2], d[1][3])};
      const int c = 16 * kk + 2 * t;
      *reinterpret_cast<uint32_t*>(Sw + g * lay.ps + c) = da[0];
      *reinterpret_cast<uint32_t*>(Sw + (g + 8) * lay.ps + c) = da[1];
      *reinterpret_cast<uint32_t*>(Sw + g * lay.ps + c + 8) = da[2];
      *reinterpret_cast<uint32_t*>(Sw + (g + 8) * lay.ps + c + 8) = da[3];
      mma_depth16(o, da, Ks + 16 * kk * kRow, lane);
    }
    if (kTable) {
      // dQ[l0 + i] += sum_c dS[l0 + i, i - c + Lk - 1] Es[l0 + c]: A
      // fragments gathered from the warp's dS rows along their diagonals
      __syncwarp();
      for (int c0 = 0; c0 < lay.nr16; c0 += kTile) {
        uint32_t ea[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = g + 8 * (x & 1), c = c0 + 2 * t + 8 * (x >> 1);
          const int r = i - c + Lk - 1;  // key of column c; c + 1 is r - 1
          const uint32_t lo =
              (r >= 0 && r < Lk) ? bits_bf16(Sw + i * lay.ps + r) : 0u;
          const uint32_t hi =
              (r >= 1 && r <= Lk) ? bits_bf16(Sw + i * lay.ps + r - 1) : 0u;
          ea[x] = lo | (hi << 16);
        }
        mma_depth16(o, ea, Es + (l0 + c0) * kRow, lane);
      }
    }
    bf16* dq = static_cast<bf16*>(a.dq) + q_base;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int l = l0 + g + 8 * hr;
      if (l < Lq) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<uint32_t*>(dq + static_cast<size_t>(l) * F +
                                       8 * n + 2 * t) =
              pack_bf16(o[n][2 * hr], o[n][2 * hr + 1]);
      }
    }
  }
  __syncthreads();

  // ---- key pass: dV = (P f)^T dO, dK = dS^T Q ----
  if (warp * kTile < Lk) {
    const int r0 = warp * kTile;
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    // the lane's ldmatrix.trans row: query 8 (lane >> 4) + (lane & 7) of
    // the tile, keys from r0 + 8 ((lane >> 3) & 1); the four 8x8 blocks
    // (q, r), (q, r + 8), (q + 8, r), (q + 8, r + 8) transposed are the A
    // fragment of the 16 keys x 16 queries tile
    const int qr = (lane & 7) + 8 * (lane >> 4);
    const int kc = r0 + 8 * ((lane >> 3) & 1);
    for (int q0 = 0; q0 < lay.lq_pad; q0 += kTile) {
      const bf16* P =
          reinterpret_cast<const bf16*>(Ws + (q0 / kTile) * lay.region);
      uint32_t pa[4], sa[4];
      ldsm_x4_trans(pa, P + qr * lay.ps + kc);
      ldsm_x4_trans(sa, P + (kTile + qr) * lay.ps + kc);
      mma_depth16(dv, pa, Gs + q0 * kRow, lane);
      mma_depth16(dk, sa, Qs + q0 * kRow, lane);
    }
    bf16* dkg = static_cast<bf16*>(a.dk) + k_base;
    bf16* dvg = static_cast<bf16*>(a.dv) + k_base;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + g + 8 * hr;
      if (r < Lk) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const size_t off = static_cast<size_t>(r) * F + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(dkg + off) =
              pack_bf16(dk[n][2 * hr], dk[n][2 * hr + 1]);
          *reinterpret_cast<uint32_t*>(dvg + off) =
              pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
        }
      }
    }
  }

  // ---- table gradient: dtable[m] = sum_l dS[l, l - m + Lk - 1] q[l] ----
  if (kTable) {
    const int ne = Lq + Lk - 1;
    float* dst = a.dtable_part +
                 (static_cast<size_t>(blockIdx.y) * a.H + h) * ne * kD;
    // the stored dS of query row l
    auto ds_row = [&](int l) {
      return reinterpret_cast<const bf16*>(Ws + (l / kTile) * lay.region) +
             (kTile + l % kTile) * lay.ps;
    };
    for (int m0 = warp * kTile; m0 < ne; m0 += nthr / 32 * kTile) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      const int lo = max(0, m0 - Lk + 1) & ~(kTile - 1);
      const int hi = min(Lq - 1, m0 + kTile - 1);
      for (int c0 = lo; c0 <= hi; c0 += kTile) {
        uint32_t ta[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = m0 + g + 8 * (x & 1), l = c0 + 2 * t + 8 * (x >> 1);
          const int r = l - m + Lk - 1;  // key of query l; query l + 1: r + 1
          const uint32_t x0 =
              (r >= 0 && r < Lk) ? bits_bf16(ds_row(l) + r) : 0u;
          const uint32_t x1 =
              (r >= -1 && r < Lk - 1) ? bits_bf16(ds_row(l + 1) + r + 1) : 0u;
          ta[x] = x0 | (x1 << 16);
        }
        mma_depth16(acc, ta, Qs + c0 * kRow, lane);
      }
      // lanes t and t ^ 1 trade halves so that each owns four adjacent
      // columns, one 16-byte store: even t row g, columns 2t..2t+3; odd t
      // row g + 8, columns 2t-2..2t+1
      const bool odd = t & 1;
      const int m = m0 + g + (odd ? 8 : 0);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float x0 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[n][0] : acc[n][2], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu,
                                         odd ? acc[n][1] : acc[n][3], 1);
        float4 v = odd ? make_float4(x0, x1, acc[n][2], acc[n][3])
                       : make_float4(acc[n][0], acc[n][1], x0, x1);
        if (m < ne) {
          float4* p = reinterpret_cast<float4*>(
              dst + static_cast<size_t>(m) * kD + 8 * n + 2 * (t & ~1));
          if (!first) {
            const float4 o = *p;  // this lane's own store for row b - 1
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          *p = v;
        }
      }
    }
  }
}

// blockIdx.x = h; blockIdx.y = the group of batch rows
// [a.group * blockIdx.y, a.group * (blockIdx.y + 1)), taken in order
template <int NK, bool kTable>
__global__ void __launch_bounds__(kMaxTiles * 32)
attention_bwd_mma_kernel(BwdArgs a) {
  const int b0 = blockIdx.y * a.group;
  const int b1 = min(a.B, b0 + a.group);
  for (int b = b0; b < b1; ++b) {
    if (b > b0) __syncthreads();  // shared memory is staged anew
    bwd_mma_row<NK, kTable>(a, blockIdx.x, b, b == b0);
  }
}

// Launches the kernel over groups of a.group rows (and, with a table, the
// sum of its slices); with blocks_per_sm, reports the kernel's resident
// blocks per SM at this shape instead of launching.
template <int NK, bool kTable>
int launch_bwd_mma(const BwdArgs& a, cudaStream_t stream,
                   int* blocks_per_sm) {
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    const size_t most = MmaLayout(kMaxLen, NK * kTile, kTable).bytes();
    const cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_mma_kernel<NK, kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const MmaLayout lay(a.Lq, a.Lk, kTable);
  const int rows = lay.lq_pad > lay.lk_pad ? lay.lq_pad : lay.lk_pad;
  if (blocks_per_sm != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, attention_bwd_mma_kernel<NK, kTable>,
        rows / kTile * 32, lay.bytes()));
  const int groups = (a.B + a.group - 1) / a.group;
  attention_bwd_mma_kernel<NK, kTable>
      <<<dim3(a.H, groups), rows / kTile * 32, lay.bytes(), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !kTable) return static_cast<int>(e);
  return launch_table_sum(a, groups * a.H, stream);
}

template <int NK>
int launch_bwd_mma_nk(const BwdArgs& a, cudaStream_t stream,
                      int* blocks_per_sm) {
  return a.table != nullptr
             ? launch_bwd_mma<NK, true>(a, stream, blocks_per_sm)
             : launch_bwd_mma<NK, false>(a, stream, blocks_per_sm);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_bf16(const BwdArgs& a, cudaStream_t stream,
                int* blocks_per_sm = nullptr) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
        aligned16(a.dout) && aligned16(a.table)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch ((a.Lk + kTile - 1) / kTile) {
    case 1: return launch_bwd_mma_nk<1>(a, stream, blocks_per_sm);
    case 2: return launch_bwd_mma_nk<2>(a, stream, blocks_per_sm);
    case 3: return launch_bwd_mma_nk<3>(a, stream, blocks_per_sm);
    case 4: return launch_bwd_mma_nk<4>(a, stream, blocks_per_sm);
    case 5: return launch_bwd_mma_nk<5>(a, stream, blocks_per_sm);
    case 6: return launch_bwd_mma_nk<6>(a, stream, blocks_per_sm);
    case 7: return launch_bwd_mma_nk<7>(a, stream, blocks_per_sm);
    case 8: return launch_bwd_mma_nk<8>(a, stream, blocks_per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dq, dout: (B, Lq, H*64); k, v, dk, dv: (B, Lk, H*64), all in one
// element type (dtype); mask: (B, Lk) f32 additive; table:
// (2*max_pos-1, 64) in the element type, or null (then dtable and
// dtable_part are unused); seed: the forward's 2 int64 on the card, or null
// for no dropout, with its block (drop_b0, drop_h0, drop_H, as
// e3d_attention_train takes it), threshold and drop_scale; lse: (B, H, Lq) f32
// from the training forward; delta: (B, H, Lq) f32 scratch; dtable:
// (2*max_pos-1, 64) f32, zeroed by the caller, whose rows max_pos - Lk ..
// max_pos + Lq - 2 are written; dtable_part: (ceil(B / group), H,
// Lq + Lk - 1, 64) f32 scratch, one slice per block; group: batch rows per
// block (1 in f32). The bf16 path needs 16-byte aligned q, k, v, dout and
// table. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int e3d_attention_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* table, const void* seed,
    const void* lse, void* delta, void* dq, void* dk, void* dv, void* dtable,
    void* dtable_part, int B, int Lq, int Lk, int H, int max_pos, int group,
    int drop_b0, int drop_h0, int drop_H, uint32_t threshold,
    float drop_scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lq > kMaxLen || Lk <= 0 ||
      Lk > kMaxLen || group <= 0 || (dtype == kF32 && group != 1) ||
      drop_b0 < 0 || drop_h0 < 0 || drop_h0 + H > drop_H)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table != nullptr && (Lq > max_pos || Lk > max_pos || dtable == nullptr ||
                           dtable_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(mask), table,
                  static_cast<const int64_t*>(seed),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, static_cast<float*>(dtable),
                  static_cast<float*>(dtable_part), B, Lq, Lk, H, max_pos,
                  group, drop_b0, drop_h0, drop_H, threshold,
                  1.0f / sqrtf(static_cast<float>(kD)), drop_scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_f32(a, s);
  if (dtype == kBF16) return launch_bf16(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the bf16 backward at (Lq, Lk), with or without
// the table (cudaOccupancyMaxActiveBlocksPerMultiprocessor), from which the
// wrapper picks the batch rows per block.
extern "C" int e3d_attention_backward_occupancy(int Lq, int Lk, int table,
                                                int* blocks_per_sm) {
  if (Lq <= 0 || Lq > kMaxLen || Lk <= 0 || Lk > kMaxLen ||
      blocks_per_sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // only the pointers' presence and alignment matter
  alignas(16) static const bf16 dummy[8] = {};
  BwdArgs a{};
  a.q = a.k = a.v = a.dout = dummy;
  a.table = table ? dummy : nullptr;
  a.B = a.H = a.group = a.drop_H = 1;
  a.Lq = Lq;
  a.Lk = Lk;
  a.max_pos = kMaxLen;
  return launch_bf16(a, nullptr, blocks_per_sm);
}
