// Multi-head attention core with the HF relative_key bias, flat layout.
//
// Replaces the Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_attention
// (body _attention_kernel). Per head h: s = q_h k_h^T (+ sum_d q[l,d] *
// table[l - r + max_pos - 1, d]), then s / sqrt(D) + mask[b, r], an f32
// softmax, P cast to v's type, and P V. q, k, v and the output are the flat
// (B, L, H*64) tensors the projections produce: no head transpose is ever
// written to device memory. The kernel gathers rows of the per-layer
// (2*max_pos-1, 64) distance table itself, where the Pallas kernel reads a
// materialised (Lq, Lk, D) position tensor.
//
// What bounds it. By its bytes the decoder's self-attention (B=32,
// Lq=Lk=16, H=12, bf16: 3.15 MB) could run in under 1 us; what held the
// first, scalar version at 15-80 us was latency with little work in flight:
// 2-byte loads converted one by one into f32 shared memory, then serial
// 64-long FMA chains per key for the scores, the bias and P V.
//
// bf16 design (the main path computes in bf16 in every storage mode).
// - Grid: one block per (head, batch row), one warp per 16 query rows
//   (mma's M). At B=32: the decoder's two shapes launch 384 one-warp
//   blocks, the encoder's 384 four-warp blocks; under CFG (B=64) 768.
//   The 132 SMs hold them in one wave.
// - Staging: the head's 128-byte slices of the Q, K and V rows, and the
//   Lq + Lk - 1 table rows the block reaches, go to shared memory as bf16
//   with 16-byte cp.async copies, all in flight at once (the f32 mask row
//   too, where Lk is a multiple of 4), then one cp.async.wait_group.
//   Rows are 72 bf16 (144 B) apart, so the eight row addresses of an
//   ldmatrix phase fall in eight different 16-byte bank groups. Padding
//   rows (to 16 queries and keys) are zeroed.
//   TMA is not used: it needs a tensor map (cuTensorMapEncodeTiled)
//   for each call's pointers, and for tiles of 2-36 KB one issuing thread
//   buys nothing over 32 lanes of cp.async.
// - Products: mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate), the
//   operands loaded with ldmatrix (ldmatrix.trans for V). wgmma is not
//   used: it takes 64-row tiles per four-warp group, and the decoder, the
//   shape that runs 25 times a step, has 16 query rows per (b, h).
// - Relative bias on the tensor cores: R = Q_tile E^T over the window of
//   Lk + 15 table rows a 16-row tile reaches (rounded up to 8), written to
//   the warp's f32 scratch in shared memory; S[l, r] then gathers
//   R[l, l - r + Lk - 1]. It is the same sum as the plain version's
//   sum_d q[l,d] table[l - r + max_pos - 1, d]: bf16 products are exact in
//   f32, so only the order of the additions differs.
// - Softmax on the accumulator fragments: scale, f32 mask (-inf beyond
//   Lk), row max and sum across the four lanes of a quad by shuffles, expf
//   in f32, P rounded to bf16 as the Pallas body does, then used in
//   registers as the A operand of P V.
// - Output: the f32 accumulators as bf16 into the warp's own Q rows in
//   shared memory, then 16-byte stores of the flat (B, Lq, H*64) rows.
// The key count is a template parameter (16-row key tiles, 1..8), so the
// score and output fragments stay in registers.
//
// f32 (chip_smoke.py's accuracy checks and f32 training): CUDA-core FMA in
// f32, no TF32, one block per (head, batch), K, V and table rows staged as
// f32 with a 65-float row stride, each warp on its own query rows.
//
// Training variant (template flag kTrain of both kernels, entry
// e3d_attention_train): the same kernels, and in addition they write each
// query row's log-sum-exp of the scaled, masked scores (f32, (B, H, Lq)) for
// the backward (attention_backward.cu), and, given a seed (a 2-element int64
// device tensor, or null for no dropout), multiply the f32 softmax P by
// keep / (1 - p) before P V, as flax's Dropout does to the probabilities
// (e3diff_tpu/models/blocks.py:162). The keep bits are drawn in the kernel
// with Philox4x32-10 (philox.cuh: one mapping for the forward, the backward
// and the plain version), so no (B, H, Lq, Lk) mask is written, read or
// kept for the backward. The inference entry e3d_attention launches the
// kTrain = false instances, unchanged.
//
// What bounds the training forward. At B=64, Lq=Lk=128, H=12 it moves
// q, k, v, the output, the mask and the table window (50.8 MB, 15.2 us at
// 3.35 TB/s) for 3.8 Gop on the tensor cores (4 us), and draws one Philox
// call per eight probabilities (1.6 M calls of ~100 integer instructions).
// The bf16 instances hide the draws behind the staging copies: each lane
// draws the keep bits of its score fragments (64 bits for 128 keys,
// philox.cuh::keep_frags) after issuing its cp.async copies and before
// waiting for them. Without the table the query rows split over blocks of
// 64 (grid (Lq / 64, H, B), so the blocks of one (b, h), which read the
// same K and V, run together): 47 KB of shared memory and 156 registers a
// thread let three blocks share an SM, so one block's staging overlaps
// another's products. With the table a block keeps all 128 rows (168 KB,
// one block per SM), which measured faster than two blocks of 64 rows.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim
constexpr int kMaxLen = 128;   // Lq, Lk <= kMaxLen

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;               // query rows per warp (mma M)
constexpr int kMaxWarps = kMaxLen / kTile;
// query rows per training block: 64 without the table (three blocks share
// an SM), all 128 with it (one block of 8 warps per SM measured faster on
// the H100 than two 64-row blocks, which stage the table window twice)
__host__ __device__ constexpr int train_rows(bool table) {
  return table ? 128 : 64;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;
  const bf16* table;
  bf16* out;
  int B, Lq, Lk, H, max_pos;
  // training only: dropout seed (or null: no dropout), row log-sum-exp out
  const int64_t* seed;
  float* lse;
  uint32_t threshold;  // keep iff the 16-bit Philox draw >= threshold
  float drop_scale;    // 1 / (1 - p)
};

// query rows a block covers: all of them, or train_rows for training
template <bool kTrain, bool kTable>
__host__ __device__ inline int block_rows(int Lq) {
  const int lq_pad = (Lq + kTile - 1) / kTile * kTile;
  return kTrain && lq_pad > train_rows(kTable) ? train_rows(kTable) : lq_pad;
}

// Shared memory of one block: Q, K, V and table rows as bf16, then the
// f32 mask row and, with a table, each warp's 16 x rs relative-bias scratch.
struct Layout {
  bool table;
  int lq_pad, lk_pad, nr, e_rows, rs;
  __host__ __device__ Layout(int Lq, int Lk, bool with_table) {
    table = with_table;
    lq_pad = (Lq + kTile - 1) / kTile * kTile;
    lk_pad = (Lk + 15) / 16 * 16;
    nr = (Lk + kTile - 1 + 7) / 8 * 8;  // bias columns a query tile reaches
    e_rows = table ? lq_pad - kTile + nr : 0;
    rs = nr + 4;
  }
  __host__ __device__ size_t bf16_elems() const {
    return static_cast<size_t>(lq_pad + 2 * lk_pad + e_rows) * kRow;
  }
  __host__ __device__ size_t bytes() const {
    return bf16_elems() * sizeof(bf16) + lk_pad * sizeof(float) +
           (table ? static_cast<size_t>(lq_pad) * rs * sizeof(float) : 0);
  }
};

template <int NK, bool kTable, bool kTrain>
__global__ void __launch_bounds__(kTrain ? train_rows(kTable) / kTile * 32
                                         : kMaxWarps * 32)
attention_mma_kernel(Args a, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lq = a.Lq, Lk = a.Lk;
  // grid (H, B) at inference; (query blocks, H, B) in training, so that
  // the blocks of one (b, h), which read the same K and V, run together
  const int h = kTrain ? blockIdx.y : blockIdx.x;
  const int b = kTrain ? blockIdx.z : blockIdx.y;
  // the block's queries: q0 .. q0 + nq - 1 (all of them at inference)
  const int q0 = kTrain ? blockIdx.x * train_rows(kTable) : 0;
  const int nq = kTrain ? min(train_rows(kTable), Lq - q0) : Lq;
  const Layout lay(block_rows<kTrain, kTable>(Lq), Lk, kTable);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lay.lq_pad * kRow;
  bf16* Vs = Ks + lay.lk_pad * kRow;
  bf16* Es = Vs + lay.lk_pad * kRow;
  float* Ms = reinterpret_cast<float*>(Qs + lay.bf16_elems());
  float* Rs = Ms + lay.lk_pad;

  const int F = a.H * kD;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bf16* qg = a.q + (static_cast<size_t>(b) * Lq + q0) * F + h * kD;
  const bf16* kg = a.k + static_cast<size_t>(b) * Lk * F + h * kD;
  const bf16* vg = a.v + static_cast<size_t>(b) * Lk * F + h * kD;

  // stage: 16-byte chunks, 8 per 64-wide row, every copy in flight at once
  for (int c = tid; c < nq * 8; c += nthr) {
    const int r = c >> 3, col = (c & 7) * 8;
    cp_async16(Qs + r * kRow + col, qg + static_cast<size_t>(r) * F + col);
  }
  for (int c = tid; c < Lk * 8; c += nthr) {
    const int r = c >> 3, col = (c & 7) * 8;
    const size_t g = static_cast<size_t>(r) * F + col;
    cp_async16(Ks + r * kRow + col, kg + g);
    cp_async16(Vs + r * kRow + col, vg + g);
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (kTable) {
    // the block's offsets l - r + max_pos - 1 span [max_pos - Lk + q0,
    // max_pos + q0 + nq - 2]; Es[l - q0 - r + Lk - 1] holds table row
    // l - r + max_pos - 1
    const bf16* eg = a.table + static_cast<size_t>(a.max_pos - Lk + q0) * kD;
    const int e_valid = nq + Lk - 1;
    for (int c = tid; c < e_valid * 8; c += nthr) {
      const int r = c >> 3, col = (c & 7) * 8;
      cp_async16(Es + r * kRow + col, eg + r * kD + col);
    }
    for (int c = tid; c < (lay.e_rows - e_valid) * 8; c += nthr) {
      const int r = e_valid + (c >> 3), col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(Es + r * kRow + col) = zero;
    }
  }
  for (int c = tid; c < (lay.lq_pad - nq) * 8; c += nthr) {
    const int r = nq + (c >> 3), col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(Qs + r * kRow + col) = zero;
  }
  for (int c = tid; c < (lay.lk_pad - Lk) * 8; c += nthr) {
    const int r = Lk + (c >> 3), col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(Ks + r * kRow + col) = zero;
    *reinterpret_cast<uint4*>(Vs + r * kRow + col) = zero;
  }
  const float* mg = a.mask + static_cast<size_t>(b) * Lk;
  if (Lk % 4 == 0 && reinterpret_cast<uintptr_t>(mg) % 16 == 0) {
    for (int c = tid; c < Lk / 4; c += nthr) cp_async16(Ms + 4 * c, mg + 4 * c);
    for (int r = Lk + tid; r < lay.lk_pad; r += nthr) Ms[r] = -INFINITY;
  } else {
    for (int r = tid; r < lay.lk_pad; r += nthr)
      Ms[r] = r < Lk ? mg[r] : -INFINITY;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int l0 = warp * kTile;
  const int g = lane >> 2, t = lane & 3;  // fragment row, column pair
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  // training: the dropout bits of the lane's score fragments (4 bits per
  // 8-key tile j at bit 4 j), drawn while the copies are in flight
  uint64_t kb = 0;
  if (kTrain && a.seed != nullptr)
    kb = keep_frags<NK>(a.seed,
                        (bh * Lq + q0 + l0 + g) * static_cast<uint64_t>(Lk),
                        Lk, t, a.threshold);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qa[4][4];  // A fragments of the warp's 16 query rows, depth 64
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(qa[kk], Qs + (l0 + (lane & 15)) * kRow + 16 * kk + 8 * (lane >> 4));

  float* Rw = Rs + warp * kTile * lay.rs;
  if (kTable) {
    // R[i, c] = q[l0 + i] . Es[l0 + c], c < nr <= 16 NK + 16; unrolled to
    // that bound so that the tiles' mma chains overlap
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

  // S = Q K^T over 2*NK tiles of 8 keys; element e of tile j is row
  // g + 8 (e >> 1), key 8 j + 2 t + (e & 1)
  float s[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows(s[j], qa, Ks + 8 * j * kRow, lane);
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + 8 * (e >> 1), r = 8 * j + 2 * t + (e & 1);
      float x = s[j][e];
      if (kTable && r < Lk) x += Rw[i * lay.rs + i - r + Lk - 1];
      x = x * scale + Ms[r];
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    inv[hr] = 1.f / sum[hr];
  }
  if (kTrain) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int l = l0 + g + 8 * hr;
      if (t == 0 && l < nq) a.lse[bh * Lq + q0 + l] = mx[hr] + logf(sum[hr]);
    }
    // P = s / sum, then dropped: P keep / (1 - p); the factor folds into s.
    // Keys past Lk already hold P = 0, rows past nq are never stored.
    if (a.seed != nullptr) {
      const float kept[2] = {inv[0] * a.drop_scale, inv[1] * a.drop_scale};
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        const uint32_t bits = static_cast<uint32_t>(kb >> (4 * j));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] *= (bits >> e & 1u) ? kept[e >> 1] : 0.f;
      }
      inv[0] = inv[1] = 1.f;
    }
  }

  // O = P V: P (rounded to bf16) straight from the score fragments
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const float(&lo)[4] = s[2 * kk];
    const float(&hi)[4] = s[2 * kk + 1];
    const uint32_t pa[4] = {
        pack_bf16(lo[0] * inv[0], lo[1] * inv[0]),
        pack_bf16(lo[2] * inv[1], lo[3] * inv[1]),
        pack_bf16(hi[0] * inv[0], hi[1] * inv[0]),
        pack_bf16(hi[2] * inv[1], hi[3] * inv[1])};
    mma_depth16(o, pa, Vs + 16 * kk * kRow, lane);  // keys 16 kk + 0..15
  }

  // the warp's Q rows are free once qa is loaded: stage the output there
  bf16* Ow = Qs + l0 * kRow;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(Ow + g * kRow + 8 * n + 2 * t) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(Ow + (g + 8) * kRow + 8 * n + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  bf16* og = a.out + (static_cast<size_t>(b) * Lq + q0) * F + h * kD;
#pragma unroll
  for (int c = lane; c < kTile * 8; c += 32) {
    const int r = c >> 3, col = (c & 7) * 8;
    if (l0 + r < nq)
      *reinterpret_cast<uint4*>(og + static_cast<size_t>(l0 + r) * F + col) =
          *reinterpret_cast<const uint4*>(Ow + r * kRow + col);
  }
}

// Launches the instance for a's shape; with ``occupancy`` set, writes the
// instance's resident blocks per SM there instead of launching.
template <int NK, bool kTable, bool kTrain>
int launch_mma(const Args& a, cudaStream_t stream, int* occupancy) {
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    const size_t most =
        Layout(block_rows<kTrain, kTable>(kMaxLen), NK * 16, kTable).bytes();
    cudaError_t e = cudaFuncSetAttribute(
        attention_mma_kernel<NK, kTable, kTrain>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int rows = block_rows<kTrain, kTable>(a.Lq);
  const Layout lay(rows, a.Lk, kTable);
  if (occupancy != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, attention_mma_kernel<NK, kTable, kTrain>,
        rows / kTile * 32, lay.bytes()));
  const dim3 grid = kTrain ? dim3((a.Lq + rows - 1) / rows, a.H, a.B)
                          : dim3(a.H, a.B);
  attention_mma_kernel<NK, kTable, kTrain>
      <<<grid, rows / kTile * 32, lay.bytes(), stream>>>(
          a, 1.0f / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
}

template <int NK, bool kTrain>
int launch_mma_nk(const Args& a, cudaStream_t stream, int* occupancy) {
  return a.table != nullptr
             ? launch_mma<NK, true, kTrain>(a, stream, occupancy)
             : launch_mma<NK, false, kTrain>(a, stream, occupancy);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kTrain>
int launch_bf16(const Args& a, cudaStream_t stream,
                int* occupancy = nullptr) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
        aligned16(a.table) && aligned16(a.out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch ((a.Lk + 15) / 16) {
    case 1: return launch_mma_nk<1, kTrain>(a, stream, occupancy);
    case 2: return launch_mma_nk<2, kTrain>(a, stream, occupancy);
    case 3: return launch_mma_nk<3, kTrain>(a, stream, occupancy);
    case 4: return launch_mma_nk<4, kTrain>(a, stream, occupancy);
    case 5: return launch_mma_nk<5, kTrain>(a, stream, occupancy);
    case 6: return launch_mma_nk<6, kTrain>(a, stream, occupancy);
    case 7: return launch_mma_nk<7, kTrain>(a, stream, occupancy);
    case 8: return launch_mma_nk<8, kTrain>(a, stream, occupancy);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;      // warps per block, each on its own query rows
constexpr int kStride = kD + 1;

size_t f32_smem_bytes(int Lq, int Lk, bool with_table) {
  size_t floats = 2 * static_cast<size_t>(Lk) * kStride   // K, V
                  + kWarps * kD                           // one q row per warp
                  + kWarps * kMaxLen;                     // one P row per warp
  if (with_table) floats += static_cast<size_t>(Lq + Lk - 1) * kStride;
  return floats * sizeof(float);
}

template <bool kTrain>
__global__ void __launch_bounds__(kWarps * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ table, float* __restrict__ out,
                     int Lq, int Lk, int H, int max_pos, float scale,
                     const int64_t* __restrict__ seed,
                     float* __restrict__ lse, uint32_t threshold,
                     float drop_scale) {
  extern __shared__ float fsmem[];
  float* Ks = fsmem;
  float* Vs = Ks + Lk * kStride;
  float* Qs = Vs + Lk * kStride;
  float* Ps = Qs + kWarps * kD;
  float* Es = Ps + kWarps * kMaxLen;  // only with a table

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int F = H * kD;
  const size_t kv_base = static_cast<size_t>(b) * Lk * F + h * kD;

  for (int i = threadIdx.x; i < Lk * kD; i += blockDim.x) {
    const int r = i / kD, d = i % kD;
    const size_t g = kv_base + static_cast<size_t>(r) * F + d;
    Ks[r * kStride + d] = k[g];
    Vs[r * kStride + d] = v[g];
  }
  if (table != nullptr) {
    const int first = max_pos - Lk;
    for (int i = threadIdx.x; i < (Lq + Lk - 1) * kD; i += blockDim.x) {
      const int r = i / kD, d = i % kD;
      Es[r * kStride + d] = table[static_cast<size_t>(first + r) * kD + d];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const PhiloxKey key = kTrain && seed != nullptr ? philox_key(seed)
                                                  : PhiloxKey{0u, 0u};
  float* qw = Qs + warp * kD;
  float* pw = Ps + warp * kMaxLen;
  const float* mrow = mask + static_cast<size_t>(b) * Lk;

  for (int l = warp; l < Lq; l += kWarps) {
    const size_t q_off = (static_cast<size_t>(b) * Lq + l) * F + h * kD;
    qw[lane] = q[q_off + lane];
    qw[lane + 32] = q[q_off + lane + 32];
    __syncwarp();

    float s[kMaxLen / 32];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      const int r = lane + 32 * j;
      s[j] = -INFINITY;
      if (r < Lk) {
        const float* kr = Ks + r * kStride;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) dot = fmaf(qw[d], kr[d], dot);
        if (table != nullptr) {
          const float* er = Es + (l - r + Lk - 1) * kStride;
          float rel = 0.f;
#pragma unroll 16
          for (int d = 0; d < kD; ++d) rel = fmaf(qw[d], er[d], rel);
          dot += rel;
        }
        s[j] = dot * scale + mrow[r];
        m = fmaxf(m, s[j]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      if (lane + 32 * j < Lk) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    sum = warp_sum(sum);
    const size_t row = (static_cast<size_t>(b) * H + h) * Lq + l;
    if (kTrain && lane == 0) lse[row] = m + logf(sum);
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      const int r = lane + 32 * j;
      if (r < Lk) {
        float p = s[j] / sum;
        if (kTrain && seed != nullptr)
          p = dropout_keep(key, row * Lk + r, threshold) ? p * drop_scale
                                                         : 0.f;
        pw[r] = p;
      }
    }
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    for (int r = 0; r < Lk; ++r) {
      const float p = pw[r];
      a0 = fmaf(p, Vs[r * kStride + lane], a0);
      a1 = fmaf(p, Vs[r * kStride + lane + 32], a1);
    }
    out[q_off + lane] = a0;
    out[q_off + lane + 32] = a1;
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <bool kTrain>
int launch_f32(const void* q, const void* k, const void* v, const void* mask,
               const void* table, void* out, int B, int Lq, int Lk, int H,
               int max_pos, const int64_t* seed, float* lse,
               uint32_t threshold, float drop_scale, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_f32_kernel<kTrain>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(f32_smem_bytes(kMaxLen, kMaxLen, true)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  attention_f32_kernel<kTrain><<<dim3(H, B), kWarps * 32,
                                 f32_smem_bytes(Lq, Lk, table != nullptr),
                                 stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(table), static_cast<float*>(out), Lq, Lk, H,
      max_pos, 1.0f / sqrtf(static_cast<float>(kD)), seed, lse, threshold,
      drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrain>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* table, void* out, int B, int Lq, int Lk, int H,
           int max_pos, const int64_t* seed, float* lse, uint32_t threshold,
           float drop_scale, int dtype, cudaStream_t s) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lq > kMaxLen || Lk <= 0 || Lk > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table != nullptr && (Lq > max_pos || Lk > max_pos))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return launch_f32<kTrain>(q, k, v, mask, table, out, B, Lq, Lk, H,
                              max_pos, seed, lse, threshold, drop_scale, s);
  if (dtype == kBF16)
    return launch_bf16<kTrain>(
        Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const float*>(mask),
             static_cast<const bf16*>(table), static_cast<bf16*>(out), B, Lq,
             Lk, H, max_pos, seed, lse, threshold, drop_scale},
        s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// e3d_dropout_keep: out[n] = keep bit of flat element n, one warp per 16
// rows of one (b, h), each lane writing the bits keep_frag2 gives it for
// every 16 keys, as the tensor-core kernels draw them.
__global__ void __launch_bounds__(kMaxWarps * 32)
dropout_keep_kernel(const int64_t* __restrict__ seed, int Lq, int Lk,
                    uint32_t threshold, uint8_t* __restrict__ out) {
  const PhiloxKey key = philox_key(seed);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int l0 = (blockIdx.y * kMaxWarps + (threadIdx.x >> 5)) * kTile;
  const size_t bh = blockIdx.x;
  if (l0 >= Lq) return;  // the whole warp: keep_frag shuffles
  const uint64_t row_g = (bh * Lq + l0 + g) * static_cast<uint64_t>(Lk);
  for (int m = 0; m < (Lk + 15) / 16; ++m) {
    const uint32_t bits = keep_frag2(key, row_g, Lk, m, t, threshold);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int l = l0 + g + 8 * ((e >> 1) & 1);
      const int c = 16 * m + 8 * (e >> 2) + 2 * t + (e & 1);
      if (l < Lq && c < Lk)
        out[(bh * Lq + l) * Lk + c] = static_cast<uint8_t>(bits >> e & 1u);
    }
  }
}

}  // namespace

// q: (B, Lq, H*64); k, v: (B, Lk, H*64); mask: (B, Lk) f32 additive;
// table: (2*max_pos-1, 64) in q's type, or null; out: (B, Lq, H*64).
// The bf16 path needs 16-byte aligned q, k, v, table and out.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int e3d_attention(const void* q, const void* k, const void* v,
                             const void* mask, const void* table, void* out,
                             int B, int Lq, int Lk, int H, int max_pos,
                             int dtype, void* stream) {
  return launch<false>(q, k, v, mask, table, out, B, Lq, Lk, H, max_pos,
                       nullptr, nullptr, 0u, 1.f, dtype,
                       static_cast<cudaStream_t>(stream));
}

// The training forward: as e3d_attention, and in addition lse (B, H, Lq)
// f32 receives each row's log-sum-exp; seed (2 int64 on the card, or null
// for no dropout) keys the Philox draws of philox.cuh: P is dropped where
// the element's word is below threshold and scaled by drop_scale where it
// is not.
extern "C" int e3d_attention_train(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* table, const void* seed,
                                   void* out, void* lse, int B, int Lq,
                                   int Lk, int H, int max_pos,
                                   uint32_t threshold, float drop_scale,
                                   int dtype, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(q, k, v, mask, table, out, B, Lq, Lk, H, max_pos,
                      static_cast<const int64_t*>(seed),
                      static_cast<float*>(lse), threshold, drop_scale, dtype,
                      static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the bf16 training forward's instance for
// (Lq, Lk, with a table or not), as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it for the block size
// and shared memory a launch would use.
extern "C" int e3d_attention_train_occupancy(int Lq, int Lk, int table,
                                             int* blocks_per_sm) {
  if (Lq <= 0 || Lq > kMaxLen || Lk <= 0 || Lk > kMaxLen ||
      blocks_per_sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // only the pointers' presence and alignment matter
  alignas(16) static const bf16 dummy[8] = {};
  Args a{dummy, dummy, dummy, nullptr, table ? dummy : nullptr, nullptr,
         1, Lq, Lk, 1, kMaxLen, nullptr, nullptr, 0u, 1.f};
  a.out = const_cast<bf16*>(dummy);
  return launch_bf16<true>(a, nullptr, blocks_per_sm);
}

// out (B, H, Lq, Lk) uint8: the keep bits the training kernels draw for
// seed and threshold (for tests: the card's bits against the plain
// version's).
extern "C" int e3d_dropout_keep(const void* seed, int B, int H, int Lq,
                                int Lk, uint32_t threshold, void* out,
                                void* stream) {
  if (seed == nullptr || out == nullptr || B <= 0 || H <= 0 || Lq <= 0 ||
      Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kMaxWarps * kTile;
  dropout_keep_kernel<<<dim3(B * H,
                             (Lq + rows_per_block - 1) / rows_per_block),
                        kMaxWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(seed), Lq, Lk, threshold,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
