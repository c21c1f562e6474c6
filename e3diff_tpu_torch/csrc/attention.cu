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
// f32 (chip_smoke.py's accuracy checks only): CUDA-core FMA in f32, no TF32,
// one block per (head, batch), K, V and table rows staged as f32 with a
// 65-float row stride, each warp on its own query rows.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim
constexpr int kMaxLen = 128;   // Lq, Lk <= kMaxLen

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTile = 16;               // query rows per warp (mma M)
constexpr int kRow = kD + 8;            // shared row stride in bf16 (144 B)
constexpr int kMaxWarps = kMaxLen / kTile;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;
  const bf16* table;
  bf16* out;
  int B, Lq, Lk, H, max_pos;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += A_tile (16 x 64, fragments qa) times the 8 rows at rows[0..8) of a
// (., 64) bf16 shared array, transposed: one 16x8 tile of A rows^T.
__device__ __forceinline__ void mma_rows(float (&d)[4],
                                         const uint32_t (&qa)[4][4],
                                         const bf16* rows, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];  // depth 32*half + 0, 8, 16, 24
    ldsm_x4(b, rows + (lane & 7) * kRow + 8 * (lane >> 3) + 32 * half);
    mma_bf16(d, qa[2 * half], b[0], b[1]);
    mma_bf16(d, qa[2 * half + 1], b[2], b[3]);
  }
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

template <int NK, bool kTable>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_mma_kernel(Args a, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lq = a.Lq, Lk = a.Lk;
  const Layout lay(Lq, Lk, kTable);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + lay.lq_pad * kRow;
  bf16* Vs = Ks + lay.lk_pad * kRow;
  bf16* Es = Vs + lay.lk_pad * kRow;
  float* Ms = reinterpret_cast<float*>(Qs + lay.bf16_elems());
  float* Rs = Ms + lay.lk_pad;

  const int h = blockIdx.x, b = blockIdx.y;
  const int F = a.H * kD;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bf16* qg = a.q + static_cast<size_t>(b) * Lq * F + h * kD;
  const bf16* kg = a.k + static_cast<size_t>(b) * Lk * F + h * kD;
  const bf16* vg = a.v + static_cast<size_t>(b) * Lk * F + h * kD;

  // stage: 16-byte chunks, 8 per 64-wide row, every copy in flight at once
  for (int c = tid; c < Lq * 8; c += nthr) {
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
    // offsets l - r + max_pos - 1 span [max_pos - Lk, max_pos + Lq - 2];
    // Es[l - r + Lk - 1] holds table row l - r + max_pos - 1
    const bf16* eg = a.table + static_cast<size_t>(a.max_pos - Lk) * kD;
    const int e_valid = Lq + Lk - 1;
    for (int c = tid; c < e_valid * 8; c += nthr) {
      const int r = c >> 3, col = (c & 7) * 8;
      cp_async16(Es + r * kRow + col, eg + r * kD + col);
    }
    for (int c = tid; c < (lay.e_rows - e_valid) * 8; c += nthr) {
      const int r = e_valid + (c >> 3), col = (c & 7) * 8;
      *reinterpret_cast<uint4*>(Es + r * kRow + col) = zero;
    }
  }
  for (int c = tid; c < (lay.lq_pad - Lq) * 8; c += nthr) {
    const int r = Lq + (c >> 3), col = (c & 7) * 8;
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
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int l0 = warp * kTile;
  const int g = lane >> 2, t = lane & 3;  // fragment row, column pair

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
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t vb[4];  // keys 16 kk + 0..15, columns 8 n + 0..15
      ldsm_x4_trans(vb, Vs + (16 * kk + (lane & 15)) * kRow + 8 * n +
                            8 * (lane >> 4));
      mma_bf16(o[n], pa, vb[0], vb[1]);
      mma_bf16(o[n + 1], pa, vb[2], vb[3]);
    }
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
  bf16* og = a.out + static_cast<size_t>(b) * Lq * F + h * kD;
#pragma unroll
  for (int c = lane; c < kTile * 8; c += 32) {
    const int r = c >> 3, col = (c & 7) * 8;
    if (l0 + r < Lq)
      *reinterpret_cast<uint4*>(og + static_cast<size_t>(l0 + r) * F + col) =
          *reinterpret_cast<const uint4*>(Ow + r * kRow + col);
  }
}

template <int NK, bool kTable>
int launch_mma(const Args& a, cudaStream_t stream) {
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    const size_t most = Layout(kMaxLen, NK * 16, kTable).bytes();
    cudaError_t e = cudaFuncSetAttribute(
        attention_mma_kernel<NK, kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const Layout lay(a.Lq, a.Lk, kTable);
  attention_mma_kernel<NK, kTable>
      <<<dim3(a.H, a.B), lay.lq_pad / kTile * 32, lay.bytes(), stream>>>(
          a, 1.0f / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_mma_nk(const Args& a, cudaStream_t stream) {
  return a.table != nullptr ? launch_mma<NK, true>(a, stream)
                            : launch_mma<NK, false>(a, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_bf16(const Args& a, cudaStream_t stream) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
        aligned16(a.table) && aligned16(a.out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch ((a.Lk + 15) / 16) {
    case 1: return launch_mma_nk<1>(a, stream);
    case 2: return launch_mma_nk<2>(a, stream);
    case 3: return launch_mma_nk<3>(a, stream);
    case 4: return launch_mma_nk<4>(a, stream);
    case 5: return launch_mma_nk<5>(a, stream);
    case 6: return launch_mma_nk<6>(a, stream);
    case 7: return launch_mma_nk<7>(a, stream);
    case 8: return launch_mma_nk<8>(a, stream);
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

__global__ void __launch_bounds__(kWarps * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask,
                     const float* __restrict__ table, float* __restrict__ out,
                     int Lq, int Lk, int H, int max_pos, float scale) {
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
#pragma unroll
    for (int j = 0; j < kMaxLen / 32; ++j) {
      const int r = lane + 32 * j;
      if (r < Lk) pw[r] = s[j] / sum;
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

int launch_f32(const void* q, const void* k, const void* v, const void* mask,
               const void* table, void* out, int B, int Lq, int Lk, int H,
               int max_pos, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(f32_smem_bytes(kMaxLen, kMaxLen, true)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  attention_f32_kernel<<<dim3(H, B), kWarps * 32,
                         f32_smem_bytes(Lq, Lk, table != nullptr), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(table), static_cast<float*>(out), Lq, Lk, H,
      max_pos, 1.0f / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
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
  if (B <= 0 || H <= 0 || Lq <= 0 || Lq > kMaxLen || Lk <= 0 || Lk > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table != nullptr && (Lq > max_pos || Lk > max_pos))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_f32(q, k, v, mask, table, out, B, Lq, Lk, H, max_pos, s);
  if (dtype == kBF16)
    return launch_bf16(
        Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<const float*>(mask),
             static_cast<const bf16*>(table), static_cast<bf16*>(out), B, Lq,
             Lk, H, max_pos},
        s);
  return static_cast<int>(cudaErrorInvalidValue);
}
