// Multi-head attention core with the HF relative_key bias, flat layout.
//
// Replaces the Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_attention
// (body _attention_kernel). Per head h: s = q_h k_h^T (+ sum_d q[l,d] *
// table[l - r + max_pos - 1, d]), then s / sqrt(D) + mask[b, r], an f32
// softmax, P cast to v's type, and P V. q, k, v and the output are the flat
// (B, L, H*64) tensors the projections produce: no head transpose is ever
// written to device memory.
//
// Bound: bytes. The decoder's self-attention (B=32, Lq=Lk=16, H=12, bf16)
// reads q, k, v (0.79 MB each) and writes 0.79 MB for ~38 Mflop, some
// 0.01 flop/byte. Unlike the Pallas kernel, which reads a materialised
// (Lq, Lk, D) position tensor, this kernel gathers rows of the per-layer
// (2*max_pos-1, 64) distance table itself, so the bias costs one small,
// L2-resident table read per block instead of an (Lq, Lk, 64) tensor.
//
// Design: one block per (head, batch). The head's K and V rows, and the
// Lq+Lk-1 table rows its offsets reach, are staged once in shared memory as
// f32 (rows padded to 65 floats, so lanes reading different rows at the same
// column hit different banks). Each warp owns query rows: lane j scores keys
// j, j+32, ... in f32 registers, the softmax reduces across the warp with
// shuffles, and each lane then accumulates output columns lane and lane+32.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kWarps = 4;      // warps per block, each on its own query rows
constexpr int kMaxLk = 128;    // keys per lane: kMaxLk / 32
constexpr int kStride = kD + 1;

size_t smem_bytes(int Lq, int Lk, bool with_table) {
  size_t floats = 2 * static_cast<size_t>(Lk) * kStride   // K, V
                  + kWarps * kD                           // one q row per warp
                  + kWarps * kMaxLk;                      // one P row per warp
  if (with_table) floats += static_cast<size_t>(Lq + Lk - 1) * kStride;
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const T* __restrict__ table, T* __restrict__ out, int Lq,
                 int Lk, int H, int max_pos, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + Lk * kStride;
  float* Qs = Vs + Lk * kStride;
  float* Ps = Qs + kWarps * kD;
  float* Es = Ps + kWarps * kMaxLk;  // only with a table

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int F = H * kD;
  const size_t kv_base = static_cast<size_t>(b) * Lk * F + h * kD;

  for (int i = threadIdx.x; i < Lk * kD; i += blockDim.x) {
    const int r = i / kD, d = i % kD;
    const size_t g = kv_base + static_cast<size_t>(r) * F + d;
    Ks[r * kStride + d] = to_f32(k[g]);
    Vs[r * kStride + d] = to_f32(v[g]);
  }
  if (table != nullptr) {
    // offsets l - r + max_pos - 1 span [max_pos - Lk, max_pos + Lq - 2];
    // Es[l - r + Lk - 1] holds table row l - r + max_pos - 1
    const int first = max_pos - Lk;
    for (int i = threadIdx.x; i < (Lq + Lk - 1) * kD; i += blockDim.x) {
      const int r = i / kD, d = i % kD;
      Es[r * kStride + d] = to_f32(table[static_cast<size_t>(first + r) * kD + d]);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qw = Qs + warp * kD;
  float* pw = Ps + warp * kMaxLk;
  const float* mrow = mask + static_cast<size_t>(b) * Lk;

  for (int l = warp; l < Lq; l += kWarps) {
    const size_t q_off = (static_cast<size_t>(b) * Lq + l) * F + h * kD;
    qw[lane] = to_f32(q[q_off + lane]);
    qw[lane + 32] = to_f32(q[q_off + lane + 32]);
    __syncwarp();

    float s[kMaxLk / 32];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxLk / 32; ++j) {
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
    for (int j = 0; j < kMaxLk / 32; ++j) {
      if (lane + 32 * j < Lk) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int j = 0; j < kMaxLk / 32; ++j) {
      const int r = lane + 32 * j;
      // P is rounded to v's type before P V, as in the Pallas kernel
      if (r < Lk) pw[r] = to_f32(from_f32<T>(s[j] / sum));
    }
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    for (int r = 0; r < Lk; ++r) {
      const float p = pw[r];
      a0 = fmaf(p, Vs[r * kStride + lane], a0);
      a1 = fmaf(p, Vs[r * kStride + lane + 32], a1);
    }
    out[q_off + lane] = from_f32<T>(a0);
    out[q_off + lane + 32] = from_f32<T>(a1);
    __syncwarp();  // qw and pw are rewritten for the warp's next row
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* table, void* out, int B, int Lq, int Lk, int H,
           int max_pos, cudaStream_t stream) {
  const size_t bytes = smem_bytes(Lq, Lk, table != nullptr);
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxLk, kMaxLk, true)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  attention_kernel<T><<<dim3(H, B), kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const T*>(table), static_cast<T*>(out), Lq, Lk, H,
      max_pos, 1.0f / sqrtf(static_cast<float>(kD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Lq, H*64); k, v: (B, Lk, H*64); mask: (B, Lk) f32 additive;
// table: (2*max_pos-1, 64) in q's type, or null; out: (B, Lq, H*64).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int e3d_attention(const void* q, const void* k, const void* v,
                             const void* mask, const void* table, void* out,
                             int B, int Lq, int Lk, int H, int max_pos,
                             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lq > kMaxLk || Lk <= 0 || Lk > kMaxLk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table != nullptr && (Lq > max_pos || Lk > max_pos))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, k, v, mask, table, out, B, Lq, Lk, H, max_pos, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, k, v, mask, table, out, B, Lq, Lk, H,
                                 max_pos, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
