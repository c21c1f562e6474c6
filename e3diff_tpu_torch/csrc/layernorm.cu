// Residual + LayerNorm, one warp per row.
//
// Replaces the Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_layernorm
// (body _layernorm_kernel). y = LN(x [+ residual]) [* weight] [+ bias] over
// the last dim F, statistics in f32 (biased variance, two passes over values
// held in registers), output in x's type.
//
// Bound: bytes. A decode call (512 rows x 768, bf16, with residual) reads
// 2 x 0.79 MB and writes 0.79 MB for ~10 flops per element, far below the
// card's ~295 flops/byte balance point. The design reads every element once
// (16 ... 64 B contiguous per warp instruction, neighbouring lanes on
// neighbouring addresses), keeps the row in registers for both statistics
// passes, and writes it once; nothing else touches device memory.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;  // F <= 1024

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ w, const float* __restrict__ b,
                 T* __restrict__ y, int rows, int F, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int n = F / 32;
  const size_t base = static_cast<size_t>(row) * F;

  float v[kMaxPerLane];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < n) {
      const size_t c = base + i * 32 + lane;
      float t = to_f32(x[c]);
      if (res != nullptr) t += to_f32(res[c]);  // residual added in f32
      v[i] = t;
      sum += t;
    }
  }
  const float mean = warp_sum(sum) / F;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < n) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / F + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (i < n) {
      const int col = i * 32 + lane;
      float o = (v[i] - mean) * rstd;
      if (w != nullptr) o *= w[col];
      if (b != nullptr) o += b[col];
      y[base + col] = from_f32<T>(o);
    }
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* w, const void* b,
            void* y, int rows, int F, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layernorm_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, F, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int e3d_layernorm(const void* x, const void* res, const void* w,
                             const void* b, void* y, int rows, int F,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || F <= 0 || F % 32 != 0 || F > 32 * kMaxPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    launch<float>(x, res, w, b, y, rows, F, eps, s);
  else if (dtype == kBF16)
    launch<__nv_bfloat16>(x, res, w, b, y, rows, F, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
