// Residual + LayerNorm, one warp per row.
//
// Replaces the Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_layernorm
// (body _layernorm_kernel). y = LN(x [+ residual]) [* weight] [+ bias] over
// the last dim F, statistics in f32 (biased variance, two passes over values
// held in registers), output in x's type.
//
// Bound: bytes. A decode call (512 rows x 768, bf16, with residual) reads
// 2 x 0.79 MB and writes 0.79 MB for ~10 flops per element, far below the
// card's ~295 flops/byte balance point; at 3.35 TB/s that is 0.7 us, so
// what a call costs is latency: how many round trips to memory a warp
// waits for, and whether every SM has a row to work on.
//
// Design, F = 768 (the models' width; a template parameter, so the
// per-lane counts are constants and the row stays in registers): each lane
// starts all of its 16-byte loads before the first add -- 3 of x and 3 of
// the residual in bf16 (6 and 6 in f32), and the f32 weight and bias as
// float4 -- so a warp waits for one round trip, not 24. Two warps per
// block: 512 rows launch 256 blocks for the 132 SMs (four warps would
// launch 128 and leave SMs idle). Outputs go out 16 bytes per store.
// Any other width that is a multiple of 32 up to 1024, or a pointer that
// is not 16-byte aligned, takes layernorm_any_kernel: 2- or 4-byte loads,
// one warp per row, the same arithmetic; it counts as a launch like the
// first.

#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// F = 768: 16-byte loads and stores
// ---------------------------------------------------------------------------

constexpr int kVecWidth = 768;
constexpr int kVecWarps = 2;  // rows (warps) per block

// 16 bytes of T as f32 values, and back
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int F>
__global__ void __launch_bounds__(kVecWarps * 32)
layernorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const float* __restrict__ w, const float* __restrict__ b,
                     T* __restrict__ y, int rows, float eps) {
  constexpr int kN = Vec16<T>::n;              // values per 16-byte chunk
  constexpr int kChunks = F / (32 * kN);       // chunks per lane
  constexpr int kF4 = kN / 4;                  // float4 of weight per chunk
  static_assert(F % (32 * kN) == 0, "no whole chunks per lane");
  const int row = blockIdx.x * kVecWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * F;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* rr = reinterpret_cast<const uint4*>(res);  // + base, below
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);

  // every load of the row in flight before the first use
  uint4 xv[kChunks], rv[kChunks];
  float4 wv[kChunks * kF4], bv[kChunks * kF4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) xv[i] = xr[i * 32 + lane];
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) rv[i] = rr[base / kN + i * 32 + lane];
  }
  if (w != nullptr) {
#pragma unroll
    for (int i = 0; i < kChunks * kF4; ++i)
      wv[i] = w4[(i / kF4 * 32 + lane) * kF4 + i % kF4];
  }
  if (b != nullptr) {
#pragma unroll
    for (int i = 0; i < kChunks * kF4; ++i)
      bv[i] = b4[(i / kF4 * 32 + lane) * kF4 + i % kF4];
  }

  float v[kChunks * kN];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    Vec16<T>::unpack(xv[i], v + i * kN);
    if (res != nullptr) {
      float r[kN];
      Vec16<T>::unpack(rv[i], r);
#pragma unroll
      for (int j = 0; j < kN; ++j) v[i * kN + j] += r[j];  // residual in f32
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) sum += v[i * kN + j];
  }
  const float mean = warp_sum(sum) / F;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks * kN; ++i) {
    const float d = v[i] - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / F + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + base);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    float o[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      o[j] = (v[i * kN + j] - mean) * rstd;
      const float4& wq = wv[i * kF4 + j / 4];
      const float4& bq = bv[i * kF4 + j / 4];
      const float wj[4] = {wq.x, wq.y, wq.z, wq.w};
      const float bj[4] = {bq.x, bq.y, bq.z, bq.w};
      if (w != nullptr) o[j] *= wj[j % 4];
      if (b != nullptr) o[j] += bj[j % 4];
    }
    yr[i * 32 + lane] = Vec16<T>::pack(o);
  }
}

// ---------------------------------------------------------------------------
// any F that is a multiple of 32, up to 1024: scalar loads
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;  // F <= 1024

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layernorm_any_kernel(const T* __restrict__ x, const T* __restrict__ res,
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch(const void* x, const void* res, const void* w, const void* b,
            void* y, int rows, int F, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (F == kVecWidth && aligned16(x) && aligned16(res) && aligned16(w) &&
      aligned16(b) && aligned16(y)) {
    const int blocks = (rows + kVecWarps - 1) / kVecWarps;
    layernorm_vec_kernel<T, kVecWidth><<<blocks, kVecWarps * 32, 0, stream>>>(
        xt, rt, wf, bf, yt, rows, eps);
  } else {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    layernorm_any_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        xt, rt, wf, bf, yt, rows, F, eps);
  }
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
