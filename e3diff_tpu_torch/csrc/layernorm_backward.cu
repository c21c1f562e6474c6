// Backward of residual + LayerNorm (csrc/layernorm.cu).
//
// The Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_layernorm is
// forward-only; the JAX package trains through XLA's autodiff of
// nn.LayerNorm (e3diff_tpu/models/blocks.py:230, :263). Per row, with
// v = x [+ residual] in f32, x_hat = (v - mean) rstd and g = dy [* w]:
//   dx = rstd (g - mean(g) - x_hat mean(g x_hat)),  d residual = dx,
//   dw = sum_rows dy x_hat,  db = sum_rows dy.
// The statistics are recomputed from x and the residual (two passes over
// values held in registers, as the forward takes them), not saved.
//
// Design: one warp per row, lanes on columns lane, lane + 32, ..; each
// block walks rows grid-stride with 8 warps and keeps each lane's dw / db
// sums in registers, then sums its warps through shared memory into one
// partial row per block; a second kernel adds the partial rows per column
// (a fixed order: the result does not change from run to run). The
// affine-free variant (the SELayer's norm1 / norm2) computes neither.
// Bound: bytes. At 8192 x 768 bf16 with a residual and an affine it reads
// x, the residual and dy and writes dx (~50 MB with the partials), ~15 us
// at 3.35 TB/s.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 32;  // F <= 1024

// part[blockIdx.x, :] = the sum over the block's warps of acc (per lane:
// columns lane + 32 i); every thread of the block calls it
template <int N>
__device__ __forceinline__ void block_partial(const float (&acc)[N],
                                              float (*red)[32 * N],
                                              float* part, int n, int F) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) red[warp][i * 32 + lane] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp][c];
    part[static_cast<size_t>(blockIdx.x) * F + c] = s;
  }
  __syncthreads();
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const float* __restrict__ w, const T* __restrict__ dy,
                     T* __restrict__ dx, float* __restrict__ dw_part,
                     float* __restrict__ db_part, int rows, int F,
                     float eps) {
  __shared__ float red[kWarps][32 * N];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = F / 32;  // <= N
  float dw_acc[N], db_acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dw_acc[i] = db_acc[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * F;
    float v[N], g[N];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
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
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float d = v[i] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / F + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const int col = i * 32 + lane;
        const float d = to_f32(dy[base + col]);
        v[i] = (v[i] - mean) * rstd;  // x_hat from here on
        g[i] = w != nullptr ? d * w[col] : d;
        sg += g[i];
        sgx += g[i] * v[i];
        dw_acc[i] = fmaf(d, v[i], dw_acc[i]);
        db_acc[i] += d;
      }
    }
    const float mg = warp_sum(sg) / F;
    const float mgx = warp_sum(sgx) / F;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n)
        dx[base + i * 32 + lane] = from_f32<T>(rstd * (g[i] - mg - v[i] * mgx));
    }
  }

  // the block's partial sums: its warps' registers through shared memory
  if (dw_part != nullptr) block_partial<N>(dw_acc, red, dw_part, n, F);
  if (db_part != nullptr) block_partial<N>(db_acc, red, db_part, n, F);
}

// out[c] = sum_p part[p, c], p in order
__global__ void column_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int nparts,
                                  int F) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= F) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[static_cast<size_t>(p) * F + c];
  out[c] = s;
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const void* dy,
           void* dx, float* dw_part, float* db_part, int rows, int F,
           float eps, int nparts, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const float* wf = static_cast<const float*>(w);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (F == 768)
    layernorm_bwd_kernel<T, 24><<<nparts, kWarps * 32, 0, s>>>(
        xt, rt, wf, dyt, dxt, dw_part, db_part, rows, F, eps);
  else
    layernorm_bwd_kernel<T, kMaxPerLane><<<nparts, kWarps * 32, 0, s>>>(
        xt, rt, wf, dyt, dxt, dw_part, db_part, rows, F, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx (and residual, when not null): (rows, F) in one element type
// (dtype); w: (F,) f32 or null (affine-free: then dw_part, db_part, dw and
// db are null). dw_part, db_part: (nparts, F) f32 scratch, one partial row
// per block of the first kernel, which runs nparts blocks; dw, db: (F,) f32
// outputs (db may be null without a bias). Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int e3d_layernorm_backward(const void* x, const void* res,
                                      const void* w, const void* dy,
                                      void* dx, void* dw_part, void* db_part,
                                      void* dw, void* db, int rows, int F,
                                      float eps, int nparts, int dtype,
                                      void* stream) {
  if (rows <= 0 || F <= 0 || F % 32 != 0 || F > 32 * kMaxPerLane ||
      nparts <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((dw == nullptr) != (dw_part == nullptr) ||
      (db == nullptr) != (db_part == nullptr) ||
      (dw_part != nullptr && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* dwp = static_cast<float*>(dw_part);
  auto* dbp = static_cast<float*>(db_part);
  int e;
  if (dtype == kF32)
    e = launch<float>(x, res, w, dy, dx, dwp, dbp, rows, F, eps, nparts, s);
  else if (dtype == kBF16)
    e = launch<__nv_bfloat16>(x, res, w, dy, dx, dwp, dbp, rows, F, eps,
                              nparts, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != 0) return e;
  const int threads = 256, blocks = (F + threads - 1) / threads;
  if (dw != nullptr)
    column_sum_kernel<<<blocks, threads, 0, s>>>(
        dwp, static_cast<float*>(dw), nparts, F);
  if (db != nullptr)
    column_sum_kernel<<<blocks, threads, 0, s>>>(
        dbp, static_cast<float*>(db), nparts, F);
  return static_cast<int>(cudaGetLastError());
}
