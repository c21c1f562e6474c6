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
// Bound: bytes. At 8192 x 768 bf16 with a residual and an affine it reads
// x, the residual and dy and writes dx (50.3 MB), 15.0 us at 3.35 TB/s;
// ~12 operations an element are far below the card's balance point.
//
// Design, F = 768 (the models' width; layernorm_bwd_vec_kernel):
// - one warp per row, rows grid-stride over a grid of as many blocks of
//   8 warps as the card holds at once (the wrapper asks the occupancy
//   API); each lane takes the row's 16-byte chunks i * 32 + lane of x, the
//   residual AND dy, all issued before the first add (3 + 3 + 3 in bf16, as
//   layernorm.cu's forward takes x and the residual), so dy no longer waits
//   for the two reductions of the statistics;
// - in bf16 the lane issues the next row's nine loads before it reduces
//   the current row, so a warp always has a row in flight;
// - each lane keeps its 24 columns' dw and db sums in registers across its
//   rows; a block sums its warps through shared memory into one partial
//   row, then column_sum_kernel adds the partial rows with 48 blocks
//   (32 columns x dw or db each), eight interleaved runs of partial rows
//   per column summed in order, then the eight in order: the same result
//   on every run.
// Any other width that is a multiple of 32 up to 1024, or a pointer that
// is not 16-byte aligned, takes layernorm_bwd_any_kernel: 2- or 4-byte
// loads, the same arithmetic and the same partial rows. The affine-free
// variant (the SELayer's norm1 / norm2) computes neither dw nor db.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;        // warps (rows in flight) per block
constexpr int kMaxPerLane = 32;  // F <= 1024
constexpr int kVecWidth = 768;

// part[blockIdx.x, :] = the sum over the block's warps of acc, whose entry
// i a lane holds for column col(i); every thread of the block calls it
template <int N, typename Col>
__device__ __forceinline__ void block_partial(const float (&acc)[N],
                                              float* red, float* part,
                                              int n, int F, Col col) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) red[warp * F + col(i)] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += red[wp * F + c];
    part[static_cast<size_t>(blockIdx.x) * F + c] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// F = 768: 16-byte loads, the next row in flight
// ---------------------------------------------------------------------------

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

// one row's 16-byte chunks of x, the residual and dy
template <int C>
struct RowChunks {
  uint4 x[C], r[C], g[C];
};

template <typename T, int F>
__global__ void __launch_bounds__(kWarps * 32, 1)
layernorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, int rows, float eps) {
  constexpr int kN = Vec16<T>::n;         // values per 16-byte chunk
  constexpr int kC = F / (32 * kN);       // chunks per lane and tensor
  constexpr int kV = kC * kN;             // values per lane
  constexpr bool kPrefetch = sizeof(T) == 2;
  static_assert(F % (32 * kN) == 0, "no whole chunks per lane");
  __shared__ float red[kWarps * F];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // column of the lane's value i: chunk i / kN, element i % kN
  auto col = [lane](int i) { return (i / kN * 32 + lane) * kN + i % kN; };

  float wv[kV];
  if (w != nullptr) {
#pragma unroll
    for (int i = 0; i < kV; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + col(i));
      wv[i] = q.x;
      wv[i + 1] = q.y;
      wv[i + 2] = q.z;
      wv[i + 3] = q.w;
    }
  }
  float dw_acc[kV], db_acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) dw_acc[i] = db_acc[i] = 0.f;

  auto load = [&](int row, RowChunks<kC>& c) {
    const size_t base = static_cast<size_t>(row) * F / kN;
    const uint4* x4 = reinterpret_cast<const uint4*>(x) + base;
    const uint4* g4 = reinterpret_cast<const uint4*>(dy) + base;
#pragma unroll
    for (int i = 0; i < kC; ++i) c.x[i] = x4[i * 32 + lane];
    if (res != nullptr) {
      const uint4* r4 = reinterpret_cast<const uint4*>(res) + base;
#pragma unroll
      for (int i = 0; i < kC; ++i) c.r[i] = r4[i * 32 + lane];
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) c.g[i] = g4[i * 32 + lane];
  };

  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  RowChunks<kC> cur, nxt;
  if (row < rows) load(row, cur);
  for (; row < rows; row += stride) {
    const int next = row + stride;
    if (kPrefetch && next < rows) load(next, nxt);

    float v[kV];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      Vec16<T>::unpack(cur.x[i], v + i * kN);
      if (res != nullptr) {
        float r[kN];
        Vec16<T>::unpack(cur.r[i], r);
#pragma unroll
        for (int j = 0; j < kN; ++j) v[i * kN + j] += r[j];  // in f32
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) sum += v[i * kN + j];
    }
    const float mean = warp_sum(sum) / F;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / F + eps);

    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      float d[kN];
      Vec16<T>::unpack(cur.g[i], d);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int k = i * kN + j;
        v[k] = (v[k] - mean) * rstd;  // x_hat from here on
        const float gk = w != nullptr ? d[j] * wv[k] : d[j];
        sg += gk;
        sgx += gk * v[k];
        dw_acc[k] = fmaf(d[j], v[k], dw_acc[k]);
        db_acc[k] += d[j];
      }
    }
    const float mg = warp_sum(sg) / F;
    const float mgx = warp_sum(sgx) / F;
    uint4* o4 =
        reinterpret_cast<uint4*>(dx) + static_cast<size_t>(row) * F / kN;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      float d[kN], o[kN];
      Vec16<T>::unpack(cur.g[i], d);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int k = i * kN + j;
        const float gk = w != nullptr ? d[j] * wv[k] : d[j];
        o[j] = rstd * (gk - mg - v[k] * mgx);
      }
      o4[i * 32 + lane] = Vec16<T>::pack(o);
    }

    if (kPrefetch)
      cur = nxt;
    else if (next < rows)
      load(next, cur);
  }

  if (dw_part != nullptr)
    block_partial<kV>(dw_acc, red, dw_part, kV, F, col);
  if (db_part != nullptr)
    block_partial<kV>(db_acc, red, db_part, kV, F, col);
}

// ---------------------------------------------------------------------------
// any F that is a multiple of 32, up to 1024: scalar loads
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(kWarps * 32)
layernorm_bwd_any_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const float* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw_part,
                         float* __restrict__ db_part, int rows, int F,
                         float eps) {
  __shared__ float red[kWarps * 32 * N];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = F / 32;  // <= N
  float dw_acc[N], db_acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dw_acc[i] = db_acc[i] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
    const size_t base = static_cast<size_t>(row) * F;
    float v[N], d[N];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const size_t c = base + i * 32 + lane;
        float t = to_f32(x[c]);
        if (res != nullptr) t += to_f32(res[c]);  // residual added in f32
        d[i] = to_f32(dy[c]);
        v[i] = t;
        sum += t;
      }
    }
    const float mean = warp_sum(sum) / F;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float e = v[i] - mean;
        sq += e * e;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / F + eps);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const int col = i * 32 + lane;
        v[i] = (v[i] - mean) * rstd;  // x_hat from here on
        const float g = w != nullptr ? d[i] * w[col] : d[i];
        sg += g;
        sgx += g * v[i];
        dw_acc[i] = fmaf(d[i], v[i], dw_acc[i]);
        db_acc[i] += d[i];
        d[i] = g;
      }
    }
    const float mg = warp_sum(sg) / F;
    const float mgx = warp_sum(sgx) / F;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n)
        dx[base + i * 32 + lane] = from_f32<T>(rstd * (d[i] - mg - v[i] * mgx));
    }
  }

  // the block's partial sums: its warps' registers through shared memory
  auto col = [lane](int i) { return i * 32 + lane; };
  if (dw_part != nullptr) block_partial<N>(dw_acc, red, dw_part, n, F, col);
  if (db_part != nullptr) block_partial<N>(db_acc, red, db_part, n, F, col);
}

// out[c] = sum_p part[p, c] for the block's 32 columns, blockIdx.y choosing
// dw (0) or db (1): warp k sums partial rows k, k + 8, .. in order, then
// warp 0 adds the eight sums in order
__global__ void __launch_bounds__(kWarps * 32)
column_sum_kernel(const float* __restrict__ dw_part,
                  const float* __restrict__ db_part, float* __restrict__ dw,
                  float* __restrict__ db, int nparts, int F) {
  __shared__ float sums[kWarps][32];
  const float* part = blockIdx.y == 0 ? dw_part : db_part;
  float* out = blockIdx.y == 0 ? dw : db;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < F) {
#pragma unroll 4
    for (int p = warp; p < nparts; p += kWarps)
      s += part[static_cast<size_t>(p) * F + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < F) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) total += sums[k][lane];
    out[c] = total;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  if (F == kVecWidth && aligned16(x) && aligned16(res) && aligned16(w) &&
      aligned16(dy) && aligned16(dx)) {
    layernorm_bwd_vec_kernel<T, kVecWidth><<<nparts, kWarps * 32, 0, s>>>(
        xt, rt, wf, dyt, dxt, dw_part, db_part, rows, eps);
  } else {
    layernorm_bwd_any_kernel<T, kMaxPerLane><<<nparts, kWarps * 32, 0, s>>>(
        xt, rt, wf, dyt, dxt, dw_part, db_part, rows, F, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx (and residual, when not null): (rows, F) in one element type
// (dtype); w: (F,) f32 or null (affine-free: then dw_part, db_part, dw and
// db are null). dw_part, db_part: (nparts, F) f32 scratch, one partial row
// per block of the first kernel, which runs nparts blocks; dw, db: (F,) f32
// outputs (db may be null without a bias), summed from the partial rows by
// column_sum_kernel in a fixed order. Returns cudaGetLastError() after the
// launches (0 = launched).
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
      (dw_part != nullptr && w == nullptr) ||
      (db != nullptr && dw == nullptr))
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
  if (e != 0 || dw == nullptr) return e;
  column_sum_kernel<<<dim3((F + 31) / 32, db != nullptr ? 2 : 1),
                      kWarps * 32, 0, s>>>(dwp, dbp, static_cast<float*>(dw),
                                           static_cast<float*>(db), nparts, F);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel an aligned call at width F takes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the wrapper's grid.
extern "C" int e3d_layernorm_backward_occupancy(int F, int dtype,
                                                int* blocks_per_sm) {
  if (F <= 0 || F % 32 != 0 || F > 32 * kMaxPerLane ||
      blocks_per_sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = kWarps * 32;
  cudaError_t e;
  if (dtype == kF32)
    e = F == kVecWidth
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm, layernorm_bwd_vec_kernel<float, kVecWidth>,
                  threads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm, layernorm_bwd_any_kernel<float, kMaxPerLane>,
                  threads, 0);
  else if (dtype == kBF16)
    e = F == kVecWidth
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm,
                  layernorm_bwd_vec_kernel<__nv_bfloat16, kVecWidth>, threads,
                  0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks_per_sm,
                  layernorm_bwd_any_kernel<__nv_bfloat16, kMaxPerLane>,
                  threads, 0);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}
