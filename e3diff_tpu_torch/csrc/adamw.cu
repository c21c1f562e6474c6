// Gradient clipping and the AdamW update in one pass over every parameter.
//
// Replaces no TPU kernel: the JAX package leaves optax's
// clip_by_global_norm + adamw to XLA. It replaces the port's own chain of
// _foreach ops and one torch.where per tensor (ops/kernels.py::
// adamw_update_plain, which it equals bit for bit). That chain reads and
// writes whole parameter-sized temporaries: about 45 passes of S, the
// parameters' f32 size, where this pass moves 7 S (reads g, p, mu, nu,
// writes p, mu, nu; the global norm before it reads g once more).
//
// Bound: bytes. About 20 flops an element against 28 bytes (24 with a bf16
// mu): the 61M sequence model's 1.71 GB take 0.51 ms at 3.35 TB/s, the
// 146M structure model's 4.10 GB 1.22 ms, far beyond the 50 MB L2.
//
// Design: one block of 256 threads per chunk of one tensor (the host's
// chunk list, ops/kernels.py::adamw_chunks, made once per parameter list
// and kept on the card). The card hands out the next chunk as a block
// ends, which balances lists of tensors of any size. Each thread moves 16
// bytes a load (4 f32 values; 4 bf16 values of mu in 8 bytes), two vectors
// in flight a loop, the tensor's tail masked. A chunk whose pointers are
// not 16-byte aligned (a gradient viewed out of one flat buffer, as a dp
// all-reduce returns it) takes 4-byte loads, with the same arithmetic.
// The tensors' pointers travel by value in the launch, kMaxTensors at a
// time (CUDA 12.1's 32 KB parameter space), so that a captured launch
// stays bound to the gradients of its capture; the norm, the step count
// and the schedule table are read on the card, so that a replay reads the
// step it is at.
//
// Arithmetic: the chain's, op by op, each a separate f32 rounding in the
// chain's order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, which nvcc
// never contracts into an FMA):
//   g  = norm < clip ? g : (g / norm) * clip
//   mu = b1 mu + (1 - b1) g        (bf16 mu: b1 mu rounded to bf16 first;
//                                   the update reads the f32 sum, the
//                                   buffer keeps it rounded to bf16)
//   nu = b2 nu + (g g) (1 - b2)
//   u  = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd p]
//   p  = p + u (-lr)
// with lr, bc1 = 1 - b1^(count+1), bc2 = 1 - b2^(count+1) the schedule
// table's row at the step count (the last row past the run's end).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // 1024 threads an SM: at most 64 registers
constexpr int kUnroll = 2;        // 16-byte vectors in flight a thread
constexpr int kMaxTensors = 1000;  // 32 bytes each of a launch's 32,764

struct TensorTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
};

struct Hyper {
  float clip, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  int decay;  // the chain adds wd p only where weight_decay is not 0
};

struct Step {
  float norm, lr, bc1, bc2;
  bool clipped;
};

template <bool kBf16Mu>
__device__ __forceinline__ void update(const Hyper& h, const Step& s, float g,
                                       float& p, float& m, float& v) {
  if (s.clipped) g = __fmul_rn(__fdiv_rn(g, s.norm), h.clip);
  const float g1 = __fmul_rn(g, h.one_minus_b1);
  if (kBf16Mu)
    m = __fadd_rn(g1, __bfloat162float(__float2bfloat16_rn(__fmul_rn(m, h.b1))));
  else
    m = __fadd_rn(__fmul_rn(m, h.b1), g1);
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), denom);
  if (h.decay) u = __fadd_rn(u, __fmul_rn(p, h.weight_decay));
  p = __fadd_rn(p, __fmul_rn(u, -s.lr));
}

// 4 values of mu, 16 bytes (f32) or 8 (bf16)
template <bool kBf16Mu>
struct Mu4;

template <>
struct Mu4<false> {
  using T = float;
  __device__ static void load(const float* m, float* f) {
    const float4 q = *reinterpret_cast<const float4*>(m);
    f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
  }
  __device__ static void store(float* m, const float* f) {
    *reinterpret_cast<float4*>(m) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Mu4<true> {
  using T = __nv_bfloat16;
  __device__ static void load(const __nv_bfloat16* m, float* f) {
    const uint2 q = *reinterpret_cast<const uint2*>(m);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* m, const float* f) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(m) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  }
};

__device__ __forceinline__ bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// chunks[i] = (tensor, start, length, unused); tensor counts from first
template <bool kBf16Mu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
adamw_kernel(TensorTable tt, int first, const int4* __restrict__ chunks,
             const float* __restrict__ norm, const float* __restrict__ table,
             const long long* __restrict__ count, long long last_row, Hyper h) {
  using MuT = typename Mu4<kBf16Mu>::T;
  const int4 c = chunks[blockIdx.x];
  const int t = c.x - first;
  const int len = c.z;
  float* p = tt.p[t] + c.y;
  const float* g = tt.g[t] + c.y;
  MuT* m = static_cast<MuT*>(tt.mu[t]) + c.y;
  float* v = tt.nu[t] + c.y;

  const long long row = min(*count, last_row);
  Step s;
  s.norm = *norm;
  s.lr = table[3 * row];
  s.bc1 = table[3 * row + 1];
  s.bc2 = table[3 * row + 2];
  s.clipped = !(s.norm < h.clip);

  if (!(aligned(p, 16) && aligned(g, 16) && aligned(v, 16) &&
        aligned(m, 4 * sizeof(MuT)))) {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      float pi = p[i], mi = to_f32(m[i]), vi = v[i];
      update<kBf16Mu>(h, s, g[i], pi, mi, vi);
      p[i] = pi, v[i] = vi, m[i] = from_f32<MuT>(mi);
    }
    return;
  }

  for (int i0 = 4 * threadIdx.x; i0 < len; i0 += 4 * kThreads * kUnroll) {
    float gv[kUnroll][4], pv[kUnroll][4], mv[kUnroll][4], vv[kUnroll][4];
    // every whole vector's loads in flight before the first use
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 4 * kThreads * u;
      if (i + 4 <= len) {
        const float4 a = *reinterpret_cast<const float4*>(g + i);
        const float4 b = *reinterpret_cast<const float4*>(p + i);
        const float4 d = *reinterpret_cast<const float4*>(v + i);
        gv[u][0] = a.x, gv[u][1] = a.y, gv[u][2] = a.z, gv[u][3] = a.w;
        pv[u][0] = b.x, pv[u][1] = b.y, pv[u][2] = b.z, pv[u][3] = b.w;
        vv[u][0] = d.x, vv[u][1] = d.y, vv[u][2] = d.z, vv[u][3] = d.w;
        Mu4<kBf16Mu>::load(m + i, mv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + 4 * kThreads * u;
      if (i + 4 <= len) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          update<kBf16Mu>(h, s, gv[u][j], pv[u][j], mv[u][j], vv[u][j]);
        *reinterpret_cast<float4*>(p + i) =
            make_float4(pv[u][0], pv[u][1], pv[u][2], pv[u][3]);
        *reinterpret_cast<float4*>(v + i) =
            make_float4(vv[u][0], vv[u][1], vv[u][2], vv[u][3]);
        Mu4<kBf16Mu>::store(m + i, mv[u]);
      } else {
        for (int k = i; k < len; ++k) {  // the tensor's last 1-3 values
          float pk = p[k], mk = to_f32(m[k]), vk = v[k];
          update<kBf16Mu>(h, s, g[k], pk, mk, vk);
          p[k] = pk, v[k] = vk, m[k] = from_f32<MuT>(mk);
        }
      }
    }
  }
}

}  // namespace

extern "C" int e3d_adamw_max_tensors() { return kMaxTensors; }

// One launch over tensors first .. first + n_tensors - 1: ptrs (host) holds
// their p, g, mu, nu pointers in turn; chunks (device) their n_chunks
// rows. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int e3d_adamw(void* const* ptrs, int n_tensors, int first,
                         const void* chunks, int n_chunks, const void* norm,
                         const void* table, const void* count,
                         long long table_rows, float clip, float b1,
                         float one_minus_b1, float b2, float one_minus_b2,
                         float eps, float weight_decay, int decay,
                         int mu_dtype, void* stream) {
  if (n_tensors <= 0 || n_tensors > kMaxTensors || n_chunks <= 0 ||
      table_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TensorTable tt{};
  for (int i = 0; i < n_tensors; ++i) {
    tt.p[i] = static_cast<float*>(ptrs[4 * i]);
    tt.g[i] = static_cast<const float*>(ptrs[4 * i + 1]);
    tt.mu[i] = ptrs[4 * i + 2];
    tt.nu[i] = static_cast<float*>(ptrs[4 * i + 3]);
  }
  const Hyper h{clip, b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay,
                decay};
  const auto* ch = static_cast<const int4*>(chunks);
  const auto* nm = static_cast<const float*>(norm);
  const auto* tb = static_cast<const float*>(table);
  const auto* ct = static_cast<const long long*>(count);
  auto s = static_cast<cudaStream_t>(stream);
  if (mu_dtype == kF32)
    adamw_kernel<false><<<n_chunks, kThreads, 0, s>>>(
        tt, first, ch, nm, tb, ct, table_rows - 1, h);
  else if (mu_dtype == kBF16)
    adamw_kernel<true><<<n_chunks, kThreads, 0, s>>>(
        tt, first, ch, nm, tb, ct, table_rows - 1, h);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
