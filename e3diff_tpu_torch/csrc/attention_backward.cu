// Backward of the attention core (csrc/attention.cu's training forward).
//
// The Pallas kernel e3diff_tpu/ops/pallas_kernels.py::fused_attention is
// forward-only; the JAX package trains through XLA's autodiff of its einsum
// attention (e3diff_tpu/models/blocks.py:154-165, probability dropout at
// :162). This is the counterpart of that autodiff for the port's kernel.
// Per (batch b, head h), with x = (q k^T + q . table[l - r + max_pos - 1]) *
// scale + mask the forward's logits, P = exp(x - lse), f = keep / (1 - p)
// (1 without dropout) and dO the output's gradient:
//   dV     = (P f)^T dO        (P f rounded to v's type, as the forward
//                               rounds it before P V)
//   dP     = (dO V^T) f
//   delta  = rowsum(P dP)      (= rowsum(dO O) for the exact O = (P f) V)
//   dS     = P (dP - delta) * scale
//   dQ     = dS K + sum_r dS[l, r] table[l - r + max_pos - 1]
//   dK     = dS^T Q
//   dtable[l - r + max_pos - 1] += sum_{b, h} dS[b, h, l, r] q[b, l, h, :]
// S and P are recomputed from q, k, the table window, the mask and the
// forward's row log-sum-exp; nothing of size Lq x Lk is read or written
// except the keep mask. delta is summed from P and dP in f32, as autograd
// differentiates a softmax, not from the forward's output, which is
// rounded to bf16 in a bf16 run: then each row of dS sums to zero up to
// f32 rounding, and the gradient of a key bias, zero in exact arithmetic,
// stays at rounding noise.
//
// Design: CUDA-core f32 FMA in both element types (tensor cores for the
// backward are later work), two kernels on one stream:
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
//   its diagonals l - r = const, one table row each, and adds the row into
//   the global f32 table gradient with atomics, so the summation order
//   over (b, h) changes from run to run (the tolerance in chip_smoke.py
//   says so).
// Bound: at the training shape (B=64, Lq=Lk=128, H=12, bf16) the bytes
// (q, k, v, dO read, dQ, dK, dV written, the keep mask, the lse) are
// ~101 MB, ~30 us at 3.35 TB/s; the arithmetic on CUDA cores, not the
// memory, is what limits this simple version.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

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
  const uint8_t* keep;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  float* dtable;
  int B, Lq, Lk, H, max_pos;
  float scale, drop_scale;
};

template <typename T>
__device__ __forceinline__ float ld(const void* p, size_t i) {
  return to_f32(static_cast<const T*>(p)[i]);
}

template <typename T>
__device__ __forceinline__ void st(void* p, size_t i, float v) {
  static_cast<T*>(p)[i] = from_f32<T>(v);
}

// x rounded to T and back: the forward rounds P f to v's type before P V
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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
template <typename T>
__device__ void stage_rows(float* dst, const void* src, size_t base, int n,
                           int F) {
  for (int c = threadIdx.x; c < n * kD; c += blockDim.x) {
    const int r = c / kD, d = c % kD;
    dst[r * kRowF + d] = ld<T>(src, base + static_cast<size_t>(r) * F + d);
  }
}

// table rows max_pos - Lk .. max_pos + Lq - 2: Es[l - r + Lk - 1] is the row
// biasing query l against key r
template <typename T>
__device__ void stage_table(float* dst, const BwdArgs& a, int ne) {
  const size_t first = static_cast<size_t>(a.max_pos - a.Lk) * kD;
  for (int c = threadIdx.x; c < ne * kD; c += blockDim.x)
    dst[(c / kD) * kRowF + c % kD] = ld<T>(a.table, first + c);
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

template <typename T, bool kTable>
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
  stage_rows<T>(Ks, a.k, kv_base, Lk, F);
  stage_rows<T>(Vs, a.v, kv_base, Lk, F);
  if (kTable) stage_table<T>(Es, a, ne);
  for (int r = threadIdx.x; r < Lk; r += blockDim.x)
    Ms[r] = a.mask[static_cast<size_t>(b) * Lk + r];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = Ws + warp * (2 * kD + kMaxLen);  // the row's q
  float* gw = qw + kD;                         // the row's dO
  float* dsw = gw + kD;                        // the row's dS, by key
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const uint8_t* kp =
      a.keep == nullptr ? nullptr : a.keep + bh * Lq * Lk;

  for (int l = warp; l < Lq; l += kWarps) {
    const size_t off = (static_cast<size_t>(b) * Lq + l) * F + h * kD;
    qw[lane] = ld<T>(a.q, off + lane);
    qw[lane + 32] = ld<T>(a.q, off + lane + 32);
    gw[lane] = ld<T>(a.dout, off + lane);
    gw[lane + 32] = ld<T>(a.dout, off + lane + 32);
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
        if (kp != nullptr)
          dp[j] = kp[static_cast<size_t>(l) * Lk + r] ? dp[j] * a.drop_scale
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
    st<T>(a.dq, off + lane, acc0);
    st<T>(a.dq, off + lane + 32, acc1);
    __syncwarp();  // qw, gw and dsw are rewritten for the warp's next row
  }
}

template <typename T, bool kTable>
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
  stage_rows<T>(Qs, a.q, q_base, Lq, F);
  stage_rows<T>(Gs, a.dout, q_base, Lq, F);
  if (kTable) stage_table<T>(Es, a, ne);
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
  const uint8_t* kp =
      a.keep == nullptr ? nullptr : a.keep + bh * Lq * Lk;

  for (int r = warp; r < Lk; r += kWarps) {
    const size_t koff = (static_cast<size_t>(b) * Lk + r) * F + h * kD;
    kw[lane] = ld<T>(a.k, koff + lane);
    kw[lane + 32] = ld<T>(a.k, koff + lane + 32);
    vw[lane] = ld<T>(a.v, koff + lane);
    vw[lane + 32] = ld<T>(a.v, koff + lane + 32);
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
        if (kp != nullptr)
          f = kp[static_cast<size_t>(l) * Lk + r] ? a.drop_scale : 0.f;
        const float dp = dot64(Gs + l * kRowF, vw) * f;
        const float ds = p * (dp - Ds[l]) * a.scale;
        dsc[l] = ds;
        if (kTable) Ss[l * ss + r] = ds;
        pdc[l] = round_to<T>(p * f);
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
    st<T>(a.dk, koff + lane, k0);
    st<T>(a.dk, koff + lane + 32, k1);
    st<T>(a.dv, koff + lane, v0);
    st<T>(a.dv, koff + lane + 32, v1);
    __syncwarp();  // kw, vw, dsc and pdc are rewritten for the next key
  }
  if (kTable) {
    // table row max_pos - Lk + m gathers the pairs l - r + Lk - 1 = m
    __syncthreads();
    float* dst = a.dtable + static_cast<size_t>(a.max_pos - Lk) * kD;
    for (int m = warp; m < ne; m += kWarps) {
      const int lo = max(0, m - (Lk - 1)), hi = min(Lq - 1, m);
      float t0 = 0.f, t1 = 0.f;
      for (int l = lo; l <= hi; ++l) {
        const float ds = Ss[l * ss + l - m + Lk - 1];
        t0 = fmaf(ds, Qs[l * kRowF + lane], t0);
        t1 = fmaf(ds, Qs[l * kRowF + lane + 32], t1);
      }
      atomicAdd(dst + m * kD + lane, t0);
      atomicAdd(dst + m * kD + lane + 32, t1);
    }
  }
}

template <typename T, bool kTable>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  // above 48 KB a block needs the opt-in; set it once for the largest case
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_bwd_dq_kernel<T, kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem_bytes(kMaxLen, kMaxLen, kTable)));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(
        attention_bwd_dkv_kernel<T, kTable>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkv_smem_bytes(kMaxLen, kMaxLen, kTable)));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(a.H, a.B);
  attention_bwd_dq_kernel<T, kTable>
      <<<grid, kWarps * 32, dq_smem_bytes(a.Lq, a.Lk, kTable), stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attention_bwd_dkv_kernel<T, kTable>
      <<<grid, kWarps * 32, dkv_smem_bytes(a.Lq, a.Lk, kTable), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const BwdArgs& a, cudaStream_t stream) {
  return a.table != nullptr ? launch_bwd<T, true>(a, stream)
                            : launch_bwd<T, false>(a, stream);
}

}  // namespace

// q, dq, dout: (B, Lq, H*64); k, v, dk, dv: (B, Lk, H*64), all in one
// element type (dtype); mask: (B, Lk) f32 additive; table:
// (2*max_pos-1, 64) in the element type, or null (then dtable is unused);
// keep: (B, H, Lq, Lk) uint8 or null; lse: (B, H, Lq) f32 from the training
// forward; delta: (B, H, Lq) f32 scratch; dtable: (2*max_pos-1, 64) f32,
// zeroed by the caller, added into. Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int e3d_attention_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* table, const void* keep,
    const void* lse, void* delta, void* dq, void* dk, void* dv, void* dtable,
    int B, int Lq, int Lk, int H, int max_pos, float drop_scale, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lq > kMaxLen || Lk <= 0 || Lk > kMaxLen)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table != nullptr && (Lq > max_pos || Lk > max_pos || dtable == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(mask), table,
                  static_cast<const uint8_t*>(keep),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, static_cast<float*>(dtable), B, Lq, Lk, H,
                  max_pos, 1.0f / sqrtf(static_cast<float>(kD)), drop_scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_typed<float>(a, s);
  if (dtype == kBF16) return launch_typed<bf16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
