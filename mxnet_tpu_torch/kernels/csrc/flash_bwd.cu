// Flash-attention backward for NVIDIA Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/kernels/flash_attention.py:
//   _bwd_fused_kernel (:464, launched by _bwd_fused :523)  -> mx_flash_bwd_fused
//   _dq_kernel        (:373, launched by _bwd :605)        -> mx_flash_bwd_dq
//   _dkv_kernel       (:417, launched by _bwd :617)        -> mx_flash_bwd_dkv
//
// Given q, k, v, dO (B, H, L, D) contiguous in one dtype, the forward's lse
// and delta = rowsum(dO * O) (B, H, Lq) f32, and optional segment ids
// seg_q (B, Lq) / seg_kv (B, Lk) int32, the three entry points compute
//   dQ = scale * sum_k dS K,  dK = scale * sum_q dS^T Q,  dV = sum_q P^T dO
// with the TPU kernels' numerics, step for step:
//   - s = (q * scale rounded to q's dtype) k^T, masked entries -1e30: the
//     mask is segment equality and, if causal, qi >= ki in absolute
//     indices (Lq != Lk allowed);
//   - p = exp(s - lse), so masked entries and fully-masked rows give 0;
//   - dp = dO v^T; ds = p (dp - delta);
//   - dq sums (ds rounded to k's dtype) k, dv sums (p rounded to dO's
//     dtype)^T dO, dk sums (ds rounded to q's dtype)^T q with RAW q (the
//     scaled copy only feeds s); the scale multiplies dq and dk once at the
//     end; all sums are f32 and each output is cast to its input's dtype.
// Causal tiles whose every entry is masked are skipped, as the TPU grid
// does (:387-389, :432-434).
//
// Two families of kernels:
//   - CUDA cores, f32 at every D and bf16 with D > tc::kMaxD = 128: dq is
//     flash_bwd_dq_kernel below; dkv and fused are simt::flash_bwd_dkv_kernel.
//   - tensor cores, bf16 with D <= 128: namespace tc (dq, dkv and fused).
// Products on the CUDA cores run in f32 FMA: the tensor cores would round
// f32 inputs to TF32, which the reference does not.
//
// dq (CUDA cores).  Tiles are 64 q rows by 64 kv rows; a CTA of 256
// threads is a 16 x 16 grid (ty, tx), and thread (ty, tx) owns a 4 x 4
// block of each 64 x 64 score tile (rows 4 ty.., cols 4 tx..).  Operand
// tiles are staged in shared memory d-major (D x 68 floats, 16-byte rows),
// two D x 68 buffers reused for every operand of a step, so a score tile
// costs two 16-byte shared loads per d for 16 FMAs.  One CTA per (q tile,
// head, batch), heaviest causal tiles first, loops over kv tiles and keeps
// its 64 x D dQ rows in f32 registers.
//
// dkv and fused (CUDA cores, simt::flash_bwd_dkv_kernel<T, DP, BK, BQ,
// kFused>).  A CTA of 256 threads owns BK kv rows of one (b, h) and loops
// over q tiles of BQ rows: <float, 64, 128, 64>, <float, 128, 64, 64> and
// <T, 256, 32, 32>.
//   - K and V of the CTA's rows are loaded once by 16-byte cp.async (zero
//     fill past Lk) and stay resident, row-major, for the whole q loop.
//   - q, dO (raw, swizzled 16-byte chunks), lse, delta and seg_q of each q
//     tile stream through a ring of 2-3 stages of cp.async copies, issued
//     S - 1 tiles ahead; one __syncthreads per tile publishes a tile and
//     frees the stage the next copy refills.  q is staged once: q-hat =
//     round(q * round(scale)) is formed in registers where S^T reads it.
//   - The 8 warps split into two groups of 4 that work side by side on
//     the same (q tile, kv rows) pair: group 0 computes S^T = K q-hat^T
//     and group 1 dP^T = V dO^T, each thread an RC x RQ block (16 x 4 at
//     D = 64: 20 16-byte loads per 256 FMAs; 8 x 4 at D = 128: 12 per
//     128).  Group 0 forms p = exp(S^T - lse) (masked only on diagonal,
//     ragged or segmented tiles) and writes it, rounded to dO's dtype, to
//     a q-major swizzled tile; group 1 reads p at its own positions, forms
//     ds = p (dP^T - delta) rounded to q's dtype and writes it beside p.
//     Named barriers (bar.arrive / bar.sync) carry the hand-off, so group
//     0 starts dV while group 1 forms ds.  (Splitting the softmax between
//     the groups, each forming p and ds for half the q columns across two
//     __syncthreads, was slower: more shared traffic, no overlap.)
//   - Group 0 keeps dV += P^T dO, group 1 dK += dS^T q (raw q) in f32
//     registers: RC x 4 NG per thread (16 x 4 at D = 64, 8 x 8 at D = 128:
//     64 FMAs per five or four 16-byte loads).  Both sums run over q rows
//     in a fixed order: no atomics, so dk and dv are deterministic.
//   - fused: after each tile all 256 threads form its dQ share = ds K
//     over the CTA's kv rows (RQ x 4 per thread per 64-column panel; the
//     16 lanes of a half warp share rows, so ds loads are broadcasts and K
//     loads 16 adjacent float4) and add it to an f32 workspace by one
//     float4 atomicAdd (a vector reduction, sm_90) per 4 values; 128 kv
//     rows per CTA at D = 64 halve those additions.  Their order changes
//     from run to run, so dq's f32 rounding does too; the wrapper scales
//     and casts the workspace after the launch.
//   - The kv tile is the grid's slowest axis, heaviest (causal: first)
//     tiles first, so every head's longest CTAs start in the first wave.
//   - Shared memory, f32: at D = 64 K and V 64 KB, two 33 KB stages, p
//     and ds 64 KB (195 KB); at D = 128 K and V 64 KB, two 65 KB stages, p
//     and ds 32 KB (226 KB).  One CTA of 8 warps per SM.
//
// Bound: at the training shapes (L = 512-2048, D = 64-128) the work is
// 6 (dq), 8 (dkv) or 10 (fused) L^2 D flops per head, halved when causal,
// against ~8 L D values moved, far above the card's ridge point: the
// CUDA-core kernels are bound by operations, f32 FMA (67 TFLOP/s peak).
// An SM issues 128 FMAs per clock but reads 128 bytes of shared memory
// per clock, so every product takes several FMAs per byte it loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "hopper.cuh"
#include "simt.cuh"

namespace {

constexpr int kB = 64;        // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLdT = 68;      // row stride of d-major tiles and p/ds tiles
constexpr float kNegInf = -1e30f;

using simt::Elt;

// Rows r0 .. r0 + 63 of a (L, D) matrix into dst d-major (dst[d * kLdT + r]),
// zero past L; with kScale each value becomes round(x * scale_t) in T.
template <typename T, bool kScale>
__device__ __forceinline__ void stage_dmajor(float* dst, const T* src, int r0,
                                             int L, int D, float scale_t) {
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < kB * D4; i += kThreads) {
    const int r = i % kB, d = (i / kB) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) x = Elt<T>::load4(src + (size_t)(r0 + r) * D + d);
    if (kScale) {
      x.x = Elt<T>::round(x.x * scale_t);
      x.y = Elt<T>::round(x.y * scale_t);
      x.z = Elt<T>::round(x.z * scale_t);
      x.w = Elt<T>::round(x.w * scale_t);
    }
    dst[(d + 0) * kLdT + r] = x.x;
    dst[(d + 1) * kLdT + r] = x.y;
    dst[(d + 2) * kLdT + r] = x.z;
    dst[(d + 3) * kLdT + r] = x.w;
  }
}

// Rows r0 .. r0 + 63 of a (L, D) matrix into dst row-major (dst[c * D + d]),
// zero past L.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int L, int D) {
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < kB * D4; i += kThreads) {
    const int c = i / D4, d = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + c < L) x = Elt<T>::load4(src + (size_t)(r0 + c) * D + d);
    *reinterpret_cast<float4*>(&dst[c * D + d]) = x;
  }
}

// out[i][j] = sum_d a[d][4 ty + i] * b[d][4 tx + j] over d-major tiles
__device__ __forceinline__ void tile_product(float (&out)[4][4],
                                             const float* a, const float* b,
                                             int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(&a[d * kLdT + ty * 4]);
    const float4 y = *reinterpret_cast<const float4*>(&b[d * kLdT + tx * 4]);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(xv[i], yv[j], out[i][j]);
  }
}

// acc[i][4 g + e] += sum_c t[c][4 ty + i] * m[c][4 (tx + 16 g) + e], with t a
// 64 x kLdT tile and m row-major 64 x D
template <int NG>
__device__ __forceinline__ void accumulate(float (&acc)[4][4 * NG],
                                           const float* t, const float* m,
                                           int D, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < kB; ++c) {
    const float4 p = *reinterpret_cast<const float4*>(&t[c * kLdT + ty * 4]);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = (tx + 16 * g) * 4;
      if (d < D) {
        const float4 x = *reinterpret_cast<const float4*>(&m[c * D + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * g + 0] = fmaf(pv[i], x.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv[i], x.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv[i], x.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv[i], x.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// rows 4 ty + i (< L - r0) of acc * mul, cast to T, into dst rows r0..
template <typename T, int NG>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][4 * NG],
                                           int r0, int L, int D, float mul,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= L) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = (tx + 16 * g) * 4;
      if (d < D)
        Elt<T>::store4(dst + (size_t)(r0 + r) * D + d,
                       make_float4(acc[i][4 * g + 0] * mul,
                                   acc[i][4 * g + 1] * mul,
                                   acc[i][4 * g + 2] * mul,
                                   acc[i][4 * g + 3] * mul));
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg_q, *seg_kv;
  float* dq_ws;   // fused: f32 (B, H, Lq, D) workspace, zeroed by the caller
  void *dq, *dk, *dv;
  int H, Lq, Lk, D, causal;
  float scale;
};

enum Kind { kDq = 0, kDkv = 1, kFusedKind = 2 };

// dQ rows of one q tile, looping over kv tiles (the port of _dq_kernel).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, NG <= 2 ? 2 : 1)
flash_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D;
  float* bufA = smem;                       // D x kLdT
  float* bufB = bufA + D * kLdT;            // D x kLdT
  float* sDS = bufB + D * kLdT;             // kB x kLdT: ds[c][r]
  int* sSegQ = reinterpret_cast<int*>(sDS + kB * kLdT);
  int* sSegK = sSegQ + kB;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;   // heaviest first
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * a.H + blockIdx.y;
  const int Lq = a.Lq, Lk = a.Lk;
  const T* qb = static_cast<const T*>(a.q) + bh * Lq * D;
  const T* kb = static_cast<const T*>(a.k) + bh * Lk * D;
  const T* vb = static_cast<const T*>(a.v) + bh * Lk * D;
  const T* dob = static_cast<const T*>(a.dout) + bh * Lq * D;
  const bool has_seg = a.seg_q != nullptr;
  const float scale_t = Elt<T>::round(a.scale);

  if (has_seg && tid < kB)
    sSegQ[tid] = (q0 + tid < Lq) ? a.seg_q[(size_t)b * Lq + q0 + tid] : 0;
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < Lq ? a.lse[bh * Lq + r] : 0.f;
    delta_r[i] = r < Lq ? a.delta[bh * Lq + r] : 0.f;
  }
  float acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;

  int n_kv = (Lk + kB - 1) / kB;
  if (a.causal) n_kv = min(n_kv, (min(q0 + kB, Lq) - 1) / kB + 1);

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kB;
    __syncthreads();   // the previous tile is done with every buffer
    stage_dmajor<T, true>(bufA, qb, q0, Lq, D, scale_t);
    stage_dmajor<T, false>(bufB, kb, k0, Lk, D, 0.f);
    if (has_seg && tid < kB)
      sSegK[tid] = (k0 + tid < Lk) ? a.seg_kv[(size_t)b * Lk + k0 + tid] : 0;
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_product(s, bufA, bufB, D, ty, tx);
    __syncthreads();
    stage_dmajor<T, false>(bufA, dob, q0, Lq, D, 0.f);
    stage_dmajor<T, false>(bufB, vb, k0, Lk, D, 0.f);
    __syncthreads();
    tile_product(dp, bufA, bufB, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        bool ok = k0 + c < Lk;
        if (has_seg) ok = ok && sSegQ[r] == sSegK[c];
        if (a.causal) ok = ok && q0 + r >= k0 + c;
        const float p = expf((ok ? s[i][j] : kNegInf) - lse_r[i]);
        s[i][j] = Elt<T>::round(p * (dp[i][j] - delta_r[i]));   // ds in k's dtype
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sDS[(tx * 4 + j) * kLdT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // ds complete; dO^T / V^T reads done
    stage_rows<T>(bufA, kb, k0, Lk, D);
    __syncthreads();
    accumulate<NG>(acc, sDS, bufA, D, ty, tx);
  }
  store_rows<T, NG>(static_cast<T*>(a.dq) + bh * Lq * D, acc, q0, Lq, D,
                    a.scale, ty, tx);
}

}  // namespace

// ---------------------------------------------------------------------------
// CUDA cores: dk, dv (the port of _dkv_kernel) and, fused, dq, dk, dv of one
// single-block sequence (_bwd_fused_kernel), for f32 at every D and bf16
// with D > tc::kMaxD.  The design is in the header comment.
namespace simt {

constexpr int kThreads = 256;       // two groups of four warps
constexpr int kMaxSmem = 232448;    // bytes of shared memory a CTA may use
constexpr float kNegInf = -1e30f;

// offset of element (r, col) of a tile of rows of W elements of T whose
// 16-byte chunks are swizzled: chunk c of row r sits at c ^ (r % 8), so 8
// threads reading one chunk position of 8 consecutive rows, or 8 chunks
// of one row, hit distinct banks (W / chunk >= 8)
template <typename T, int W>
__device__ __forceinline__ int swz(int r, int col) {
  constexpr int E = 16 / sizeof(T);
  static_assert(W / E >= 8, "a swizzled row holds at least 8 chunks");
  return r * W + (((col / E) ^ (r & 7)) * E) + (col % E);
}

// The shared-memory plan of a dkv / fused CTA: element type T, head dim
// padded to DP, BK kv rows per CTA, BQ q rows per streamed tile.  K and V
// (row-major, resident), then kStages ring stages (q, dO swizzled, then
// lse, delta and seg_q of the tile), then p and ds (f32, swizzled, q-major).
template <typename T, int DP, int BK, int BQ>
struct DkvPlan {
  static constexpr int kRC = BK / 8;     // kv rows of a thread (8 thread rows)
  static constexpr int kRQ = BQ / 16;    // q rows of a thread in S^T and dP^T
  static constexpr int kNG = DP / 64;    // float4 column groups of dK / dV
  static constexpr int kEpc = 16 / sizeof(T);
  static constexpr int kKV = BK * DP * (int)sizeof(T);
  static constexpr int kQ = BQ * DP * (int)sizeof(T);
  static constexpr int kStats = 3 * BQ * 4;
  static constexpr int kStage = 2 * kQ + kStats;
  static constexpr int kPS = BQ * BK * 4;
  static constexpr int kFixed = 2 * kKV + 2 * kPS;
  static constexpr int kStages = kFixed + 3 * kStage <= kMaxSmem ? 3 : 2;
  static constexpr int kBytes = kFixed + kStages * kStage;
  static_assert(kRC % 4 == 0 && kRQ >= 1 && kNG >= 1, "thread grid");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

// acc[i][j] = sum_{d < D} a[RC ty + i][d] * f(b[tx + 16 j][d]): a row-major
// with rows of DP elements, b a swizzled tile; f(x) = round(x * mul) in T
// with kScale (q-hat), else x.  Per 4 d, RC + RQ 16-byte loads (the a rows
// are the same for the 16 threads of a thread row) for 4 RC RQ FMAs.
template <typename T, int DP, int RC, int RQ, bool kScale>
__device__ __forceinline__ void product_rows(float (&acc)[RC][RQ],
                                             const T* a, const T* b, int D,
                                             int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RQ; ++j) acc[i][j] = 0.f;
  const T* arow = a + RC * ty * DP;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[RC], bv[RQ];
#pragma unroll
    for (int i = 0; i < RC; ++i) av[i] = Elt<T>::load4(arow + i * DP + d);
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      bv[j] = Elt<T>::load4(b + swz<T, DP>(tx + 16 * j, d));
      if (kScale) {
        bv[j].x = Elt<T>::round(bv[j].x * mul);
        bv[j].y = Elt<T>::round(bv[j].y * mul);
        bv[j].z = Elt<T>::round(bv[j].z * mul);
        bv[j].w = Elt<T>::round(bv[j].w * mul);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j)
          acc[i][j] = fmaf(lane(av[i], e), lane(bv[j], e), acc[i][j]);
  }
}

// acc[i][4 g + e] += sum_{r < BQ} t[r][RC ty + i] * m[r][4 tx + 64 g + e]:
// t a swizzled BQ x BK f32 tile (p or ds), m a swizzled BQ x DP tile (dO or
// q).  Per q row, RC / 4 + NG 16-byte loads for 4 RC NG FMAs.
template <typename T, int DP, int BK, int BQ, int RC, int NG>
__device__ __forceinline__ void accumulate_rows(float (&acc)[RC][4 * NG],
                                                const float* t, const T* m,
                                                int ty, int tx) {
#pragma unroll 2
  for (int r = 0; r < BQ; ++r) {
    float4 tv[RC / 4], mv[NG];
#pragma unroll
    for (int u = 0; u < RC / 4; ++u)
      tv[u] = *reinterpret_cast<const float4*>(
          t + swz<float, BK>(r, RC * ty + 4 * u));
#pragma unroll
    for (int g = 0; g < NG; ++g)
      mv[g] = Elt<T>::load4(m + swz<T, DP>(r, 4 * tx + 64 * g));
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const float w = lane(tv[i / 4], i % 4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[i][4 * g + 0] = fmaf(w, mv[g].x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(w, mv[g].y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(w, mv[g].z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(w, mv[g].w, acc[i][4 * g + 3]);
      }
    }
  }
}

// dK and dV of BK kv rows, looping over q tiles; kFused also adds each
// tile's dQ share to a.dq_ws.
template <typename T, int DP, int BK, int BQ, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(Args a) {
  using L = DkvPlan<T, DP, BK, BQ>;
  constexpr int RC = L::kRC, RQ = L::kRQ, NG = L::kNG, S = L::kStages;
  constexpr int E = L::kEpc;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + L::kKV);
  char* ring = smem + 2 * L::kKV;
  float* sP = reinterpret_cast<float*>(ring + S * L::kStage);
  float* sDS = sP + BQ * BK;

  // group 0 computes S^T, p and dV; group 1 dP^T, ds and dK
  const int tid = threadIdx.x, grp = tid / 128;
  const int ty = (tid % 128) / 16, tx = tid % 16;
  // kv tiles are the grid's slowest axis, heaviest (causal: first) first,
  // so every head's longest tiles start in the first wave
  const int k0 = blockIdx.z * BK;
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * a.H + blockIdx.x;
  const int Lq = a.Lq, Lk = a.Lk, D = a.D;
  const T* qb = static_cast<const T*>(a.q) + bh * Lq * D;
  const T* kb = static_cast<const T*>(a.k) + bh * Lk * D;
  const T* vb = static_cast<const T*>(a.v) + bh * Lk * D;
  const T* dob = static_cast<const T*>(a.dout) + bh * Lq * D;
  const bool has_seg = a.seg_q != nullptr;
  const float scale_t = Elt<T>::round(a.scale);
  // causal: q tiles ending before this CTA's first key are all masked
  const int first = a.causal ? k0 / BQ : 0;
  const int n_tiles = max((Lq + BQ - 1) / BQ - first, 0);
  const int cpr = D / E;                       // 16-byte chunks per row

  // K and V rows k0.. once, zero past Lk (they ride in the first group)
  for (int i = tid; i < BK * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * E;
    const bool ok = k0 + r < Lk;
    const size_t off = ok ? (size_t)(k0 + r) * D + c : 0;
    cp_async16(hopper::smem_addr(sK + r * DP + c), kb + off, ok ? 16 : 0);
    cp_async16(hopper::smem_addr(sV + r * DP + c), vb + off, ok ? 16 : 0);
  }
  // ring tile j (q, dO, lse, delta, seg_q of q tile first + j) into stage
  // j % S, as one commit group (empty past the last tile)
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int q0 = (first + j) * BQ;
      char* st = ring + (j % S) * L::kStage;
      T* sq = reinterpret_cast<T*>(st);
      T* sdo = reinterpret_cast<T*>(st + L::kQ);
      float* stats = reinterpret_cast<float*>(st + 2 * L::kQ);
      for (int i = tid; i < BQ * cpr; i += kThreads) {
        const int r = i / cpr, c = (i % cpr) * E;
        const bool ok = q0 + r < Lq;
        const size_t off = ok ? (size_t)(q0 + r) * D + c : 0;
        const int dst = swz<T, DP>(r, c);
        cp_async16(hopper::smem_addr(sq + dst), qb + off, ok ? 16 : 0);
        cp_async16(hopper::smem_addr(sdo + dst), dob + off, ok ? 16 : 0);
      }
      for (int i = tid; i < 3 * BQ; i += kThreads) {
        const int w = i / BQ, r = q0 + i % BQ;
        const void* src = a.lse;
        bool ok = r < Lq;
        if (ok && w == 0) src = a.lse + bh * Lq + r;
        if (ok && w == 1) src = a.delta + bh * Lq + r;
        if (w == 2) {
          ok = ok && has_seg;
          if (ok) src = a.seg_q + (size_t)b * Lq + r;
        }
        cp_async4(hopper::smem_addr(stats + i), src, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < S - 1; ++j) issue(j);

  int skv[RC];   // segment ids of this thread's kv rows
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int c = k0 + RC * ty + i;
    skv[i] = has_seg && c < Lk ? a.seg_kv[(size_t)b * Lk + c] : 0;
  }
  float acc[RC][4 * NG];   // dV (group 0) or dK (group 1) rows RC ty + i
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<S - 2>();   // tile j has landed (this thread's copies)
    __syncthreads();          // ... and everyone's; tile j - 1 is consumed
    issue(j + S - 1);         // into tile j - 1's stage
    const int q0 = (first + j) * BQ;
    const char* st = ring + (j % S) * L::kStage;
    const T* sq = reinterpret_cast<const T*>(st);
    const T* sdo = reinterpret_cast<const T*>(st + L::kQ);
    const float* sLse = reinterpret_cast<const float*>(st + 2 * L::kQ);
    const float* sDelta = sLse + BQ;
    const int* sSeg = reinterpret_cast<const int*>(sDelta + BQ);
    if (grp == 0) {
      // S^T = K q-hat^T, p = exp(S^T - lse) on this thread's 8 x 4 block
      float s[RC][RQ];
      product_rows<T, DP, RC, RQ, true>(s, sK, sq, D, ty, tx, scale_t);
      const bool masked = has_seg || q0 + BQ > Lq || k0 + BK > Lk ||
                          (a.causal && q0 < k0 + BK - 1);
#pragma unroll
      for (int jj = 0; jj < RQ; ++jj) {
        const int r = tx + 16 * jj;
        const float lse_r = sLse[r];
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          float sv = s[i][jj];
          if (masked) {
            const int c = k0 + RC * ty + i;
            bool ok = c < Lk && q0 + r < Lq;
            if (has_seg) ok = ok && sSeg[r] == skv[i];
            if (a.causal) ok = ok && q0 + r >= c;
            if (!ok) sv = kNegInf;
          }
          s[i][jj] = expf(sv - lse_r);
        }
        // p in dO's dtype for dV; unrounded p for ds where rounding
        // changes it (bf16), in the ds tile that group 1 overwrites
#pragma unroll
        for (int u = 0; u < RC / 4; ++u) {
          const int o = swz<float, BK>(r, RC * ty + 4 * u);
          *reinterpret_cast<float4*>(sP + o) = make_float4(
              Elt<T>::round(s[4 * u][jj]), Elt<T>::round(s[4 * u + 1][jj]),
              Elt<T>::round(s[4 * u + 2][jj]), Elt<T>::round(s[4 * u + 3][jj]));
          if constexpr (!std::is_same<T, float>::value)
            *reinterpret_cast<float4*>(sDS + o) = make_float4(
                s[4 * u][jj], s[4 * u + 1][jj], s[4 * u + 2][jj],
                s[4 * u + 3][jj]);
        }
      }
      named_arrive(1, kThreads);            // p to group 1
      hopper::named_barrier(2, 128);        // ... and to all of group 0
      accumulate_rows<T, DP, BK, BQ, RC, NG>(acc, sP, sdo, ty, tx);
      if constexpr (kFused) hopper::named_barrier(3, kThreads);  // ds
    } else {
      // dP^T = V dO^T, ds = p (dP^T - delta) on the same block
      float dp[RC][RQ];
      product_rows<T, DP, RC, RQ, false>(dp, sV, sdo, D, ty, tx, 1.f);
      hopper::named_barrier(1, kThreads);   // p from group 0
      const float* pin = std::is_same<T, float>::value ? sP : sDS;
#pragma unroll
      for (int jj = 0; jj < RQ; ++jj) {
        const int r = tx + 16 * jj;
        const float delta_r = sDelta[r];
#pragma unroll
        for (int u = 0; u < RC / 4; ++u) {
          const int o = swz<float, BK>(r, RC * ty + 4 * u);
          const float4 p = *reinterpret_cast<const float4*>(pin + o);
          *reinterpret_cast<float4*>(sDS + o) = make_float4(   // q's dtype
              Elt<T>::round(p.x * (dp[4 * u][jj] - delta_r)),
              Elt<T>::round(p.y * (dp[4 * u + 1][jj] - delta_r)),
              Elt<T>::round(p.z * (dp[4 * u + 2][jj] - delta_r)),
              Elt<T>::round(p.w * (dp[4 * u + 3][jj] - delta_r)));
        }
      }
      if constexpr (kFused) named_arrive(3, kThreads);   // ds to group 0
      hopper::named_barrier(4, 128);        // ds to all of group 1
      accumulate_rows<T, DP, BK, BQ, RC, NG>(acc, sDS, sq, ty, tx);  // raw q
    }
    if constexpr (kFused) {
      // this tile's dQ share, ds K over the CTA's kv rows: thread rows
      // rg + 16 i and columns 4 dg .. + 3 of each 64-column panel, added to
      // the f32 workspace by one float4 atomicAdd per 4 values.  The 16
      // lanes of a half warp share their rows (one broadcast ds load) and
      // read 16 adjacent float4 of a K row
      const int rg = tid / 16, dg = tid % 16;
      float* wsb = a.dq_ws + bh * Lq * D;
#pragma unroll 1
      for (int h = 0; h < DP / 64 && 64 * h < D; ++h) {
        const int d = 64 * h + 4 * dg;
        float part[RQ][4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll 2
        for (int c = 0; c < BK; c += 4) {
          float4 w[RQ], kx[4];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
            w[i] = *reinterpret_cast<const float4*>(
                sDS + swz<float, BK>(rg + 16 * i, c));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            kx[e] = Elt<T>::load4(sK + (c + e) * DP + d);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
              const float wv = lane(w[i], e);
              part[i][0] = fmaf(wv, kx[e].x, part[i][0]);
              part[i][1] = fmaf(wv, kx[e].y, part[i][1]);
              part[i][2] = fmaf(wv, kx[e].z, part[i][2]);
              part[i][3] = fmaf(wv, kx[e].w, part[i][3]);
            }
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int r = q0 + rg + 16 * i;
          if (r < Lq && d < D)
            atomicAdd(reinterpret_cast<float4*>(wsb + (size_t)r * D + d),
                      make_float4(part[i][0], part[i][1], part[i][2],
                                  part[i][3]));
        }
      }
    }
  }
  cp_async_wait<0>();

  // dV (group 0) and scale * dK (group 1), cast to T
  T* dst = static_cast<T*>(grp == 0 ? a.dv : a.dk) + bh * Lk * D;
  const float mul = grp == 0 ? 1.f : a.scale;
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int c = k0 + RC * ty + i;
    if (c >= Lk) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * tx + 64 * g;
      if (d < D)
        Elt<T>::store4(dst + (size_t)c * D + d,
                       make_float4(acc[i][4 * g + 0] * mul,
                                   acc[i][4 * g + 1] * mul,
                                   acc[i][4 * g + 2] * mul,
                                   acc[i][4 * g + 3] * mul));
    }
  }
}

template <typename T, int DP, int BK, int BQ>
cudaError_t launch_dkv(bool fused, const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = DkvPlan<T, DP, BK, BQ>::kBytes;
  auto kernel = fused ? flash_bwd_dkv_kernel<T, DP, BK, BQ, true>
                      : flash_bwd_dkv_kernel<T, DP, BK, BQ, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_kv = (a.Lk + BK - 1) / BK;
  if (n_kv > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.H, B, n_kv);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// f32: <64, 128, 64> (16 x 4 S^T and dV / dK blocks) and <128, 64, 64>
// (8 x 4 S^T, 8 x 8 dV / dK); D > 128, f32 or bf16: <256, 32, 32> (4 x 2
// and 4 x 16)
template <typename T>
cudaError_t dispatch_dkv(bool fused, const Args& a, int B, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.D <= 64) return launch_dkv<T, 64, 128, 64>(fused, a, B, s);
    if (a.D <= 128) return launch_dkv<T, 128, 64, 64>(fused, a, B, s);
  }
  return launch_dkv<T, 256, 32, 32>(fused, a, B, s);
}

}  // namespace simt


// ---------------------------------------------------------------------------
// bf16 with D <= 128 on the tensor cores: dk, dv (the port of _dkv_kernel),
// dq, dk, dv of one single-block sequence (_bwd_fused_kernel) and dq
// (_dq_kernel)
//
// The TPU kernels' products are bf16 x bf16 with f32 accumulation (_bmm,
// Precision.DEFAULT), and their roundings sit at the operands (q * scale
// for s, p to dO's dtype, ds to q's and k's dtype), which is what wgmma
// computes from bf16 operands.  On the card the plain version computes the
// same products as torch.bmm(..., out_dtype=float32), bf16 on the tensor
// cores.
//
// dkv and fused.  A CTA of two warpgroups (256 threads) owns kBN = 128 kv
// rows of one (b, h); each warpgroup owns 64 of them and keeps its 64 x DP
// dK and dV rows in f32 registers for the whole q loop.
//   - K and V of the CTA's rows are loaded once by TMA and stay resident in
//     shared memory.
//   - q and dO stream in tiles of kBM = 64 rows through a two-stage ring
//     filled by TMA: one thread loads the first two tiles, and afterwards
//     the last of the 8 warps to be done with a stage (a shared counter)
//     loads the tile two ahead into it, so neither warpgroup waits for the
//     other.  Each warpgroup writes its own copy of q-hat = round(q *
//     round(scale)) and of the tile's lse, delta and segment ids.
//   - Per tile a warpgroup runs s^T = K q-hat^T and dp^T = V dO^T (wgmma,
//     operands in shared memory, 2 x 32 f32 registers), forms p^T =
//     exp(s^T - lse) and ds^T = p^T (dp^T - delta) on the fragments, rounds
//     them to bf16 in registers and runs dV += p^T dO and dK += ds^T q (raw
//     q) with those as register A operands, dO and q read MN-major.
//   - fused: dQ contracts over kv, but the ds^T fragments hold kv rows, so
//     each warpgroup also writes its ds^T tile (64 x 64 bf16) to its own
//     shared-memory tile and runs the tile's dQ share = ds K_wg (64 q rows x
//     DP, one 64-column panel at a time) with A = ds read MN-major from
//     that tile and B = its K rows read MN-major.  Two lanes swap halves so
//     each thread holds 4 adjacent columns of one row, and the share goes to
//     the f32 workspace by one float4 atomicAdd (a vector reduction, sm_90)
//     per 4 values: per q tile and (b, h), Lk / 64 reductions for every 4
//     elements where the CUDA-core kernel made Lk / 64 scalar ones for every
//     element, 4x fewer.  The order of those additions changes from run to
//     run, so dq's f32 rounding does too; the wrapper scales and casts the
//     workspace after the launch.
//   - dK is multiplied by scale once, at the end, and both are cast to bf16.
// Causal q tiles wholly above a warpgroup's rows are skipped.  Eight warps
// leave each thread 255 registers: the 128 f32 accumulators of dK and dV at
// DP = 128 (and the 32 of a dQ share panel in fused) and the rest fit
// without spills (ptxas: 229 dkv, 225 fused; see flash_fwd.cu on why there
// is no producer warp).
// Shared memory: 196 KB at DP = 128, 100 KB at DP = 64, and 16 KB more for
// the ds^T tiles of fused; one CTA per SM.
//
// dq.  A CTA of two warpgroups owns kDqRows = 128 q rows of one (b, h), 64
// per warpgroup, heaviest causal tiles first.  Its q-hat (rounded in place)
// and dO rows are loaded once by TMA and stay resident; each thread keeps
// the lse and delta of its two rows in registers.  K and V stream in tiles
// of kDqKv = 64 rows through a two-stage ring refilled as in dkv.  Per kv
// tile a warpgroup runs S = q-hat K^T and dP = dO V^T (wgmma, both K-major,
// 2 x 32 f32 registers), forms p = exp(S - lse) and ds = p (dP - delta) on
// the fragments, rounds ds to bf16 in registers and runs dQ += ds K with ds
// as the register A operand (S's fragment of columns 16 k.. is the A
// fragment of k16 step k) and K read MN-major from the same tile.  Causal
// kv tiles wholly above a warpgroup's rows are skipped.  dQ (64 x DP f32
// per warpgroup) is multiplied by scale once at the end and cast to bf16;
// there are no atomics, so dq is deterministic.  Shared memory: 128 KB at
// DP = 128, 64 KB at DP = 64.
//
// Bound: 8 (dkv), 10 (fused) or 6 (dq) L^2 D flops per head, halved when
// causal, against ~8 L D values: tensor-core bf16 operations (989 TFLOP/s).
namespace tc {

using namespace hopper;

constexpr int kBN = 128;        // kv rows of a dkv / fused CTA, 64 per warpgroup
constexpr int kBM = 64;         // q rows of a streamed tile
constexpr int kDqRows = 128;    // q rows of a dq CTA, 64 per warpgroup
constexpr int kDqKv = 64;       // kv rows of a tile streamed by dq
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;

template <int DP, bool kFused>
struct DkvSmem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kKV = kPanels * kBN * kRowBytes;   // resident K or V
  static constexpr int kQ = kPanels * kBM * kRowBytes;    // q, dO or q-hat tile
  static constexpr int kOffV = kKV;
  // stage s at kOffStage + s * kStage: q, dO, q-hat of warpgroups 0 and 1
  static constexpr int kOffStage = 2 * kKV;
  static constexpr int kStage = 4 * kQ;
  // fused: the ds^T tile (64 kv rows of 64 q columns) of each warpgroup
  static constexpr int kDs = kBM * kRowBytes;
  static constexpr int kOffDs = kOffStage + kStages * kStage;
  // lse, delta, seg_q of a tile, per (stage, warpgroup)
  static constexpr int kOffStats = kOffDs + (kFused ? 2 * kDs : 0);
  static constexpr int kStats = 3 * kBM * 4;
  static constexpr int kOffBar = kOffStats + kStages * 2 * kStats;  // kv, full[]
  static constexpr int kOffDone = kOffBar + 8 * (1 + kStages);      // done[]
  static constexpr int kBytes = kOffDone + 4 * kStages + 1024;
};

// the body of the dkv and fused kernels; kFused adds each tile's dQ share
// to dq_ws
template <int DP, bool kFused>
__device__ __forceinline__ void dkv_tc(const CUtensorMap* map_q,
                                       const CUtensorMap* map_k,
                                       const CUtensorMap* map_v,
                                       const CUtensorMap* map_do,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       const int* __restrict__ seg_q,
                                       const int* __restrict__ seg_kv,
                                       float* __restrict__ dq_ws,
                                       __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv, int H,
                                       int Lq, int Lk, int D, int causal,
                                       float scale) {
  using L = DkvSmem<DP, kFused>;
  constexpr int P = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms: 1024 B
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + L::kOffV;
  const uint32_t bar_kv = base + L::kOffBar;
  const uint32_t bar_full = bar_kv + 8;
  // warps done with each stage's current tile, counted up forever
  unsigned* done = reinterpret_cast<unsigned*>(gbase + L::kOffDone);

  const int k0 = blockIdx.x * kBN;      // causal: the heaviest tiles come first
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  // causal: q tiles ending before this CTA's first key are all masked
  const int first = causal ? k0 / kBM : 0;
  const int n_tiles = (Lq + kBM - 1) / kBM - first;

  // q and dO of tile j into stage s
  auto load_q = [&](int j, int s) {
    const uint32_t st = base + L::kOffStage + s * L::kStage;
    const int q0 = (first + j) * kBM;
    mbar_expect_tx(bar_full + 8 * s, 2 * L::kQ);
    tma_load_tile(st, map_q, bar_full + 8 * s, P, kBM, q0, bh);
    tma_load_tile(st + L::kQ, map_do, bar_full + 8 * s, P, kBM, q0, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_expect_tx(bar_kv, 2 * L::kKV);
    tma_load_tile(sK, map_k, bar_kv, P, kBN, k0, bh);
    tma_load_tile(sV, map_v, bar_kv, P, kBN, k0, bh);
    for (int j = 0; j < min(kStages, n_tiles); ++j) load_q(j, j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's fragment rows (entries e < 2, and e >= 2 eight rows on)
  // within a warpgroup's 64, and the first of its two columns in every
  // 8-column group
  const int fr = 16 * (t / 32) + lane / 4;
  const int wg_first = k0 + 64 * wg;
  const int kr0 = wg_first + fr;
  const int kr1 = kr0 + 8;
  const int c_in = 2 * (lane % 4);
  const bool has_seg = seg_q != nullptr;
  const int skv0 = has_seg && kr0 < Lk ? seg_kv[(size_t)b * Lk + kr0] : 0;
  const int skv1 = has_seg && kr1 < Lk ? seg_kv[(size_t)b * Lk + kr1] : 0;
  const float scale_t = round_bf16(scale);

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int q0 = (first + j) * kBM;
    const uint32_t sQ = base + L::kOffStage + s * L::kStage;
    const uint32_t sDO = sQ + L::kQ, sQh = sQ + (2 + wg) * L::kQ;
    float* stats = reinterpret_cast<float*>(gbase + L::kOffStats +
                                            (2 * s + wg) * L::kStats);
    const bool live = wg_first < Lk && (!causal || q0 + kBM - 1 >= wg_first);
    float lse_r = 0.f, delta_r = 0.f;
    int seg_r = 0;
    if (live && t < kBM && q0 + t < Lq) {
      lse_r = lse[(size_t)bh * Lq + q0 + t];
      delta_r = delta[(size_t)bh * Lq + q0 + t];
      if (has_seg) seg_r = seg_q[(size_t)b * Lq + q0 + t];
    }
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
    if (live) {
      // this warpgroup's q-hat and statistics of the tile
      uint8_t* g = gbase + (sQ - base);
      for (int i = t; i < L::kQ / 16; i += 128)
        scale_chunk(reinterpret_cast<const uint4*>(g) + i,
                    reinterpret_cast<uint4*>(g + (2 + wg) * L::kQ) + i,
                    scale_t);
      if (t < kBM) {
        stats[t] = lse_r;
        stats[kBM + t] = delta_r;
        reinterpret_cast<int*>(stats)[2 * kBM + t] = seg_r;
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);

      float sT[kBM / 2], dpT[kBM / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss(sT, desc_kmajor(sK, kBN, 64 * wg, k),
                 desc_kmajor(sQh, kBM, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss(dpT, desc_kmajor(sV, kBN, 64 * wg, k),
                 desc_kmajor(sDO, kBM, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(sT);
      hold(dpT);

      const int* sseg = reinterpret_cast<const int*>(stats + 2 * kBM);
      const bool masked = has_seg || q0 + kBM > Lq || wg_first + 64 > Lk ||
                          (causal && q0 < wg_first + 63);
#pragma unroll
      for (int i = 0; i < kBM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * i + c_in + (e & 1);      // q column in the tile
          float sv = sT[4 * i + e];
          if (masked) {
            const int kr = e < 2 ? kr0 : kr1;
            bool ok = kr < Lk && q0 + c < Lq;
            if (has_seg) ok = ok && sseg[c] == (e < 2 ? skv0 : skv1);
            if (causal) ok = ok && q0 + c >= kr;
            if (!ok) sv = kNegInf;
          }
          const float p = expf(sv - stats[c]);
          dpT[4 * i + e] = p * (dpT[4 * i + e] - stats[kBM + c]);
          sT[4 * i + e] = p;
        }
      // p^T in dO's dtype and ds^T in q's dtype as register A operands
      uint32_t pf[kBM / 16][4], df[kBM / 16][4];
#pragma unroll
      for (int k = 0; k < kBM / 16; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pf[k][e] = pack_bf16(sT[8 * k + 2 * e], sT[8 * k + 2 * e + 1]);
          df[k][e] = pack_bf16(dpT[8 * k + 2 * e], dpT[8 * k + 2 * e + 1]);
        }
      const uint32_t sDs = base + L::kOffDs + wg * L::kDs;
      if constexpr (kFused) {
        // ds^T (k's dtype = q's) into this warpgroup's swizzled tile: df[k][e]
        // holds kv row fr (+ 8 for odd e), q columns 16 k + 8 (e / 2) + c_in
        uint8_t* sd = gbase + (sDs - base);
#pragma unroll
        for (int k = 0; k < kBM / 16; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = fr + 8 * (e & 1);
            const int c = 16 * k + 8 * (e >> 1) + c_in;
            *reinterpret_cast<uint32_t*>(sd + r * kRowBytes +
                                         ((c / 8) ^ (r % 8)) * 16 +
                                         (c % 8) * 2) = df[k][e];
          }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBM / 16; ++k)
        wgmma_rs(dv_acc, pf[k], desc_mnmajor(sDO, kBM, k));
#pragma unroll
      for (int k = 0; k < kBM / 16; ++k)
        wgmma_rs(dk_acc, df[k], desc_mnmajor(sQ, kBM, k));
      wgmma_commit();
      wgmma_wait_all();
      hold(dv_acc);
      hold(dk_acc);
      hold(pf);
      hold(df);
      if constexpr (kFused) {
        // the tile's dQ share: rows q0 + fr (+ 8), one 64-column panel h of
        // K at a time; lanes 2m and 2m + 1 swap halves so that the even lane
        // holds columns 8 i + (c_in & 4) .. + 3 of row fr and the odd lane
        // those of row fr + 8
        float* wsb = dq_ws + (size_t)bh * Lq * D;
        const bool odd = lane & 1;
        const int r = q0 + fr + (odd ? 8 : 0);
#pragma unroll 1
        for (int h = 0; h < P; ++h) {
          float part[32];
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 64 / 16; ++k)
            wgmma_ss_mn(part, desc_mnmajor(sDs, kBM, k),
                        desc_mnmajor(sK + (h * kBN + 64 * wg) * kRowBytes,
                                     kBN, k),
                        k > 0);
          wgmma_commit();
          wgmma_wait_all();
          hold(part);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x0 = __shfl_xor_sync(0xffffffffu,
                                             odd ? part[4 * i] : part[4 * i + 2], 1);
            const float x1 = __shfl_xor_sync(0xffffffffu,
                                             odd ? part[4 * i + 1] : part[4 * i + 3], 1);
            const int col = 64 * h + 8 * i + (c_in & 4);
            if (r < Lq && col < D)
              atomicAdd(reinterpret_cast<float4*>(wsb + (size_t)r * D + col),
                        odd ? make_float4(x0, x1, part[4 * i + 2], part[4 * i + 3])
                            : make_float4(part[4 * i], part[4 * i + 1], x0, x1));
          }
        }
      }
    }
    // this warp is done with stage s; the last of the 8 refills it
    __syncwarp();
    if (lane == 0 && j + kStages < n_tiles &&
        atomicAdd(&done[s], 1u) % 8 == 7)
      load_q(j + kStages, s);
  }

  __nv_bfloat16* dkb = dk + (size_t)bh * Lk * D;
  __nv_bfloat16* dvb = dv + (size_t)bh * Lk * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c_in;
    if (col >= D) continue;
    if (kr0 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)kr0 * D + col) =
          pack_bf16(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)kr0 * D + col) =
          pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
    }
    if (kr1 < Lk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)kr1 * D + col) =
          pack_bf16(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + (size_t)kr1 * D + col) =
          pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg_q,
                             const int* __restrict__ seg_kv,
                             float* __restrict__ dq_ws,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Lq,
                             int Lk, int D, int causal, float scale) {
  dkv_tc<DP, false>(&map_q, &map_k, &map_v, &map_do, lse, delta, seg_q,
                    seg_kv, dq_ws, dk, dv, H, Lq, Lk, D, causal, scale);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_bf16_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ seg_q,
                               const int* __restrict__ seg_kv,
                               float* __restrict__ dq_ws,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int Lq,
                               int Lk, int D, int causal, float scale) {
  dkv_tc<DP, true>(&map_q, &map_k, &map_v, &map_do, lse, delta, seg_q,
                   seg_kv, dq_ws, dk, dv, H, Lq, Lk, D, causal, scale);
}

template <int DP>
struct DqSmem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQ = kPanels * kDqRows * kRowBytes;   // q-hat or dO
  static constexpr int kKV = kPanels * kDqKv * kRowBytes;    // a K or V tile
  static constexpr int kOffDO = kQ;
  // stage s at kOffStage + s * 2 kKV: K, then V
  static constexpr int kOffStage = 2 * kQ;
  static constexpr int kOffBar = kOffStage + kStages * 2 * kKV;   // q, full[]
  static constexpr int kOffDone = kOffBar + 8 * (1 + kStages);    // done[]
  static constexpr int kBytes = kOffDone + 4 * kStages + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ seg_q,
                            const int* __restrict__ seg_kv,
                            __nv_bfloat16* __restrict__ dq, int H, int Lq,
                            int Lk, int D, int causal, float scale) {
  using L = DqSmem<DP>;
  constexpr int P = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms: 1024 B
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sDO = base + L::kOffDO;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8;
  // warps done with each stage's current tile, counted up forever
  unsigned* done = reinterpret_cast<unsigned*>(gbase + L::kOffDone);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // heaviest causal first
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  int n_kv = (Lk + kDqKv - 1) / kDqKv;
  if (causal) n_kv = min(n_kv, (min(q0 + kDqRows, Lq) - 1) / kDqKv + 1);

  // K and V of kv tile `it` into stage `s`
  auto load_kv = [&](int it, int s) {
    const uint32_t st = base + L::kOffStage + s * 2 * L::kKV;
    mbar_expect_tx(bar_full + 8 * s, 2 * L::kKV);
    tma_load_tile(st, &map_k, bar_full + 8 * s, P, kDqKv, it * kDqKv, bh);
    tma_load_tile(st + L::kKV, &map_v, bar_full + 8 * s, P, kDqKv,
                  it * kDqKv, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_expect_tx(bar_q, 2 * L::kQ);
    tma_load_tile(sQ, &map_q, bar_q, P, kDqRows, q0, bh);
    tma_load_tile(sDO, &map_do, bar_q, P, kDqRows, q0, bh);
    for (int it = 0; it < min(kStages, n_kv); ++it) load_kv(it, it);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's dQ rows (fragment entries e < 2 and e >= 2) and the first
  // of its two columns in every 8-column group
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
  const int row1 = row0 + 8;
  const int c_in = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg;
  const int wg_last = min(wg_first + 63, Lq - 1);
  const bool has_seg = seg_q != nullptr;
  const int sq0 = has_seg && row0 < Lq ? seg_q[(size_t)b * Lq + row0] : 0;
  const int sq1 = has_seg && row1 < Lq ? seg_q[(size_t)b * Lq + row1] : 0;
  const float lse0 = row0 < Lq ? lse[(size_t)bh * Lq + row0] : 0.f;
  const float lse1 = row1 < Lq ? lse[(size_t)bh * Lq + row1] : 0.f;
  const float delta0 = row0 < Lq ? delta[(size_t)bh * Lq + row0] : 0.f;
  const float delta1 = row1 < Lq ? delta[(size_t)bh * Lq + row1] : 0.f;

  // this warpgroup's 64 q rows to round(q * round(scale)), in place
  mbar_wait(bar_q, 0);
  const float scale_t = round_bf16(scale);
  for (int i = t; i < P * 64 * 8; i += 128) {
    uint4* c = reinterpret_cast<uint4*>(
        gbase + (i / 512) * kDqRows * kRowBytes + (64 * wg) * kRowBytes +
        (i % 512) * 16);
    scale_chunk(c, c, scale_t);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages;
    const int k0 = it * kDqKv;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    if (wg_first < Lq && (!causal || k0 <= wg_last)) {
      const uint32_t sK = base + L::kOffStage + s * 2 * L::kKV;
      const uint32_t sV = sK + L::kKV;
      float sc[kDqKv / 2], dp[kDqKv / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss(sc, desc_kmajor(sQ, kDqRows, 64 * wg, k),
                 desc_kmajor(sK, kDqKv, 0, k), k > 0);
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss(dp, desc_kmajor(sDO, kDqRows, 64 * wg, k),
                 desc_kmajor(sV, kDqKv, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);
      hold(dp);

      const bool masked = has_seg || k0 + kDqKv > Lk ||
                          (causal && k0 + kDqKv - 1 > wg_first);
#pragma unroll
      for (int i = 0; i < kDqKv / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = sc[4 * i + e];
          if (masked) {
            const int col = k0 + 8 * i + c_in + (e & 1);
            bool ok = col < Lk;
            if (causal) ok = ok && (e < 2 ? row0 : row1) >= col;
            if (has_seg && ok)
              ok = (e < 2 ? sq0 : sq1) == seg_kv[(size_t)b * Lk + col];
            if (!ok) sv = kNegInf;
          }
          const float p = expf(sv - (e < 2 ? lse0 : lse1));
          sc[4 * i + e] = p * (dp[4 * i + e] - (e < 2 ? delta0 : delta1));
        }
      // ds in k's dtype as the register A operand
      uint32_t df[kDqKv / 16][4];
#pragma unroll
      for (int k = 0; k < kDqKv / 16; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          df[k][e] = pack_bf16(sc[8 * k + 2 * e], sc[8 * k + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kDqKv / 16; ++k)
        wgmma_rs(dq_acc, df[k], desc_mnmajor(sK, kDqKv, k));
      wgmma_commit();
      wgmma_wait_all();
      hold(dq_acc);
      hold(df);
    }
    // this warp is done with stage s; the last of the 8 refills it
    __syncwarp();
    if (lane == 0 && it + kStages < n_kv &&
        atomicAdd(&done[s], 1u) % 8 == 7)
      load_kv(it + kStages, s);
  }

  __nv_bfloat16* dqb = dq + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c_in;
    if (col >= D) continue;
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row0 * D + col) =
          pack_bf16(dq_acc[4 * i] * scale, dq_acc[4 * i + 1] * scale);
    if (row1 < Lq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row1 * D + col) =
          pack_bf16(dq_acc[4 * i + 2] * scale, dq_acc[4 * i + 3] * scale);
  }
}

template <int DP>
cudaError_t launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  // dq: CTAs of kDqRows q rows stream kv tiles of kDqKv; dkv and fused: CTAs
  // of kBN kv rows stream q tiles of kBM
  const bool dq = kind == kDq;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, a.q, B * a.H, a.Lq, a.D, dq ? kDqRows : kBM) ||
      !make_map(&mdo, a.dout, B * a.H, a.Lq, a.D, dq ? kDqRows : kBM) ||
      !make_map(&mk, a.k, B * a.H, a.Lk, a.D, dq ? kDqKv : kBN) ||
      !make_map(&mv, a.v, B * a.H, a.Lk, a.D, dq ? kDqKv : kBN))
    return cudaErrorInvalidValue;
  const int rows = dq ? kDqRows : kBN;
  dim3 grid(((dq ? a.Lq : a.Lk) + rows - 1) / rows, a.H, B);
  cudaError_t err;
  if (dq) {
    const int smem = DqSmem<DP>::kBytes;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_tc_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv,
        static_cast<__nv_bfloat16*>(a.dq), a.H, a.Lq, a.Lk, a.D, a.causal,
        a.scale);
    return cudaGetLastError();
  }
  const bool fused = kind == kFusedKind;
  auto kernel = fused ? flash_bwd_fused_bf16_tc_kernel<DP>
                      : flash_bwd_dkv_bf16_tc_kernel<DP>;
  const int smem = fused ? DkvSmem<DP, true>::kBytes
                         : DkvSmem<DP, false>::kBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv, a.dq_ws,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.H, a.Lq, a.Lk, a.D, a.causal, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  return a.D <= 64 ? launch<64>(kind, a, B, stream)
                   : launch<128>(kind, a, B, stream);
}

}  // namespace tc

namespace {

// dq: D x kLdT staging tiles for q-hat / dO and k / v, one 64 x kLdT ds
// tile and the segment ids of both sides
size_t smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)D * kLdT + (size_t)kB * kLdT) +
         sizeof(int) * 2 * kB;
}

template <typename T, int NG>
cudaError_t launch_dq(const Args& a, int B, cudaStream_t stream) {
  // bf16 with D <= tc::kMaxD = 64 NG runs tc::dispatch (run sends it
  // there), so those instantiations are not built
  if constexpr (std::is_same<T, float>::value || 64 * NG > tc::kMaxD) {
    const size_t smem = smem_bytes(a.D);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, NG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.Lq + kB - 1) / kB, a.H, B);
    flash_bwd_dq_kernel<T, NG><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(Kind kind, const Args& a, int B, cudaStream_t s) {
  if (kind != kDq) return simt::dispatch_dkv<T>(kind == kFusedKind, a, B, s);
  if (a.D <= 64) return launch_dq<T, 1>(a, B, s);
  if (a.D <= 128) return launch_dq<T, 2>(a, B, s);
  if (a.D <= 192) return launch_dq<T, 3>(a, B, s);
  return launch_dq<T, 4>(a, B, s);
}

int run(Kind kind, const Args& a, int B, int dtype, void* stream) {
  if (B < 1 || a.H < 1 || a.Lq < 1 || a.Lk < 1 || a.D < 8 || a.D > 256 ||
      a.D % 8 != 0)
    return -1;
  if ((a.seg_q == nullptr) != (a.seg_kv == nullptr)) return -1;
  if (B > 65535 || a.H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(kind, a, B, s);
  else if (dtype == 1 && a.D <= tc::kMaxD)
    err = tc::dispatch(kind, a, B, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(kind, a, B, s);
  else
    return -1;
  return static_cast<int>(err);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* seg_q,
               const int* seg_kv, int H, int Lq, int Lk, int D, int causal,
               float scale) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = lse; a.delta = delta;
  a.seg_q = seg_q; a.seg_kv = seg_kv;
  a.H = H; a.Lq = Lq; a.Lk = Lk; a.D = D; a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = f32, 1 = bf16.
// Each returns 0 on a successful launch, a cudaError_t code otherwise, and
// -1 for arguments the kernels do not take.  Nothing is allocated or
// synchronised here.

// dq (B, H, Lq, D) in q's dtype.
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, const int* seg_q,
                               const int* seg_kv, void* dq, int B, int H,
                               int Lq, int Lk, int D, int causal, float scale,
                               int dtype, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, seg_q, seg_kv, H, Lq, Lk, D,
                     causal, scale);
  a.dq = dq;
  return run(kDq, a, B, dtype, stream);
}

// dk, dv (B, H, Lk, D) in k's dtype.
extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const int* seg_q,
                                const int* seg_kv, void* dk, void* dv, int B,
                                int H, int Lq, int Lk, int D, int causal,
                                float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, seg_q, seg_kv, H, Lq, Lk, D,
                     causal, scale);
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, a, B, dtype, stream);
}

// dk, dv as above; dq_ws (B, H, Lq, D) f32, zeroed by the caller, receives
// the unscaled dQ sums (the caller multiplies by scale and casts).
extern "C" int mx_flash_bwd_fused(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* seg_q,
                                  const int* seg_kv, float* dq_ws, void* dk,
                                  void* dv, int B, int H, int Lq, int Lk,
                                  int D, int causal, float scale, int dtype,
                                  void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, seg_q, seg_kv, H, Lq, Lk, D,
                     causal, scale);
  a.dq_ws = dq_ws;
  a.dk = dk;
  a.dv = dv;
  return run(kFusedKind, a, B, dtype, stream);
}
