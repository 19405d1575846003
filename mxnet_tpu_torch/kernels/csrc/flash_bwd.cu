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
// Design.  Tiles are 64 q rows by 64 kv rows; a CTA of 256 threads is a
// 16 x 16 grid (ty, tx), and thread (ty, tx) owns a 4 x 4 block of each
// 64 x 64 score tile (rows 4 ty.., cols 4 tx..).  Operand tiles are staged
// in shared memory d-major (D x 68 floats, 16-byte rows) so a score tile
// costs two 16-byte shared loads per d for 16 FMAs, as in flash_fwd.cu.
// Two D x 68 staging buffers are reused for every operand of a step
// (q/k, then dO/v, then the row-major right-hand sides of the
// accumulations), which keeps shared memory at 2 D x 68 floats plus one to
// three 64 x 68 tiles for p and ds: 69-122 KB at D = 64-128, 157-192 KB at
// D = 256, so every head_dim the forward takes fits.
//   - dq: one CTA per (q tile, head, batch), heaviest causal tiles first,
//     loops over kv tiles and keeps its 64 x D dQ rows in f32 registers.
//   - dkv: one CTA per (kv tile, head, batch) loops over q tiles and keeps
//     its 64 x D dK and dV rows in f32 registers.
//   - fused: the dkv CTA also turns each tile's ds into a dQ share
//     (ds K over its 64 kv rows) and adds it to an f32 workspace with
//     atomicAdd, so S, P and dS are computed once per (q tile, kv tile)
//     pair and one launch yields all three gradients.  The order of those
//     additions changes from run to run, so dq's f32 rounding does too;
//     the wrapper scales and casts the workspace after the launch.
// Products run on the CUDA cores in f32 FMA for both dtypes: the tensor
// cores would round f32 inputs to TF32, which the reference does not.
//
// Bound: at the training shapes (L = 512-2048, D = 64-128) the work is
// 6-10 L^2 D flops per head against ~8 L D elements moved, far above the
// card's ridge point, so the kernels are bound by operations: f32 FMA on
// the CUDA cores (67 TFLOP/s peak).  This first version reloads k/v tiles
// from L2 once per product instead of keeping them resident; wgmma for
// bf16, TMA and resident operands are left for a later version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kB = 64;        // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLdT = 68;      // row stride of d-major tiles and p/ds tiles
constexpr float kNegInf = -1e30f;

template <typename T> struct Elt;

template <> struct Elt<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ unsigned short bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    uint2 u;
    u.x = (unsigned)bits(x.x) | ((unsigned)bits(x.y) << 16);
    u.y = (unsigned)bits(x.z) | ((unsigned)bits(x.w) << 16);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

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

// dK and dV rows of one kv tile, looping over q tiles (the port of
// _dkv_kernel); kFused also adds each tile's dQ share to a.dq_ws (the port
// of _bwd_fused_kernel).
template <typename T, int NG, bool kFused>
__global__ void __launch_bounds__(kThreads, NG <= (kFused ? 1 : 2) ? 2 : 1)
flash_bwd_dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = a.D;
  float* bufA = smem;                       // D x kLdT
  float* bufB = bufA + D * kLdT;            // D x kLdT
  float* sP = bufB + D * kLdT;              // kB x kLdT: p[r][c]
  float* sDS = sP + kB * kLdT;              // kB x kLdT: ds[r][c]
  float* sDSq = sDS + kB * kLdT;            // fused: kB x kLdT: ds[c][r]
  float* sLse = sDSq + (kFused ? kB * kLdT : 0);
  float* sDelta = sLse + kB;
  int* sSegQ = reinterpret_cast<int*>(sDelta + kB);
  int* sSegK = sSegQ + kB;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kB;     // causal: the heaviest tiles come first
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
    sSegK[tid] = (k0 + tid < Lk) ? a.seg_kv[(size_t)b * Lk + k0 + tid] : 0;
  float acc_dk[4][4 * NG], acc_dv[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int n_q = (Lq + kB - 1) / kB;
  // causal: q tiles ending before this kv tile's first key are all masked
  const int first = a.causal ? k0 / kB : 0;

  for (int iq = first; iq < n_q; ++iq) {
    const int q0 = iq * kB;
    __syncthreads();   // the previous tile is done with every buffer
    stage_dmajor<T, false>(bufA, kb, k0, Lk, D, 0.f);
    stage_dmajor<T, true>(bufB, qb, q0, Lq, D, scale_t);
    if (tid < kB) {
      const bool in = q0 + tid < Lq;
      sLse[tid] = in ? a.lse[bh * Lq + q0 + tid] : 0.f;
      sDelta[tid] = in ? a.delta[bh * Lq + q0 + tid] : 0.f;
      if (has_seg) sSegQ[tid] = in ? a.seg_q[(size_t)b * Lq + q0 + tid] : 0;
    }
    __syncthreads();
    float s[4][4], dp[4][4];   // transposed tiles: rows kv 4 ty.., cols q 4 tx..
    tile_product(s, bufA, bufB, D, ty, tx);
    __syncthreads();
    stage_dmajor<T, false>(bufA, vb, k0, Lk, D, 0.f);
    stage_dmajor<T, false>(bufB, dob, q0, Lq, D, 0.f);
    __syncthreads();
    tile_product(dp, bufA, bufB, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        bool ok = k0 + c < Lk && q0 + r < Lq;
        if (has_seg) ok = ok && sSegQ[r] == sSegK[c];
        if (a.causal) ok = ok && q0 + r >= k0 + c;
        const float p = expf((ok ? s[i][j] : kNegInf) - sLse[r]);
        dp[i][j] = Elt<T>::round(p * (dp[i][j] - sDelta[r]));   // ds, q's dtype
        s[i][j] = Elt<T>::round(p);                               // p, dO's dtype
      }
      if (kFused)
        *reinterpret_cast<float4*>(&sDSq[c * kLdT + tx * 4]) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&sP[(tx * 4 + j) * kLdT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&sDS[(tx * 4 + j) * kLdT + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();   // p / ds complete; V^T / dO^T reads done
    stage_rows<T>(bufA, dob, q0, Lq, D);
    stage_rows<T>(bufB, qb, q0, Lq, D);       // raw q for dk
    __syncthreads();
    accumulate<NG>(acc_dv, sP, bufA, D, ty, tx);
    accumulate<NG>(acc_dk, sDS, bufB, D, ty, tx);
    if (kFused) {
      __syncthreads();   // dO / q rows read
      stage_rows<T>(bufA, kb, k0, Lk, D);
      __syncthreads();
      // this tile's dQ share: rows q0 + 4 ty + i, one 4-column group at a
      // time so no second 64 x D accumulator lives in registers
      float* wsb = a.dq_ws + bh * Lq * D;
#pragma unroll 1
      for (int g = 0; g < NG; ++g) {
        const int d = (tx + 16 * g) * 4;
        if (d >= D) break;
        float part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll 4
        for (int c = 0; c < kB; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(&sDSq[c * kLdT + ty * 4]);
          const float4 x = *reinterpret_cast<const float4*>(&bufA[c * D + d]);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            part[i][0] = fmaf(wv[i], x.x, part[i][0]);
            part[i][1] = fmaf(wv[i], x.y, part[i][1]);
            part[i][2] = fmaf(wv[i], x.z, part[i][2]);
            part[i][3] = fmaf(wv[i], x.w, part[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + ty * 4 + i;
          if (r < Lq) {
            float* o = wsb + (size_t)r * D + d;
            atomicAdd(o + 0, part[i][0]);
            atomicAdd(o + 1, part[i][1]);
            atomicAdd(o + 2, part[i][2]);
            atomicAdd(o + 3, part[i][3]);
          }
        }
      }
    }
  }
  store_rows<T, NG>(static_cast<T*>(a.dk) + bh * Lk * D, acc_dk, k0, Lk, D,
                    a.scale, ty, tx);
  store_rows<T, NG>(static_cast<T*>(a.dv) + bh * Lk * D, acc_dv, k0, Lk, D,
                    1.f, ty, tx);
}

enum Kind { kDq = 0, kDkv = 1, kFusedKind = 2 };

size_t smem_bytes(int D, Kind kind) {
  const int tiles = kind == kDq ? 1 : kind == kDkv ? 2 : 3;
  const int stats = kind == kDq ? 0 : 2 * kB;   // lse, delta of a q tile
  return sizeof(float) * (2 * (size_t)D * kLdT + (size_t)tiles * kB * kLdT +
                          stats) +
         sizeof(int) * 2 * kB;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, Kind kind, const Args& a, int B,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D, kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int L = kind == kDq ? a.Lq : a.Lk;
  dim3 grid((L + kB - 1) / kB, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NG>
cudaError_t launch_kind(Kind kind, const Args& a, int B, cudaStream_t s) {
  if (kind == kDq) return launch(flash_bwd_dq_kernel<T, NG>, kind, a, B, s);
  if (kind == kDkv)
    return launch(flash_bwd_dkv_kernel<T, NG, false>, kind, a, B, s);
  return launch(flash_bwd_dkv_kernel<T, NG, true>, kind, a, B, s);
}

template <typename T>
cudaError_t dispatch_d(Kind kind, const Args& a, int B, cudaStream_t s) {
  if (a.D <= 64) return launch_kind<T, 1>(kind, a, B, s);
  if (a.D <= 128) return launch_kind<T, 2>(kind, a, B, s);
  if (a.D <= 192) return launch_kind<T, 3>(kind, a, B, s);
  return launch_kind<T, 4>(kind, a, B, s);
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
