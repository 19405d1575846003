// Flash-attention forward for NVIDIA Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernels of mxnet_tpu/kernels/flash_attention.py:
//   _fwd_kernel (:185, launched by _fwd :345)                streaming
//   _fwd_single_kernel (:248, launched by _fwd_single :294)  single tile
// The single-tile kernel is the streaming one with one kv tile, so one
// kernel covers both.
//
// out = softmax(scale * Q K^T + mask) V, and lse = m + log(l) per row.
// q, k, v: (B, H, L, D) contiguous, f32 or bf16; seg_q (B, Lq) and
// seg_kv (B, Lk) int32 or both null; out (B, H, Lq, D) in q's dtype;
// lse (B, H, Lq) f32.  D is any multiple of 8 up to 256.
//
// Numerics kept exactly as the TPU kernel has them:
//   - the scale is folded into q in q's dtype (bf16 rounds there, :211);
//   - masked logits are -1e30 and the running max starts at -1e4
//     (_M_FLOOR, :43-46), so masked entries give an exact 0 without a
//     second pass;
//   - p is summed into l in f32, then rounded to v's dtype for the PV
//     product (:233-235); accumulation is f32;
//   - fully-masked rows return 0 and lse = m + log(1) (safe_l, :241-245);
//   - causal masks qi >= ki (top-left aligned, Lq != Lk allowed), and kv
//     tiles wholly above the diagonal are skipped.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, head, batch),
// heaviest causal q tiles first.  Thread (ty, tx) of a 16 x 16 grid owns
// rows 4 ty .. 4 ty + 3 of the tile.  Per kv tile of 64 rows:
//   1. K^T is staged in shared memory (d-major), and S = (scale Q) K^T is
//      computed as a 4 x 4 register tile per thread (cols 4 tx .. 4 tx + 3)
//      from two 16-byte shared loads per d;
//   2. the online softmax runs in registers: the 16 threads sharing a row
//      reduce its max and sum with shuffles, and rescale their slice of
//      the f32 output accumulator;
//   3. P^T goes to shared memory, V is staged in the buffer K^T used, and
//      the thread's 4 x (4 NG) accumulator slice (cols 4 (tx + 16 g)) takes
//      P V from one 16-byte load of P^T and NG of V per kv row.
// Products run on the CUDA cores in f32 FMA: the tensor cores would round
// f32 inputs to TF32, which the reference does not.  This kernel runs f32,
// and bf16 with D > 128; bf16 with D <= 128 runs the tensor-core kernel in
// namespace tc below.
//
// Bound: at serving shapes (L = 1024, D = 128) the work is ~4 L^2 D flops
// per head against ~4 L D elements moved, far above the card's ridge
// point, so the kernel is bound by operations: f32 FMA on the CUDA cores
// (67 TFLOP/s peak).  Shared memory is 87 KB at D = 128, two CTAs per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLdT = 68;   // row stride of the d-major tiles: 16-byte rows
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e4f;

template <typename T> struct Elt;

template <> struct Elt<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  // round an f32 value to the storage type (identity for f32)
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    // 4 bf16 in 8 bytes; a bf16 is the high half of its f32
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

// reductions over the 16 lanes (one thread row tx = 0..15) sharing a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int D) {
  // Q^T and the K^T / V buffer (D x kLdT each; V takes kBK x D <= that),
  // P^T (kBK x kLdT), segment ids of the q and kv tiles
  return sizeof(float) * (2 * (size_t)D * kLdT + (size_t)kBK * kLdT) +
         sizeof(int) * (kBQ + kBK);
}

// NG: 4-column output groups per thread are tx + 16 g for g < NG (D <= 64 NG)
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, NG <= 2 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D,
                 int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQT = smem;                     // D x kLdT   (scaled q, d-major)
  float* sKV = sQT + D * kLdT;           // D x kLdT as K^T, kBK x D as V
  float* sPT = sKV + D * kLdT;           // kBK x kLdT (p, kv-major)
  int* sSegQ = reinterpret_cast<int*>(sPT + kBK * kLdT);   // kBQ
  int* sSegK = sSegQ + kBQ;                                // kBK

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // heaviest (last) causal q tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const bool has_seg = seg_q != nullptr;
  const int D4 = D / 4;

  // scale folded into q in q's dtype: round(round(q) * round(scale))
  const float scale_t = Elt<T>::round(scale);
  for (int i = tid; i < kBQ * D4; i += kThreads) {
    const int r = i % kBQ, d = (i / kBQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq) x = Elt<T>::load4(qb + (size_t)(q0 + r) * D + d);
    sQT[(d + 0) * kLdT + r] = Elt<T>::round(x.x * scale_t);
    sQT[(d + 1) * kLdT + r] = Elt<T>::round(x.y * scale_t);
    sQT[(d + 2) * kLdT + r] = Elt<T>::round(x.z * scale_t);
    sQT[(d + 3) * kLdT + r] = Elt<T>::round(x.w * scale_t);
  }
  if (has_seg && tid < kBQ)
    sSegQ[tid] = (q0 + tid < Lq) ? seg_q[(size_t)b * Lq + q0 + tid] : 0;

  float acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  float m_row[4], l_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_row[i] = kMFloor;
    l_row[i] = 0.f;
  }

  int n_kv = (Lk + kBK - 1) / kBK;
  if (causal) {
    // kv tiles whose first key lies past this q tile's last row are
    // entirely masked: skip them (the accumulators pass through)
    const int last_q = min(q0 + kBQ, Lq) - 1;
    n_kv = min(n_kv, last_q / kBK + 1);
  }

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kBK;
    __syncthreads();   // previous tile's P V is done with sKV and sPT
    for (int i = tid; i < kBK * D4; i += kThreads) {
      const int c = i % kBK, d = (i / kBK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < Lk) x = Elt<T>::load4(kb + (size_t)(k0 + c) * D + d);
      sKV[(d + 0) * kLdT + c] = x.x;
      sKV[(d + 1) * kLdT + c] = x.y;
      sKV[(d + 2) * kLdT + c] = x.z;
      sKV[(d + 3) * kLdT + c] = x.w;
    }
    if (has_seg && tid < kBK)
      sSegK[tid] = (k0 + tid < Lk) ? seg_kv[(size_t)b * Lk + k0 + tid] : 0;
    __syncthreads();

    // S = (scale Q) K^T: rows 4 ty + i, cols 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQT[d * kLdT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&sKV[d * kLdT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online softmax of the thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        bool ok = k0 + c < Lk;
        if (has_seg) ok = ok && sSegQ[r] == sSegK[c];
        if (causal) ok = ok && q0 + r >= k0 + c;
        if (!ok) s[i][j] = kNegInf;
      }
      const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                     fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m_row[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        s[i][j] = Elt<T>::round(p);     // p in v's dtype for the PV product
      }
      const float alpha = expf(m_row[i] - m_new);
      l_row[i] = l_row[i] * alpha + row_sum(psum);
      m_row[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPT[(tx * 4 + j) * kLdT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // everyone is done reading K^T; P^T is complete

    for (int i = tid; i < kBK * D4; i += kThreads) {
      const int c = i / D4, d = (i % D4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < Lk) x = Elt<T>::load4(vb + (size_t)(k0 + c) * D + d);
      *reinterpret_cast<float4*>(&sKV[c * D + d]) = x;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&sPT[c * kLdT + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int d = (tx + 16 * g) * 4;
        if (d < D) {
          const float4 x = *reinterpret_cast<const float4*>(&sKV[c * D + d]);
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

  T* ob = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Lq) continue;
    const float safe_l = l_row[i] == 0.f ? 1.f : l_row[i];   // fully masked
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = (tx + 16 * g) * 4;
      if (d < D)
        Elt<T>::store4(ob + (size_t)(q0 + r) * D + d,
                       make_float4(acc[i][4 * g + 0] / safe_l,
                                   acc[i][4 * g + 1] / safe_l,
                                   acc[i][4 * g + 2] / safe_l,
                                   acc[i][4 * g + 3] / safe_l));
    }
    if (tx == 0) lse[bh * Lq + q0 + r] = m_row[i] + logf(safe_l);
  }
}

template <typename T, int NG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_kv, void* out, float* lse,
                   int B, int H, int Lq, int Lk, int D, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, NG><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg_q, seg_kv, static_cast<T*>(out), lse, H,
      Lq, Lk, D, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int* seg_q, const int* seg_kv, void* out,
                       float* lse, int B, int H, int Lq, int Lk, int D,
                       int causal, float scale, cudaStream_t stream) {
  // bf16 heads up to 128 run the tensor-core kernel (tc::): not built here
  if constexpr (std::is_same<T, float>::value) {
    if (D <= 64)
      return launch<T, 1>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
    if (D <= 128)
      return launch<T, 2>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
  }
  if (D <= 192)
    return launch<T, 3>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
  return launch<T, 4>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16, D <= 128: tensor cores
//
// The TPU kernel computes both products with bf16 operands and f32
// accumulation (_bmm, Precision.DEFAULT), which is what wgmma computes from
// bf16; the bf16 roundings sit at the operands (q * scale, p), so this
// kernel keeps the reference's numerics while running every product on the
// tensor cores.
//
// Design.  A CTA of two warpgroups (256 threads) owns 128 q rows of one
// (b, h), 64 rows per warpgroup.  K and V tiles of kBN = 128 rows stream
// through a two-stage shared-memory ring filled by TMA: one thread loads Q
// and the first two tiles, and afterwards the last of the 8 warps to be
// done with a stage (a shared counter) loads the tile two ahead into it, so
// neither warpgroup waits for the other.  Q is rounded in place to
// round(q * round(scale)).  Per kv tile a warpgroup runs S = Q K^T (wgmma,
// A and B from shared memory) into 64 f32 registers, masks and runs the
// online softmax on those fragments (rows reduced across the 4 lanes that
// share them), rescales its 64 x DP f32 accumulator, rounds p to bf16 in
// registers and runs O += P V with P as the register A operand and V read
// MN-major.  The plain version streams kv at kBN for bf16
// (flash_attention.kv_tile), so p rounds where the kernel rounds it.
// Eight warps leave each thread 255 registers (ptxas: 244 at DP = 128, no
// spills); a ninth, producer warp would put three warps on one of the SM's
// four register-file quarters and cap every thread at 168, and setmaxnreg
// on a producer warpgroup did not lift ptxas's allocation past ~192.
// Shared memory: 160 KB at DP = 128 (Q 32 KB, two stages of K and V),
// 80 KB at DP = 64; one CTA per SM.
// Bound: ~4 L^2 D flops per head against ~4 L D values, well above the
// ridge point: tensor-core bf16 operations (989 TFLOP/s).
namespace tc {

using namespace hopper;

constexpr int kBM = 128;        // q rows of a CTA, 64 per warpgroup
constexpr int kBN = 128;        // kv rows of a tile
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e4f;

template <int DP>
struct Smem {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kQ = kPanels * kBM * kRowBytes;     // bytes of Q
  static constexpr int kKV = kPanels * kBN * kRowBytes;    // of a K or V tile
  static constexpr int kOffK = kQ;                         // + stage * kKV
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffBar = kOffV + kStages * kKV;    // q, full[]
  static constexpr int kOffDone = kOffBar + 8 * (1 + kStages);  // done[]
  static constexpr int kBytes = kOffDone + 4 * kStages + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int Lq, int Lk, int D,
                         int causal, float scale) {
  using L = Smem<DP>;
  constexpr int P = L::kPanels;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms: 1024 B
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t bar_q = base + L::kOffBar;
  const uint32_t bar_full = bar_q + 8;
  // warps done with each stage's current tile, counted up forever
  unsigned* done = reinterpret_cast<unsigned*>(gbase + L::kOffDone);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // heaviest causal first
  const int b = blockIdx.z;
  const int bh = b * H + blockIdx.y;
  int n_kv = (Lk + kBN - 1) / kBN;
  if (causal) n_kv = min(n_kv, (min(q0 + kBM, Lq) - 1) / kBN + 1);

  // kv tile `it` into stage `s`
  auto load_kv = [&](int it, int s) {
    mbar_expect_tx(bar_full + 8 * s, 2 * L::kKV);
    tma_load_tile(base + L::kOffK + s * L::kKV, &map_k, bar_full + 8 * s, P,
                  kBN, it * kBN, bh);
    tma_load_tile(base + L::kOffV + s * L::kKV, &map_v, bar_full + 8 * s, P,
                  kBN, it * kBN, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      done[s] = 0;
    }
    fence_barrier_init();
    mbar_expect_tx(bar_q, L::kQ);
    tma_load_tile(sQ, &map_q, bar_q, P, kBM, q0, bh);
    for (int it = 0; it < min(kStages, n_kv); ++it) load_kv(it, it);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's accumulator rows (fragment entries j < 2 and j >= 2) and
  // the first of its two columns in every 8-column group
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
  const int row1 = row0 + 8;
  const int c_in = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg;
  const int wg_last = min(wg_first + 63, Lq - 1);
  const bool has_seg = seg_q != nullptr;
  const int sq0 = has_seg && row0 < Lq ? seg_q[(size_t)b * Lq + row0] : 0;
  const int sq1 = has_seg && row1 < Lq ? seg_q[(size_t)b * Lq + row1] : 0;

  // this warpgroup's 64 q rows to round(q * round(scale)), in place
  mbar_wait(bar_q, 0);
  const float scale_t = round_bf16(scale);
  for (int i = t; i < P * 64 * 8; i += 128) {
    uint4* c = reinterpret_cast<uint4*>(
        gbase + (i / 512) * kBM * kRowBytes + (64 * wg) * kRowBytes +
        (i % 512) * 16);
    scale_chunk(c, c, scale_t);
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = kMFloor, m1 = kMFloor, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int s = it % kStages;
    const int k0 = it * kBN;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    if (wg_first < Lq && (!causal || k0 <= wg_last)) {
      const uint32_t sK = base + L::kOffK + s * L::kKV;
      const uint32_t sV = base + L::kOffV + s * L::kKV;
      float sc[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < DP / 16; ++k)
        wgmma_ss(sc, desc_kmajor(sQ, kBM, 64 * wg, k),
                 desc_kmajor(sK, kBN, 0, k), k > 0);
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);

      if (has_seg || k0 + kBN > Lk || (causal && k0 + kBN - 1 > wg_first)) {
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = k0 + 8 * i + c_in + (j & 1);
            const int row = j < 2 ? row0 : row1;
            bool ok = col < Lk;
            if (causal) ok = ok && row >= col;
            if (has_seg && ok)
              ok = (j < 2 ? sq0 : sq1) == seg_kv[(size_t)b * Lk + col];
            if (!ok) sc[4 * i + j] = kNegInf;
          }
      }
      // online softmax of rows row0 (entries j = 0, 1) and row1 (2, 3)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        sc[4 * i] = expf(sc[4 * i] - mx0);
        sc[4 * i + 1] = expf(sc[4 * i + 1] - mx0);
        sc[4 * i + 2] = expf(sc[4 * i + 2] - mx1);
        sc[4 * i + 3] = expf(sc[4 * i + 3] - mx1);
        ps0 += sc[4 * i] + sc[4 * i + 1];
        ps1 += sc[4 * i + 2] + sc[4 * i + 3];
      }
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
      const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
      // p in v's dtype as the A operand: the accumulator fragment of
      // columns 16 k .. 16 k + 15 is the A fragment of k16 step k
      uint32_t pf[kBN / 16][4];
#pragma unroll
      for (int k = 0; k < kBN / 16; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pf[k][j] = pack_bf16(sc[8 * k + 2 * j], sc[8 * k + 2 * j + 1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBN / 16; ++k)
        wgmma_rs(o, pf[k], desc_mnmajor(sV, kBN, k));
      wgmma_commit();
      wgmma_wait_all();
      hold(o);
      hold(pf);
    }
    // this warp is done with stage s; the last of the 8 refills it
    __syncwarp();
    if (lane == 0 && it + kStages < n_kv &&
        atomicAdd(&done[s], 1u) % 8 == 7)
      load_kv(it + kStages, s);
  }

  const float safe0 = l0 == 0.f ? 1.f : l0;     // fully masked rows
  const float safe1 = l1 == 0.f ? 1.f : l1;
  __nv_bfloat16* ob = out + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int col = 8 * i + c_in;
    if (col >= D) continue;
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * D + col) =
          pack_bf16(o[4 * i] / safe0, o[4 * i + 1] / safe0);
    if (row1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * D + col) =
          pack_bf16(o[4 * i + 2] / safe1, o[4 * i + 3] / safe1);
  }
  if (lane % 4 == 0) {
    if (row0 < Lq) lse[(size_t)bh * Lq + row0] = m0 + logf(safe0);
    if (row1 < Lq) lse[(size_t)bh * Lq + row1] = m1 + logf(safe1);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_kv, void* out, float* lse,
                   int B, int H, int Lq, int Lk, int D, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B * H, Lq, D, kBM) ||
      !make_map(&mk, k, B * H, Lk, D, kBN) ||
      !make_map(&mv, v, B * H, Lk, D, kBN))
    return cudaErrorInvalidValue;
  const int smem = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBM - 1) / kBM, H, B);
  flash_fwd_bf16_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, seg_q, seg_kv, static_cast<__nv_bfloat16*>(out), lse, H, Lq,
      Lk, D, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int* seg_q, const int* seg_kv, void* out,
                       float* lse, int B, int H, int Lq, int Lk, int D,
                       int causal, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<64>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
  return launch<128>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
}

}  // namespace tc

// Plain C entry point (bound with ctypes).  dtype: 0 = f32, 1 = bf16.
// bf16 with D <= tc::kMaxD runs the tensor-core kernel; f32, and bf16 with
// a wider head, the CUDA-core kernel.
// Returns 0 on a successful launch, a cudaError_t code otherwise, and -1
// for arguments the kernel does not take.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const int* seg_q, const int* seg_kv, void* out,
                            float* lse, int B, int H, int Lq, int Lk, int D,
                            int causal, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 8 || D > 256 || D % 8 != 0)
    return -1;
  if ((seg_q == nullptr) != (seg_kv == nullptr)) return -1;
  if (B > 65535 || H > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else if (dtype == 1 && D <= tc::kMaxD)
    err = tc::dispatch_d(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else
    return -1;
  return static_cast<int>(err);
}
