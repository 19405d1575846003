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
// Two kernels: simt::flash_fwd_kernel on the CUDA cores runs f32 at every
// D and bf16 with D > 128; tc::flash_fwd_bf16_tc_kernel below runs bf16
// with D <= 128 on the tensor cores.
//
// ---------------------------------------------------------------------------
// CUDA cores (simt::)
//
// simt::flash_fwd_kernel replaces the Pallas kernels _fwd_kernel and
// _fwd_single_kernel (mxnet_tpu/kernels/flash_attention.py:185,248) for
// f32 at every D and for bf16 with D > 128.  Products run as f32 FMA:
// the tensor cores would round f32 inputs to TF32, which the reference
// does not.
//
// Bound.  ~4 L^2 D flops per head (half when causal) against ~4 L D values
// moved is far above the card's ridge point: the kernel is bound by
// operations, f32 FMA on the CUDA cores (67 TFLOP/s).  An SM issues 128
// FMAs per clock but reads 128 bytes (32 floats) of shared memory per
// clock, so both products must take many FMAs per shared-memory load, and
// the loads must be in flight while the FMAs run.
//
// Design.  One CTA of 256 threads per (tile of BQ q rows, head, batch);
// BQ = 128 (64 when D > 128).  The q tile is the grid's slowest axis,
// heaviest (causal) first, so every head's longest tiles start in the
// first wave and the short ones fill the tail.  Thread (ty, tx) of an
// NR x TC grid (16 x 16, or 8 x 32) owns the 8 q rows 8 ty .. 8 ty + 7,
// and in registers, as a SIMT GEMM blocks them, an 8 x NS tile of S (kv
// columns tx + TC c) and an 8 x 4 NG tile of the f32 output accumulator
// (columns 4 tx + 4 TC g .. + 3): 8 x 4 and 8 x 8 at D = 128.
//   - Q is scaled once and stored d-major (Q^T), so one 16-byte load gives
//     4 of the thread's rows at one d.  K and V stay row-major, as they
//     arrive: S = (scale Q) K^T is taken over d in chunks of 4, one float4
//     of a k row against 4 d rows of Q^T: 128 FMAs per 12 16-byte loads at
//     D = 128, the Q^T loads shared by the 16 threads of a row.
//   - p goes to shared memory kv-major (P^T), and O += P V reads 8 rows of
//     P^T and 4 NG columns of V per kv row: 64 FMAs per 4 loads at D = 128.
//     P^T rows pass only between the threads of one row (one warp).
//   - In both products the next step's operands are loaded into a second
//     set of registers while this step's FMAs run.
//   - Row strides are padded by 16 bytes, so the 8 threads of each quarter
//     warp hit distinct banks.
//   - K and V tiles of kBK = 64 rows stream through a ring of kStages (3,
//     or 2 for f32 at D > 128) shared-memory stages, in the order K0 V0 K1
//     V1 ..., filled by 16-byte cp.async (zero fill past Lk): each tile is
//     issued kStages - 1 tiles ahead and lands while the FMAs of the tiles
//     before it run.  One __syncthreads per tile: it publishes the tile
//     and frees the stage the next copy refills.
//   - Masks run only where they can bite: the diagonal tiles of a causal
//     call, the ragged last tile, every tile when segment ids are given.
//     On a causal diagonal tile, a warp whose rows (16, or 8 at BQ = 64)
//     all lie above the tile's first key skips it (it would add p = 0 with alpha = 1), so
//     its SM partners issue alone.
//   - The row max is reduced across the TC threads of a row per tile (it
//     rescales the output); the row sum stays per thread until the end.
//   - No atomics: two launches on the same inputs give the same bits.
// Shared memory at D = 128: Q^T 66 KB, P^T 33 KB, three 33 KB stages, one
// CTA (8 warps) per SM.  ptxas (sm_90a): 209 registers at <float, 128,
// 128>, 162-167 at the other instantiations, no spills.
// What still holds it back (PERF.md): exp in full precision and the
// online softmax between the two products, and only 8 warps per SM to
// hide shared-memory latency.  Splitting d across two thread sets to give
// each an 8 x 8 S tile, and mbarriers in place of the per-tile
// __syncthreads, were tried and did not help.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

#include "hopper.cuh"

namespace simt {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // kv rows per tile (flash_attention.kv_tile)
constexpr int kRows = 8;         // q rows per thread
constexpr int kMaxSmem = 232448; // bytes of shared memory a CTA may use
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
  static __device__ __forceinline__ float of(float x) { return x; }
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
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    uint2 u;
    u.x = hopper::pack_bf16(x.x, x.y);
    u.y = hopper::pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(p) = u;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 of(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The thread grid and shared-memory plan of a CTA for element type T, head
// dimension padded to DP and BQ q rows.  Stages first (cp.async wants
// 16-byte aligned rows), then Q^T, then P^T.
template <typename T, int DP, int BQ>
struct Plan {
  static constexpr int kEpc = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int kNR = BQ / kRows;            // thread rows
  static constexpr int kTC = kThreads / kNR;        // threads per row
  static constexpr int kNS = kBK / kTC;             // S columns per thread
  static constexpr int kNG = DP / (4 * kTC);        // output float4 groups
  static constexpr int kLdKV = DP + kEpc;           // K / V row stride
  static constexpr int kLdQ = BQ + kEpc;            // Q^T row stride
  static constexpr int kLdP = BQ + 4;               // P^T row stride (f32)
  static constexpr int kTile = kBK * kLdKV;         // elements of a stage
  static constexpr int kTileBytes = kTile * (int)sizeof(T);
  static constexpr int kQBytes = DP * kLdQ * (int)sizeof(T);
  static constexpr int kPBytes = kBK * kLdP * 4;
  static constexpr int kStages =
      3 * kTileBytes + kQBytes + kPBytes <= kMaxSmem ? 3 : 2;
  static constexpr int kBytes = kStages * kTileBytes + kQBytes + kPBytes;
  static_assert(kNS * kTC == kBK && kNG * 4 * kTC == DP, "thread grid");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

template <typename T, int DP, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Lq, int Lk, int D,
                 int causal, float scale) {
  using L = Plan<T, DP, BQ>;
  constexpr int TC = L::kTC, NS = L::kNS, NG = L::kNG, S = L::kStages;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* sRing = reinterpret_cast<T*>(smem);
  T* sQT = reinterpret_cast<T*>(smem + S * L::kTileBytes);
  float* sPT = reinterpret_cast<float*>(smem + S * L::kTileBytes + L::kQBytes);

  const int tid = threadIdx.x;
  const int tx = tid % TC, ty = tid / TC;
  // q tiles are the grid's slowest axis, heaviest (causal) first, so
  // every head's longest tiles start in the first wave
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * H + blockIdx.x;
  const T* qb = q + bh * Lq * D;
  const T* kb = k + bh * Lk * D;
  const T* vb = v + bh * Lk * D;
  const bool has_seg = seg_q != nullptr;

  int n_kv = (Lk + kBK - 1) / kBK;
  if (causal) {
    // kv tiles whose first key lies past this q tile's last row are
    // entirely masked: skip them (the accumulators pass through)
    n_kv = min(n_kv, (min(q0 + BQ, Lq) - 1) / kBK + 1);
  }
  const int n_tiles = 2 * n_kv;

  // ring tile t (K of kv tile t / 2 for even t, V for odd t) into stage
  // t % S, as one commit group (empty past the last tile, so the group
  // count stays uniform)
  const int cpr = D / L::kEpc;                 // 16-byte chunks per row
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const T* src = (t & 1) ? vb : kb;
      const int k0 = (t >> 1) * kBK;
      T* dst = sRing + (t % S) * L::kTile;
      for (int i = tid; i < kBK * cpr; i += kThreads) {
        const int r = i / cpr, c = (i % cpr) * L::kEpc;
        const bool ok = k0 + r < Lk;
        cp_async16(hopper::smem_addr(dst + r * L::kLdKV + c),
                   ok ? src + (size_t)(k0 + r) * D + c : src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < S - 1; ++t) issue(t);

  // columns D .. DP - 1 of every stage stay zero (no copy writes them)
  for (int i = tid; i < S * kBK * (DP - D); i += kThreads)
    sRing[(i / (DP - D)) * L::kLdKV + D + i % (DP - D)] = Elt<T>::of(0.f);

  // scale folded into q in q's dtype: round(round(q) * round(scale)),
  // stored d-major; rows past Lq and columns past D are zero
  const float scale_t = Elt<T>::round(scale);
  for (int i = tid; i < BQ * (DP / 4); i += kThreads) {
    const int r = i % BQ, d = (i / BQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq && d < D) x = Elt<T>::load4(qb + (size_t)(q0 + r) * D + d);
    sQT[(d + 0) * L::kLdQ + r] = Elt<T>::of(Elt<T>::round(x.x * scale_t));
    sQT[(d + 1) * L::kLdQ + r] = Elt<T>::of(Elt<T>::round(x.y * scale_t));
    sQT[(d + 2) * L::kLdQ + r] = Elt<T>::of(Elt<T>::round(x.z * scale_t));
    sQT[(d + 3) * L::kLdQ + r] = Elt<T>::of(Elt<T>::round(x.w * scale_t));
  }

  float acc[kRows][4 * NG];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  float m_row[kRows], l_part[kRows];     // l: this thread's columns only
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_row[i] = kMFloor;
    l_part[i] = 0.f;
  }
  const T* sQrow = sQT + kRows * ty;
  const int warp_last_row = q0 + kRows * ((tid | 31) / TC) + kRows - 1;
  const float* sProw = sPT + kRows * ty;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S - 2>();   // tile t has landed (this thread's copies)
    __syncthreads();          // ... and everyone's; tile t - 1 is consumed
    issue(t + S - 1);         // into tile t - 1's stage
    const T* tile = sRing + (t % S) * L::kTile;
    const int k0 = (t >> 1) * kBK;
    // a warp whose rows all lie above this kv tile's first key (causal)
    // would add p = 0 with alpha = 1: it skips the tile, bit for bit alike
    if (causal && warp_last_row < k0) continue;

    if ((t & 1) == 0) {
      // S = (scale Q) K^T: rows 8 ty + i, columns tx + TC c
      float s[kRows][NS];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NS; ++c) s[i][c] = 0.f;
      // operands of the next step are loaded while this one's FMAs run
      // (registers double-buffered): the k rows' float4 one chunk of 4 d
      // ahead, the Q^T pair one d ahead
      const T* krow = tile + tx * L::kLdKV;
      float4 kf[NS], qa[2];
#pragma unroll
      for (int c = 0; c < NS; ++c)
        kf[c] = Elt<T>::load4(krow + TC * c * L::kLdKV);
      qa[0] = Elt<T>::load4(sQrow);
      qa[1] = Elt<T>::load4(sQrow + 4);
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const int dn = d + 4 < D ? d + 4 : d;
        float4 kn[NS];
#pragma unroll
        for (int c = 0; c < NS; ++c)
          kn[c] = Elt<T>::load4(krow + TC * c * L::kLdKV + dn);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* qn = sQrow + (e < 3 ? d + e + 1 : dn) * L::kLdQ;
          const float4 qb0 = Elt<T>::load4(qn), qb1 = Elt<T>::load4(qn + 4);
          const float av[kRows] = {qa[0].x, qa[0].y, qa[0].z, qa[0].w,
                                   qa[1].x, qa[1].y, qa[1].z, qa[1].w};
#pragma unroll
          for (int c = 0; c < NS; ++c) {
            const float kv = lane(kf[c], e);
#pragma unroll
            for (int i = 0; i < kRows; ++i) s[i][c] = fmaf(av[i], kv, s[i][c]);
          }
          qa[0] = qb0;
          qa[1] = qb1;
        }
#pragma unroll
        for (int c = 0; c < NS; ++c) kf[c] = kn[c];
      }

      if (has_seg || k0 + kBK > Lk || (causal && k0 + kBK - 1 > q0)) {
        int sq[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = q0 + kRows * ty + i;
          sq[i] = has_seg && r < Lq ? seg_q[(size_t)b * Lq + r] : 0;
        }
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const int col = k0 + tx + TC * c;
          const bool in = col < Lk;
          const int skv = has_seg && in ? seg_kv[(size_t)b * Lk + col] : 0;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            bool ok = in;
            if (has_seg) ok = ok && sq[i] == skv;
            if (causal) ok = ok && q0 + kRows * ty + i >= col;
            if (!ok) s[i][c] = kNegInf;
          }
        }
      }

      // online softmax of the thread's rows; p to P^T in v's dtype
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int c = 1; c < NS; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
        for (int o = TC / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_row[i], mx);
        const float alpha = expf(m_row[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < NS; ++c) {
          const float p = expf(s[i][c] - m_new);
          psum += p;
          s[i][c] = Elt<T>::round(p);
        }
        l_part[i] = l_part[i] * alpha + psum;
        m_row[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        float* dst = sPT + (tx + TC * c) * L::kLdP + kRows * ty;
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
      }
    } else {
      // acc += P V (P^T was published by this tile's __syncthreads)
      // P^T and V rows one kv row ahead, as in S
      const T* vcol = tile + 4 * tx;
      float4 pa[2], va[NG];
      pa[0] = *reinterpret_cast<const float4*>(sProw);
      pa[1] = *reinterpret_cast<const float4*>(sProw + 4);
#pragma unroll
      for (int g = 0; g < NG; ++g) va[g] = Elt<T>::load4(vcol + 4 * TC * g);
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const int jn = j + 1 < kBK ? j + 1 : j;
        const float4 pb0 =
            *reinterpret_cast<const float4*>(sProw + jn * L::kLdP);
        const float4 pb1 =
            *reinterpret_cast<const float4*>(sProw + jn * L::kLdP + 4);
        float4 vb[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          vb[g] = Elt<T>::load4(vcol + jn * L::kLdKV + 4 * TC * g);
        const float pv[kRows] = {pa[0].x, pa[0].y, pa[0].z, pa[0].w,
                                 pa[1].x, pa[1].y, pa[1].z, pa[1].w};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 x = va[g];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][4 * g + 0] = fmaf(pv[i], x.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pv[i], x.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pv[i], x.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pv[i], x.w, acc[i][4 * g + 3]);
          }
        }
        pa[0] = pb0;
        pa[1] = pb1;
#pragma unroll
        for (int g = 0; g < NG; ++g) va[g] = vb[g];
      }
    }
  }
  cp_async_wait<0>();

  T* ob = out + bh * Lq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = l_part[i];
#pragma unroll
    for (int o = TC / 2; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    const int r = q0 + kRows * ty + i;
    if (r >= Lq) continue;
    const float safe_l = l == 0.f ? 1.f : l;   // fully masked
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * (tx + TC * g);
      if (d < D)
        Elt<T>::store4(ob + (size_t)r * D + d,
                       make_float4(acc[i][4 * g + 0] / safe_l,
                                   acc[i][4 * g + 1] / safe_l,
                                   acc[i][4 * g + 2] / safe_l,
                                   acc[i][4 * g + 3] / safe_l));
    }
    if (tx == 0) lse[bh * Lq + r] = m_row[i] + logf(safe_l);
  }
}

template <typename T, int DP, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg_q, const int* seg_kv, void* out, float* lse,
                   int B, int H, int Lq, int Lk, int D, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Plan<T, DP, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DP, BQ><<<grid, kThreads, smem, stream>>>(
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
      return launch<T, 64, 128>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
    if (D <= 128)
      return launch<T, 128, 128>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
  }
  return launch<T, 256, 64>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, stream);
}

}  // namespace simt

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
    err = simt::dispatch_d<float>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else if (dtype == 1 && D <= tc::kMaxD)
    err = tc::dispatch_d(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else if (dtype == 1)
    err = simt::dispatch_d<__nv_bfloat16>(q, k, v, seg_q, seg_kv, out, lse, B, H, Lq, Lk, D, causal, scale, s);
  else
    return -1;
  return static_cast<int>(err);
}
