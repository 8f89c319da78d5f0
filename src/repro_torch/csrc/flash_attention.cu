// Flash attention for Hopper (sm_90a): the forward with its row
// log-sum-exp, and the backward as two kernels, dq and dk/dv.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   flash_fwd  <- repro/kernels/flash_attention/kernel.py flash_attention_fwd
//                 (body _flash_kernel)
//   flash_dq   <- repro/kernels/flash_attention/backward.py flash_attention_bwd,
//                 first pallas_call (_dq_kernel)
//   flash_dkv  <- the same function's second pallas_call (_dkv_kernel)
// The plain PyTorch versions of all three are in
// repro_torch/kernels/flash_attention/ops.py.
//
// Layouts: q, out, dout [B, H, Sq, hd]; k, v [B, Hkv, Skv, hd]; lse and
// delta f32 [B, H, Sq]; all contiguous and 16-byte aligned; head h reads
// kv head h / (H/Hkv), so no K/V is replicated. Masks are on indices: key
// kp is seen by query qp iff kp < Skv, (causal) kp <= qp, (window > 0)
// qp - kp < window; the backward also requires qp < Sq. Masked scores are
// -1e30, not -inf, as in the reference, and l is clamped at 1e-30 before
// the division and lse = m + log(l).
//
// What bounds them on an H100: at the training shape (q [2,24,4096,128],
// k/v [2,2,4096,128], causal) the forward does 2 products of 103 GFLOP,
// dq 3 and dk/dv 4, against ~110 MB of tensors: about 2,000 operations
// per byte, far above the ~295 where device memory stops being the
// limit, so all three are bound by arithmetic: 989 TFLOP/s in bf16 on
// the tensor cores. Measured on an H100 (700 W), the bf16 kernels below
// reach 16-22% of that bound at the training shape: mma.sync rather than
// wgmma, 16 rows a warp (every warp reads whole K/V tiles through
// ldmatrix), 2 blocks of 4 warps an SM (shared memory and registers).
//
// bfloat16 (the training path): every product runs on the tensor cores,
// mma.sync m16n8k16 with f32 accumulators, operands from shared memory
// through ldmatrix (.trans where the product needs the tile's columns).
// A block is 4 warps; each warp owns 16 rows of the output tile (query
// rows in the forward and dq, key rows in dk/dv), so every row reduction
// stays inside a quad of lanes. Tiles are 64 x 64. Each 64-row tile of
// K/V (of Q/dout/lse/delta in dk/dv) is copied by cp.async, 16 bytes a
// thread, into one of two shared buffers while the other one is being
// multiplied; rows past Sq/Skv are zero-filled by the copy (no padded
// copies). Shared rows are padded by 16 bytes, so the 8 row addresses of
// an ldmatrix fall in 8 distinct groups of 4 banks. Scores are scaled
// after the product, in f32 (exp2 with log2(e) folded into the scale).
// The forward keeps m, l and the output in registers; P goes from the
// score accumulators straight into the A operand of P.V (an m16n8
// accumulator pair is an m16k16 A fragment). dq keeps dS the same way
// for dS.K. dk/dv computes S^T = K.Q^T and dP^T = V.dout^T with the key
// rows as the MMA's M dimension, so P^T and dS^T are already A operands
// of dV += P^T.dout and dK += dS^T.Q. Each chain of MMAs covers one tile
// from zero accumulators and is folded into the running sums with f32
// adds (see mma_chain: the tensor cores' own accumulation drifts over
// long chains).
//
// P and dS are f32 and are fed to the tensor cores as two bf16 terms,
// hi = bf16(x) and lo = bf16(x - hi), two MMAs into one f32 sum: a
// residual of 2^-16 of x or less instead of bf16's 2^-8. Rounding P once
// to bf16 moves an output that sums 4,096 keys by ~2^-9 rms(v)/64, about
// 2.5e-5 at unit v: more than the 1e-5 that the checks allow where the
// output is near zero, and those checks hold these kernels to the plain
// versions, which keep P and dS in f32 as the JAX kernels do. The split
// costs 1.5x the P.V product in the forward, 4/3 x dq's products and
// 6/4 x dk/dv's. Q, K, V and dout are bf16 already, so their products are
// exact in f32.
//
// dk/dv: one kv tile's dK and dV sum over every live q tile of every
// head of its GQA group (12 at starcoder2-3b), and under the causal mask
// the first kv tile has the most q tiles. So the group is split over
// `nsplit` blocks (the wrapper's choice, a divisor of the group), each
// writing f32 partial dK/dV; a second kernel sums the partials in split
// order and rounds to bf16. No atomics anywhere, so results are the same
// bits from run to run. Blocks with the most live tiles are launched
// first (the last q tiles in the forward and dq, the first kv tiles in
// dk/dv).
//
// float32 (the f32 smoke reference steps and checks) keeps the first
// version of these kernels: f32 FMAs on the CUDA cores (67 TFLOP/s),
// each of 256 threads owning a 4x4 piece of a 64x64 score tile (2x2 of a
// 32x32 tile at head dim 256, where 64-row tiles overflow shared
// memory), tiles in shared memory with padded rows, one block per output
// tile. It is chosen by dtype; there is no other switch.
//
// Head dim 256 (recurrentgemma-9b: 16 query heads over one kv head,
// window 2048) in bfloat16 is flash_attention_hd256.cu's (wgmma and TMA,
// blocks that own the whole head dim); here it is float32 only. Under a
// window, whole tiles outside it are skipped, as under the causal limit
// (tile_live): at S = 4,096 with window 2,048 a q tile visits at most 33
// kv tiles of 64.
//
// TPU -> Hopper: the Pallas kernels carry (m, l, acc) across a sequential
// kv grid axis in VMEM scratch. Hopper blocks run in parallel and in no
// order, so each block here owns one output tile and loops over kv (or,
// for dk/dv, over q tiles x heads of the group) inside itself, skipping
// whole tiles the causal or window limit masks out.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launches (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// query tile i and key tile j of T rows each share a seen pair; a tile
// wholly outside the causal limit or the window is skipped
template <int T = BQ>
__device__ __forceinline__ bool tile_live(int i, int j, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = live && (j * T <= i * T + T - 1);
  if (window > 0) live = live && (i * T - (j * T + T - 1) < window);
  return live;
}

// every (query, key) pair of tiles (i, j) is seen, and every query row is
// below Sq: the per-element mask can be skipped
__device__ __forceinline__ bool tile_full(int i, int j, int sq, int skv,
                                          int causal, int window) {
  bool full = (j + 1) * BK <= skv && (i + 1) * BQ <= sq;
  if (causal) full = full && (j * BK + BK - 1 <= i * BQ);
  if (window > 0) full = full && (i * BQ + BQ - 1 - j * BK < window);
  return full;
}

__device__ __forceinline__ bool seen(int qp, int kp, int skv, int causal,
                                     int window) {
  bool ok = kp < skv;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// =========================================================================
// float32: f32 FMAs on the CUDA cores
// =========================================================================

constexpr int TY = 16;
constexpr int TX = 16;
constexpr int NT = TY * TX;     // 256 threads

// Tiles are T x T with T = 64, or 32 at head dim 256, where 64-row dq
// and dk/dv tiles need 280,320 and 296,960 bytes of shared memory, past
// the 232,448 a block can have.
template <int HD>
struct Cfg {
  static constexpr int T = HD > 128 ? 32 : 64;  // query and key rows a tile
  static constexpr int RPT = T / TY;    // score rows per thread
  static constexpr int CPT = T / TX;    // score columns per thread
  static constexpr int LD = HD + 1;     // padded f32 rows
  static constexpr int LDP = T + 1;     // f32 [T][T]
  static constexpr int DPT = HD / TX;   // out columns per thread
};

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// rows [row0, row0 + ROWS) of a [nrows, HD] matrix -> shared memory with
// row stride LD, times `mul`; rows past nrows load as zeros
template <int HD, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int nrows, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NT) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int gr = row0 + r;
    dst[r * LD + d] =
        gr < nrows ? src[static_cast<size_t>(gr) * HD + d] * mul : 0.f;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_stats(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int row0, int nrows) {
  for (int r = threadIdx.x; r < ROWS; r += NT)
    dst[r] = row0 + r < nrows ? src[row0 + r] : 0.f;
}

// s[r][c] = sum_d A[ty*RPT + r][d] * B[tx + c*TX][d]
template <int HD, int LD, int RPT, int CPT>
__device__ __forceinline__ void scores(const float* __restrict__ A,
                                       const float* __restrict__ Bm, int ty,
                                       int tx, float (&s)[RPT][CPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RPT], b[CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) a[r] = A[(ty * RPT + r) * LD + d];
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = Bm[(tx + c * TX) * LD + d];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
               float scale, int causal, int window) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + C::T * C::LD;
  float* Ks = Ps + C::T * C::LDP;
  float* Vs = Ks + C::T * C::LD;

  const int n_q = (Sq + C::T - 1) / C::T;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;

  load_rows<HD, C::LD, C::T>(Qs, q + q_off, i * C::T, Sq, scale);

  float m[C::RPT], l[C::RPT], acc[C::RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < C::RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) acc[r][e] = 0.f;
  }
  const int n_kv = (Skv + C::T - 1) / C::T;
  for (int j = 0; j < n_kv; ++j) {
    if (!tile_live<C::T>(i, j, causal, window)) continue;
    __syncthreads();  // the previous tile's K, V, P are no longer read
    load_rows<HD, C::LD, C::T>(Ks, k + kv_off, j * C::T, Skv, 1.f);
    load_rows<HD, C::LD, C::T>(Vs, v + kv_off, j * C::T, Skv, 1.f);
    __syncthreads();
    float s[C::RPT][C::CPT];
    scores<HD, C::LD, C::RPT, C::CPT>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) {
      const int row = ty * C::RPT + r;
      const int qp = i * C::T + row;
      float mt = NEG_INF;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        if (!seen(qp, j * C::T + tx + c * TX, Skv, causal, window))
          s[r][c] = NEG_INF;
        mt = fmaxf(mt, s[r][c]);
      }
      const float mn = fmaxf(m[r], max16(mt));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        const float p = expf(s[r][c] - mn);
        Ps[row * C::LDP + tx + c * TX] = p;
        rs += p;
      }
      rs = sum16(rs);
      const float corr = expf(m[r] - mn);
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int e = 0; e < C::DPT; ++e) acc[r][e] *= corr;
      m[r] = mn;
    }
    __syncwarp();  // a P row is written and read by the same half-warp
#pragma unroll 4
    for (int c = 0; c < C::T; ++c) {
      float vv[C::DPT];
#pragma unroll
      for (int e = 0; e < C::DPT; ++e) vv[e] = Vs[c * C::LD + tx + e * TX];
#pragma unroll
      for (int r = 0; r < C::RPT; ++r) {
        const float p = Ps[(ty * C::RPT + r) * C::LDP + c];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < C::RPT; ++r) {
    const int row = i * C::T + ty * C::RPT + r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* o = out + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) o[tx + e * TX] = acc[r][e] / lc;
    if (tx == 0) lse[static_cast<size_t>(bh) * Sq + row] = m[r] + logf(lc);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Hkv, int Sq, int Skv,
              float scale, int causal, int window) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ds = Qs + C::T * C::LD;
  float* Ls = Ds + C::T * C::LDP;
  float* Dl = Ls + C::T;
  float* Os = Dl + C::T;
  float* Ks = Os + C::T * C::LD;
  float* Vs = Ks + C::T * C::LD;

  const int n_q = (Sq + C::T - 1) / C::T;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;

  load_rows<HD, C::LD, C::T>(Qs, q + q_off, i * C::T, Sq, scale);
  load_rows<HD, C::LD, C::T>(Os, dout + q_off, i * C::T, Sq, 1.f);
  load_stats<C::T>(Ls, lse + static_cast<size_t>(bh) * Sq, i * C::T, Sq);
  load_stats<C::T>(Dl, delta + static_cast<size_t>(bh) * Sq, i * C::T, Sq);

  float acc[C::RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < C::RPT; ++r)
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) acc[r][e] = 0.f;
  const int n_kv = (Skv + C::T - 1) / C::T;
  for (int j = 0; j < n_kv; ++j) {
    if (!tile_live<C::T>(i, j, causal, window)) continue;
    __syncthreads();
    load_rows<HD, C::LD, C::T>(Ks, k + kv_off, j * C::T, Skv, 1.f);
    load_rows<HD, C::LD, C::T>(Vs, v + kv_off, j * C::T, Skv, 1.f);
    __syncthreads();
    float s[C::RPT][C::CPT], dp[C::RPT][C::CPT];
    scores<HD, C::LD, C::RPT, C::CPT>(Qs, Ks, ty, tx, s);
    scores<HD, C::LD, C::RPT, C::CPT>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) {
      const int row = ty * C::RPT + r;
      const int qp = i * C::T + row;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) {
        const int col = tx + c * TX;
        const bool ok = qp < Sq && seen(qp, j * C::T + col, Skv, causal, window);
        const float p = expf((ok ? s[r][c] : NEG_INF) - Ls[row]);
        Ds[row * C::LDP + col] = p * (dp[r][c] - Dl[row]) * scale;
      }
    }
    __syncwarp();  // a dS row is written and read by the same half-warp
#pragma unroll 4
    for (int c = 0; c < C::T; ++c) {
      float kk[C::DPT];
#pragma unroll
      for (int e = 0; e < C::DPT; ++e) kk[e] = Ks[c * C::LD + tx + e * TX];
#pragma unroll
      for (int r = 0; r < C::RPT; ++r) {
        const float ds = Ds[(ty * C::RPT + r) * C::LDP + c];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) acc[r][e] = fmaf(ds, kk[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < C::RPT; ++r) {
    const int row = i * C::T + ty * C::RPT + r;
    if (row >= Sq) continue;
    float* o = dq + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) o[tx + e * TX] = acc[r][e];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
               float scale, int causal, int window) {
  using C = Cfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + C::T * C::LD;
  float* Ds = Ps + C::T * C::LDP;
  float* Ls = Ds + C::T * C::LDP;
  float* Dl = Ls + C::T;
  float* Os = Dl + C::T;
  float* Ks = Os + C::T * C::LD;
  float* Vs = Ks + C::T * C::LD;

  const int j = blockIdx.y;
  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int hk = bk % Hkv, b = bk / Hkv;
  const int group = H / Hkv;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t kv_off = static_cast<size_t>(bk) * Skv * HD;

  load_rows<HD, C::LD, C::T>(Ks, k + kv_off, j * C::T, Skv, 1.f);
  load_rows<HD, C::LD, C::T>(Vs, v + kv_off, j * C::T, Skv, 1.f);

  // rows ty*C::RPT + rr of this kv tile, columns tx + e*TX
  float dk_acc[C::RPT][C::DPT], dv_acc[C::RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < C::RPT; ++r)
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  const int n_q = (Sq + C::T - 1) / C::T;
  for (int i = 0; i < n_q; ++i) {
    if (!tile_live<C::T>(i, j, causal, window)) continue;
    for (int g = 0; g < group; ++g) {
      const size_t bh = static_cast<size_t>(b) * H + hk * group + g;
      const size_t q_off = bh * Sq * HD;
      __syncthreads();  // the previous (i, g) tiles are no longer read
      load_rows<HD, C::LD, C::T>(Qs, q + q_off, i * C::T, Sq, scale);
      load_rows<HD, C::LD, C::T>(Os, dout + q_off, i * C::T, Sq, 1.f);
      load_stats<C::T>(Ls, lse + bh * Sq, i * C::T, Sq);
      load_stats<C::T>(Dl, delta + bh * Sq, i * C::T, Sq);
      __syncthreads();
      float s[C::RPT][C::CPT], dp[C::RPT][C::CPT];
      scores<HD, C::LD, C::RPT, C::CPT>(Qs, Ks, ty, tx, s);
      scores<HD, C::LD, C::RPT, C::CPT>(Os, Vs, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < C::RPT; ++r) {
        const int row = ty * C::RPT + r;
        const int qp = i * C::T + row;
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) {
          const int col = tx + c * TX;
          const bool ok =
              qp < Sq && seen(qp, j * C::T + col, Skv, causal, window);
          const float p = expf((ok ? s[r][c] : NEG_INF) - Ls[row]);
          Ps[row * C::LDP + col] = p;
          Ds[row * C::LDP + col] = p * (dp[r][c] - Dl[row]) * scale;
        }
      }
      __syncthreads();  // every thread reads every row of P and dS
#pragma unroll 2
      for (int r = 0; r < C::T; ++r) {
        float o[C::DPT], qq[C::DPT];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) {
          o[e] = Os[r * C::LD + tx + e * TX];
          qq[e] = Qs[r * C::LD + tx + e * TX];
        }
#pragma unroll
        for (int rr = 0; rr < C::RPT; ++rr) {
          const float pv = Ps[r * C::LDP + ty * C::RPT + rr];
          const float dsv = Ds[r * C::LDP + ty * C::RPT + rr];
#pragma unroll
          for (int e = 0; e < C::DPT; ++e) {
            dv_acc[rr][e] = fmaf(pv, o[e], dv_acc[rr][e]);
            dk_acc[rr][e] = fmaf(dsv, qq[e], dk_acc[rr][e]);
          }
        }
      }
    }
  }
  // dS was taken against the pre-scaled q: divide the scale back out
#pragma unroll
  for (int rr = 0; rr < C::RPT; ++rr) {
    const int kr = j * C::T + ty * C::RPT + rr;
    if (kr >= Skv) continue;
    float* gk = dk + kv_off + static_cast<size_t>(kr) * HD;
    float* gv = dv + kv_off + static_cast<size_t>(kr) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) {
      gk[tx + e * TX] = dk_acc[rr][e] / scale;
      gv[tx + e * TX] = dv_acc[rr][e];
    }
  }
}

// =========================================================================
// bfloat16: tensor cores
// =========================================================================

// --- PTX primitives ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; 16 zero bytes if !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero if !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory: lanes 8m..8m+7 give the row
// addresses of matrix m; register m of lane l holds row l/4, columns
// 2(l%4), 2(l%4)+1 of matrix m (of its transpose with .trans)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a.b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column fragment b0, b1) and a 16x8 f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- fragments --------------------------------------------------------------
//
// An m16n8 f32 accumulator c[4] of lane l = 4g + t holds rows g (c[0],
// c[1]) and g + 8 (c[2], c[3]), columns 2t and 2t + 1. Two accumulators
// side by side (columns 0-7 and 8-15) hold an m16k16 A fragment's
// elements in its register order.

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) ~ hi + lo, each a pair of bf16
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// accumulators c0 (columns 0-7), c1 (8-15) -> the A fragments hi, lo of
// the m16k16 block they form
__device__ __forceinline__ void a_split(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// t0 += (hi + lo).b[0..1], t1 += (hi + lo).b[2..3]: two n8 blocks of a
// product whose A is split in two bf16 terms.
//
// The tensor cores' f32 accumulation is not an IEEE f32 sum: measured
// against f32 sums on an H100, dK and dV accumulated in one chain of
// MMAs over 4,096 queries x 12 heads drifted by up to 4e-4 relative
// (the error grew with the chain's length, identically from run to
// run), 2 to 4 bf16 ulps where the checks allow one. So every chain
// starts from zero accumulators (t0, t1) and covers at most one tile
// (the forward and dq: 64 keys; dk/dv: 16 queries), and add_to folds it
// into the running sum with an f32 add.
__device__ __forceinline__ void mma_chain(float (&t0)[4], float (&t1)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[4]) {
  mma_bf16(t0, hi, b[0], b[1]);
  mma_bf16(t0, lo, b[0], b[1]);
  mma_bf16(t1, hi, b[2], b[3]);
  mma_bf16(t1, lo, b[2], b[3]);
}

__device__ __forceinline__ void add_to(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int ld, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane % 16)) * ld + c0 + (lane / 16) * 8);
}

// B fragments of two n8 blocks for a product X.T^T: B[k][n] = T[n][k],
// n = n0..n0+15, k = k0..k0+15 (T row-major); b[0], b[1] for n0..n0+7,
// b[2], b[3] for n0+8..n0+15
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], const bf16* tile,
                                      int ld, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane / 16) * 8 + (lane % 8)) * ld + k0 +
                 ((lane / 8) % 2) * 8);
}

// B fragments of two n8 blocks for a product X.T: B[k][n] = T[k][n],
// k = k0..k0+15, n = n0..n0+15 (T row-major), in ld_bt's order
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* tile,
                                     int ld, int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + ((lane / 8) % 2) * 8 + (lane % 8)) * ld + n0 +
                   (lane / 16) * 8);
}

constexpr int MT = 128;   // threads of a tensor-core block: 4 warps

// head dims 16 to 128 (256 is flash_attention_hd256.cu's)
template <int HD>
struct MmaCfg {
  static_assert(HD <= 128, "bf16 head dim 256 is flash_attention_hd256.cu");
  static constexpr int LDS = HD + 8;     // bf16 row stride in shared memory
  static constexpr int TILE = 64 * LDS;  // one 64-row tile
  static constexpr int KD = HD / 16;     // k16 steps over hd
  static constexpr int OD = HD / 8;      // n8 output blocks
  static constexpr int OK = HD / 16;     // their n16 pairs
};

// rows [row0, row0 + 64) of a [nrows, HD] bf16 matrix -> a shared tile,
// by cp.async; rows past nrows are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows) {
  constexpr int CPR = HD / 8;  // 16-byte pieces per row
  for (int c = threadIdx.x; c < 64 * CPR; c += MT) {
    const int r = c / CPR, piece = c - r * CPR;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(dst + r * MmaCfg<HD>::LDS + piece * 8,
               src + static_cast<size_t>(ok ? gr : 0) * HD + piece * 8, ok);
  }
}

// 64 floats of a [nrows] row statistic -> shared memory, by cp.async
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int row0, int nrows) {
  if (threadIdx.x < 64) {
    const int gr = row0 + threadIdx.x;
    const bool ok = gr < nrows;
    cp_async4(dst + threadIdx.x, src + (ok ? gr : 0), ok);
  }
}

// the contiguous range [lo, hi) of tiles t with live(t)
template <typename F>
__device__ __forceinline__ void live_range(int n, F live, int& lo, int& hi) {
  lo = 0;
  while (lo < n && !live(lo)) ++lo;
  hi = lo;
  while (hi < n && live(hi)) ++hi;
}

// --- forward ------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(MT)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
                   float scale, int causal, int window) {
  using C = MmaCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + C::TILE;      // two buffers
  bf16* Vs = Ks + 2 * C::TILE;  // two buffers

  const int n_q = (Sq + BQ - 1) / BQ, n_kv = (Skv + BK - 1) / BK;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = i * BQ + warp * 16 + lane / 4;  // rows r0 and r0 + 8
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;
  int j0, j1;
  live_range(n_kv, [&](int j) { return tile_live(i, j, causal, window); },
             j0, j1);

  load_tile<HD>(Qs, q + q_off, i * BQ, Sq);
  if (j0 < j1) {
    load_tile<HD>(Ks, k + kv_off, j0 * BK, Skv);
    load_tile<HD>(Vs, v + kv_off, j0 * BK, Skv);
  }
  cp_async_commit();

  const float c2 = scale * LOG2E;   // scores in log2 units
  float o[C::OD][4];
#pragma unroll
  for (int d = 0; d < C::OD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) {  // the next tile loads while this one is multiplied
      load_tile<HD>(Ks + (buf ^ 1) * C::TILE, k + kv_off, (j + 1) * BK, Skv);
      load_tile<HD>(Vs + (buf ^ 1) * C::TILE, v + kv_off, (j + 1) * BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * C::TILE;
    const bf16* Vt = Vs + buf * C::TILE;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      uint32_t a[4];
      ld_a(a, Qs, C::LDS, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ld_bt(bb, Kt, C::LDS, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    const bool full = tile_full(i, j, Sq, Skv, causal, window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = r0 + (e / 2) * 8;
        const int kp = j * BK + n * 8 + 2 * t + (e % 2);
        s[n][e] = full || seen(qp, kp, Skv, causal, window) ? s[n][e] * c2
                                                             : NEG_INF;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - mn);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - mn);
          rs += s[n][e];
        }
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int d = 0; d < C::OD; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
      m[r] = mn;
    }

    // O += P.V, P as hi + lo, each 16-column block of O from fresh
    // accumulators over the tile's 64 keys (see mma_chain)
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) a_split(s[2 * kt], s[2 * kt + 1], hi[kt], lo[kt]);
#pragma unroll
    for (int dp = 0; dp < C::OK; ++dp) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t bb[4];
        ld_b(bb, Vt, C::LDS, kt * 16, dp * 16, lane);
        mma_chain(t0, t1, hi[kt], lo[kt], bb);
      }
      add_to(o[2 * dp], t0);
      add_to(o[2 * dp + 1], t1);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    const float lc = fmaxf(lt, 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* orow = out + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int d = 0; d < C::OD; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(o[d][2 * r] / lc, o[d][2 * r + 1] / lc);
    if (t == 0)
      lse[static_cast<size_t>(bh) * Sq + row] = m[r] * LN2 + logf(lc);
  }
}

// --- dq ---------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(MT)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int H, int Hkv, int Sq, int Skv, float scale, int causal,
                  int window) {
  using C = MmaCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + C::TILE;
  bf16* Ks = Os + C::TILE;      // two buffers
  bf16* Vs = Ks + 2 * C::TILE;  // two buffers

  const int n_q = (Sq + BQ - 1) / BQ, n_kv = (Skv + BK - 1) / BK;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = i * BQ + warp * 16 + lane / 4;  // rows r0 and r0 + 8
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;
  int j0, j1;
  live_range(n_kv, [&](int j) { return tile_live(i, j, causal, window); },
             j0, j1);

  load_tile<HD>(Qs, q + q_off, i * BQ, Sq);
  load_tile<HD>(Os, dout + q_off, i * BQ, Sq);
  if (j0 < j1) {
    load_tile<HD>(Ks, k + kv_off, j0 * BK, Skv);
    load_tile<HD>(Vs, v + kv_off, j0 * BK, Skv);
  }
  cp_async_commit();

  const float c2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lse2[r] = row < Sq ? lse[static_cast<size_t>(bh) * Sq + row] * LOG2E : 0.f;
    dl[r] = row < Sq ? delta[static_cast<size_t>(bh) * Sq + row] : 0.f;
  }
  float acc[C::OD][4];
#pragma unroll
  for (int d = 0; d < C::OD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1) {
      load_tile<HD>(Ks + (buf ^ 1) * C::TILE, k + kv_off, (j + 1) * BK, Skv);
      load_tile<HD>(Vs + (buf ^ 1) * C::TILE, v + kv_off, (j + 1) * BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * C::TILE;
    const bf16* Vt = Vs + buf * C::TILE;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      uint32_t aq[4], ao[4];
      ld_a(aq, Qs, C::LDS, warp * 16, kk * 16, lane);
      ld_a(ao, Os, C::LDS, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4], bv[4];
        ld_bt(bk, Kt, C::LDS, np * 16, kk * 16, lane);
        ld_bt(bv, Vt, C::LDS, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) scale, in s
    const bool full = tile_full(i, j, Sq, Skv, causal, window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = r0 + (e / 2) * 8;
        const int kp = j * BK + n * 8 + 2 * t + (e % 2);
        const bool ok =
            full || (qp < Sq && seen(qp, kp, Skv, causal, window));
        const float p = ok ? exp2f(s[n][e] * c2 - lse2[e / 2]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[e / 2]) * scale;
      }

    // dQ += dS.K, dS as hi + lo, in blocks as the forward's O
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) a_split(s[2 * kt], s[2 * kt + 1], hi[kt], lo[kt]);
#pragma unroll
    for (int d2 = 0; d2 < C::OK; ++d2) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t bb[4];
        ld_b(bb, Kt, C::LDS, kt * 16, d2 * 16, lane);
        mma_chain(t0, t1, hi[kt], lo[kt], bb);
      }
      add_to(acc[2 * d2], t0);
      add_to(acc[2 * d2 + 1], t1);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* drow = dq + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int d = 0; d < C::OD; ++d)
      *reinterpret_cast<__nv_bfloat162*>(drow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
  }
}

// --- dk / dv ----------------------------------------------------------------

// Block (b, kv head, split s) x kv tile j: the heads s*gps .. s*gps+gps-1
// of the kv head's group (gps = group / nsplit), every live q tile of
// each; f32 partials part[s][0 (dK) or 1 (dV)][b, kv head, row, d].
template <int HD>
__global__ void __launch_bounds__(MT)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ part,
                   int H, int Hkv, int Sq, int Skv, float scale, int causal,
                   int window, int nsplit) {
  using C = MmaCfg<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::TILE;
  bf16* Qs = Vs + C::TILE;      // two buffers
  bf16* Os = Qs + 2 * C::TILE;  // two buffers
  float* Ls = reinterpret_cast<float*>(Os + 2 * C::TILE);  // two buffers
  float* Dl = Ls + 2 * BQ;                                 // two buffers

  const int j = blockIdx.y;
  const int split = blockIdx.x % nsplit;
  const int bk = blockIdx.x / nsplit;  // b * Hkv + kv head
  const int n_bk = gridDim.x / nsplit;
  const int hk = bk % Hkv, b = bk / Hkv;
  const int group = H / Hkv, gps = group / nsplit;
  const int h0 = hk * group + split * gps;
  const int n_q = (Sq + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int kr0 = j * BK + warp * 16 + lane / 4;  // rows kr0 and kr0 + 8
  const size_t kv_off = static_cast<size_t>(bk) * Skv * HD;
  int i0, i1;
  live_range(n_q, [&](int i) { return tile_live(i, j, causal, window); },
             i0, i1);
  const int n_it = (i1 - i0) * gps;  // (q tile, head) pairs, head fastest

  auto load_q_side = [&](int it, int buf) {
    const int i = i0 + it / gps;
    const size_t bh = static_cast<size_t>(b) * H + h0 + it % gps;
    load_tile<HD>(Qs + buf * C::TILE, q + bh * Sq * HD, i * BQ, Sq);
    load_tile<HD>(Os + buf * C::TILE, dout + bh * Sq * HD, i * BQ, Sq);
    load_stat(Ls + buf * BQ, lse + bh * Sq, i * BQ, Sq);
    load_stat(Dl + buf * BQ, delta + bh * Sq, i * BQ, Sq);
  };
  load_tile<HD>(Ks, k + kv_off, j * BK, Skv);
  load_tile<HD>(Vs, v + kv_off, j * BK, Skv);
  if (n_it > 0) load_q_side(0, 0);
  cp_async_commit();

  const float c2 = scale * LOG2E;
  float dk[C::OD][4], dv[C::OD][4];
#pragma unroll
  for (int d = 0; d < C::OD; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    const int i = i0 + it / gps;
    if (it + 1 < n_it) load_q_side(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs + buf * C::TILE;
    const bf16* Ot = Os + buf * C::TILE;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Dl + buf * BQ;
    const bool full = tile_full(i, j, Sq, Skv, causal, window);

#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {  // 16 q rows at a time
      // S^T = K.Q^T and dP^T = V.dout^T: rows kv, columns q
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::KD; ++kk) {
        uint32_t ak[4], av[4], bq[4], bo[4];
        ld_a(ak, Ks, C::LDS, warp * 16, kk * 16, lane);
        ld_a(av, Vs, C::LDS, warp * 16, kk * 16, lane);
        ld_bt(bq, Qt, C::LDS, qq * 16, kk * 16, lane);
        ld_bt(bo, Ot, C::LDS, qq * 16, kk * 16, lane);
        mma_bf16(s[0], ak, bq[0], bq[1]);
        mma_bf16(s[1], ak, bq[2], bq[3]);
        mma_bf16(dp[0], av, bo[0], bo[1]);
        mma_bf16(dp[1], av, bo[2], bo[3]);
      }
      // P^T in s, dS^T in dp
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qq * 16 + n * 8 + 2 * t + (e % 2);
          const int qp = i * BQ + qc;
          const int kp = kr0 + (e / 2) * 8;
          const bool ok =
              full || (qp < Sq && seen(qp, kp, Skv, causal, window));
          const float p = ok ? exp2f(s[n][e] * c2 - Lt[qc] * LOG2E) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dt[qc]) * scale;
        }
      // dV += P^T.dout and dK += dS^T.Q over these 16 q rows
      uint32_t ph[4], pl[4], dh[4], dlo[4];
      a_split(s[0], s[1], ph, pl);
      a_split(dp[0], dp[1], dh, dlo);
#pragma unroll
      for (int d2 = 0; d2 < C::OK; ++d2) {
        uint32_t bo[4], bq[4];
        ld_b(bo, Ot, C::LDS, qq * 16, d2 * 16, lane);
        ld_b(bq, Qt, C::LDS, qq * 16, d2 * 16, lane);
        float v0[4] = {0.f, 0.f, 0.f, 0.f}, v1[4] = {0.f, 0.f, 0.f, 0.f};
        float k0[4] = {0.f, 0.f, 0.f, 0.f}, k1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_chain(v0, v1, ph, pl, bo);
        mma_chain(k0, k1, dh, dlo, bq);
        add_to(dv[2 * d2], v0);
        add_to(dv[2 * d2 + 1], v1);
        add_to(dk[2 * d2], k0);
        add_to(dk[2 * d2 + 1], k1);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const size_t plane = static_cast<size_t>(n_bk) * Skv * HD;
  float* pk = part + (2 * split) * plane + kv_off;
  float* pv = pk + plane;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr0 + 8 * r;
    if (row >= Skv) continue;
#pragma unroll
    for (int d = 0; d < C::OD; ++d) {
      const size_t at = static_cast<size_t>(row) * HD + d * 8 + 2 * t;
      *reinterpret_cast<float2*>(pk + at) =
          make_float2(dk[d][2 * r], dk[d][2 * r + 1]);
      *reinterpret_cast<float2*>(pv + at) =
          make_float2(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

// dk, dv = the splits' partials summed in split order, rounded to bf16;
// n = B * Hkv * Skv * hd, a multiple of 4
__global__ void __launch_bounds__(256)
    dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int nsplit, size_t n) {
  const size_t n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       x < n4; x += static_cast<size_t>(gridDim.x) * blockDim.x) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float4 acc = p4[w * n4 + x];
      for (int s = 1; s < nsplit; ++s) {
        const float4 u = p4[(2 * s + w) * n4 + x];
        acc.x += u.x;
        acc.y += u.y;
        acc.z += u.z;
        acc.w += u.w;
      }
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>((w ? dv : dk) + 4 * x);
      dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
      dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
    }
  }
}

// --- launchers ----------------------------------------------------------------

struct Dims {
  int B, H, Hkv, Sq, Skv;
  float scale;
  int causal, window;
};

template <typename K>
int prepare(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int HD>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Dims& d, cudaStream_t st) {
  using C = Cfg<HD>;
  const size_t smem = (C::T * C::LD + C::T * C::LDP + 2 * C::T * C::LD) *
                      sizeof(float);
  if (int e = prepare(fwd_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + C::T - 1) / C::T);
  fwd_kernel<HD><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Dims& d, cudaStream_t st) {
  using C = Cfg<HD>;
  const size_t smem =
      (2 * C::T * C::LD + C::T * C::LDP + 2 * C::T + 2 * C::T * C::LD) *
      sizeof(float);
  if (int e = prepare(dq_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + C::T - 1) / C::T);
  dq_kernel<HD><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Dims& d, cudaStream_t st) {
  using C = Cfg<HD>;
  const size_t smem =
      (2 * C::T * C::LD + 2 * C::T * C::LDP + 2 * C::T + 2 * C::T * C::LD) *
      sizeof(float);
  if (int e = prepare(dkv_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.Hkv, (d.Skv + C::T - 1) / C::T);
  dkv_kernel<HD><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), d.H, d.Hkv, d.Sq,
      d.Skv, d.scale, d.causal, d.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Dims& d, cudaStream_t st) {
  const size_t smem = 5 * MmaCfg<HD>::TILE * sizeof(bf16);
  if (int e = prepare(fwd_mma_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + BQ - 1) / BQ);
  fwd_mma_kernel<HD><<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Dims& d, cudaStream_t st) {
  const size_t smem = 6 * MmaCfg<HD>::TILE * sizeof(bf16);
  if (int e = prepare(dq_mma_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + BQ - 1) / BQ);
  dq_mma_kernel<HD><<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, void* part, int nsplit, const Dims& d,
                   cudaStream_t st) {
  if (nsplit < 1 || (d.H / d.Hkv) % nsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      6 * MmaCfg<HD>::TILE * sizeof(bf16) + 4 * BQ * sizeof(float);
  if (int e = prepare(dkv_mma_kernel<HD>, smem)) return e;
  const dim3 grid(d.B * d.Hkv * nsplit, (d.Skv + BK - 1) / BK);
  dkv_mma_kernel<HD><<<grid, MT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(part), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window, nsplit);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  const size_t n = static_cast<size_t>(d.B) * d.Hkv * d.Skv * HD;
  const size_t blocks = (n / 4 + 255) / 256;
  dkv_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                   0, st>>>(static_cast<const float*>(part),
                            static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                            nsplit, n);
  return static_cast<int>(cudaGetLastError());
}

// head dims 16, 32, 64, 128 (both dtypes) and 256 (float32)
#define FLASH_DISPATCH(FN, ...)                        \
  do {                                                 \
    switch (hd) {                                      \
      case 16: return FN<16>(__VA_ARGS__);             \
      case 32: return FN<32>(__VA_ARGS__);             \
      case 64: return FN<64>(__VA_ARGS__);             \
      case 128: return FN<128>(__VA_ARGS__);           \
    }                                                  \
    return static_cast<int>(cudaErrorInvalidValue);    \
  } while (0)
#define FLASH_DISPATCH_F32(FN, ...)                    \
  do {                                                 \
    if (hd == 256) return FN<256>(__VA_ARGS__);        \
    FLASH_DISPATCH(FN, __VA_ARGS__);                   \
  } while (0)

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, head dims
// up to 128)
int flash_fwd(int dtype, int hd, const void* q, const void* k, const void* v,
              void* out, void* lse, int B, int H, int Hkv, int Sq, int Skv,
              float scale, int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) FLASH_DISPATCH_F32(launch_fwd_f32, q, k, v, out, lse, d, st);
  if (dtype == 1) FLASH_DISPATCH(launch_fwd_mma, q, k, v, out, lse, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_dq(int dtype, int hd, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             int B, int H, int Hkv, int Sq, int Skv, float scale, int causal,
             int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    FLASH_DISPATCH_F32(launch_dq_f32, q, k, v, dout, lse, delta, dq, d, st);
  if (dtype == 1)
    FLASH_DISPATCH(launch_dq_mma, q, k, v, dout, lse, delta, dq, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfloat16 also takes `part`, f32 scratch of nsplit * 2 * B*Hkv*Skv*hd
// (float32 ignores it and nsplit)
int flash_dkv(int dtype, int hd, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dk,
              void* dv, void* part, int nsplit, int B, int H, int Hkv, int Sq,
              int Skv, float scale, int causal, int window, void* stream) {
  if (B == 0 || Hkv == 0 || Skv == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    FLASH_DISPATCH_F32(launch_dkv_f32, q, k, v, dout, lse, delta, dk, dv, d,
                       st);
  if (dtype == 1)
    FLASH_DISPATCH(launch_dkv_mma, q, k, v, dout, lse, delta, dk, dv, part,
                   nsplit, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
