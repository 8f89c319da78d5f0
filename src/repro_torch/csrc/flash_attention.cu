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
// delta f32 [B, H, Sq]; all contiguous; head h reads kv head h / (H/Hkv),
// so no K/V is replicated. Masks are on indices: key kp is seen by query
// qp iff kp < Skv, (causal) kp <= qp, (window > 0) qp - kp < window; the
// backward also requires qp < Sq. Masked scores are -1e30, not -inf, as
// in the reference, and l is clamped at 1e-30 before the division and
// lse = m + log(l).
//
// What bounds them on an H100: at the training shape (q [2,24,4096,128],
// k/v [2,2,4096,128], causal) the forward does 2 products of 103 GFLOP,
// dq 3 and dk/dv 4, against ~110 MB of tensors: about 2,000 operations
// per byte, far above the ~295 where device memory stops being the
// limit, so all three are bound by arithmetic (989 TFLOP/s in bf16 on the
// tensor cores). This first version does its arithmetic in f32 on the
// CUDA cores (67 TFLOP/s peak), register-tiled: each of 256 threads owns
// a 4x4 piece of a 64x64 score tile and a 4-row strip of the output
// tile, tiles of K/V (and of Q/dout in the backward) sit in shared
// memory with padded rows so that neighbouring threads read distinct
// banks. Moving the products to wgmma is later work.
//
// TPU -> Hopper: the Pallas kernels carry (m, l, acc) across a sequential
// kv grid axis in VMEM scratch. Hopper blocks run in parallel and in no
// order, so each block here owns one output tile and loops over kv (or,
// for dk/dv, over q tiles x the heads of the GQA group) inside itself,
// skipping whole tiles the causal or window limit masks out. No atomics
// anywhere: every block writes only its own tile, which is what keeps a
// training step deterministic from run to run. The ragged tail is
// masked in the kernel (rows past Sq/Skv load as zeros), no padded copies.
// Blocks with the most live tiles are launched first (for causal masks
// the last q tiles in the forward and dq, the first kv tiles in dk/dv).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launch (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int TY = 16;
constexpr int TX = 16;
constexpr int NT = TY * TX;     // 256 threads
constexpr int RPT = BQ / TY;    // score rows per thread
constexpr int CPT = BK / TX;    // score columns per thread
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD>
struct Cfg {
  static constexpr int LDQ = HD + 1;                         // f32 rows
  static constexpr int LDT = HD + (sizeof(T) == 4 ? 1 : 2);  // T rows
  static constexpr int LDP = BK + 1;                         // f32 [BQ][BK]
  static constexpr int DPT = HD / TX;                        // out columns
};

__device__ __forceinline__ bool tile_live(int i, int j, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = live && (j * BK <= i * BQ + BQ - 1);
  if (window > 0) live = live && (i * BQ - (j * BK + BK - 1) < window);
  return live;
}

__device__ __forceinline__ bool seen(int qp, int kp, int skv, int causal,
                                     int window) {
  bool ok = kp < skv;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + ROWS) of a [nrows, HD] matrix -> shared memory with
// row stride LD, times `mul` in f32; rows past nrows load as zeros
template <typename TS, typename TG, int HD, int LD, int ROWS>
__device__ __forceinline__ void load_rows(TS* __restrict__ dst,
                                          const TG* __restrict__ src,
                                          int row0, int nrows, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NT) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int gr = row0 + r;
    const float x =
        gr < nrows ? to_f(src[static_cast<size_t>(gr) * HD + d]) * mul : 0.f;
    dst[r * LD + d] = from_f<TS>(x);
  }
}

__device__ __forceinline__ void load_stats(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int row0, int nrows) {
  for (int r = threadIdx.x; r < BQ; r += NT)
    dst[r] = row0 + r < nrows ? src[row0 + r] : 0.f;
}

// s[r][c] = sum_d A[ty*RPT + r][d] * B[tx + c*TX][d]
template <typename TA, typename TB, int HD, int LDA, int LDB>
__device__ __forceinline__ void scores(const TA* __restrict__ A,
                                       const TB* __restrict__ Bm, int ty,
                                       int tx, float (&s)[RPT][CPT]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[RPT], b[CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) a[r] = to_f(A[(ty * RPT + r) * LDA + d]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) b[c] = to_f(Bm[(tx + c * TX) * LDB + d]);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
  }
}

// --- forward ----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int H, int Hkv, int Sq, int Skv,
               float scale, int causal, int window) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + BQ * C::LDQ;
  T* Ks = reinterpret_cast<T*>(Ps + BQ * C::LDP);
  T* Vs = Ks + BK * C::LDT;

  const int n_q = (Sq + BQ - 1) / BQ;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;

  load_rows<float, T, HD, C::LDQ, BQ>(Qs, q + q_off, i * BQ, Sq, scale);

  float m[RPT], l[RPT], acc[RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) acc[r][e] = 0.f;
  }
  const int n_kv = (Skv + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    if (!tile_live(i, j, causal, window)) continue;
    __syncthreads();  // the previous tile's K, V, P are no longer read
    load_rows<T, T, HD, C::LDT, BK>(Ks, k + kv_off, j * BK, Skv, 1.f);
    load_rows<T, T, HD, C::LDT, BK>(Vs, v + kv_off, j * BK, Skv, 1.f);
    __syncthreads();
    float s[RPT][CPT];
    scores<float, T, HD, C::LDQ, C::LDT>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ty * RPT + r;
      const int qp = i * BQ + row;
      float mt = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (!seen(qp, j * BK + tx + c * TX, Skv, causal, window))
          s[r][c] = NEG_INF;
        mt = fmaxf(mt, s[r][c]);
      }
      const float mn = fmaxf(m[r], max16(mt));
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
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
    for (int c = 0; c < BK; ++c) {
      float vv[C::DPT];
#pragma unroll
      for (int e = 0; e < C::DPT; ++e)
        vv[e] = to_f(Vs[c * C::LDT + tx + e * TX]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float p = Ps[(ty * RPT + r) * C::LDP + c];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i * BQ + ty * RPT + r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* o = out + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) o[tx + e * TX] = from_f<T>(acc[r][e] / lc);
    if (tx == 0) lse[static_cast<size_t>(bh) * Sq + row] = m[r] + logf(lc);
  }
}

// --- dq ---------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int Hkv, int Sq, int Skv,
              float scale, int causal, int window) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ds = Qs + BQ * C::LDQ;
  float* Ls = Ds + BQ * C::LDP;
  float* Dl = Ls + BQ;
  T* Os = reinterpret_cast<T*>(Dl + BQ);
  T* Ks = Os + BQ * C::LDT;
  T* Vs = Ks + BK * C::LDT;

  const int n_q = (Sq + BQ - 1) / BQ;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t q_off = static_cast<size_t>(bh) * Sq * HD;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Skv * HD;

  load_rows<float, T, HD, C::LDQ, BQ>(Qs, q + q_off, i * BQ, Sq, scale);
  load_rows<T, T, HD, C::LDT, BQ>(Os, dout + q_off, i * BQ, Sq, 1.f);
  load_stats(Ls, lse + static_cast<size_t>(bh) * Sq, i * BQ, Sq);
  load_stats(Dl, delta + static_cast<size_t>(bh) * Sq, i * BQ, Sq);

  float acc[RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) acc[r][e] = 0.f;
  const int n_kv = (Skv + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    if (!tile_live(i, j, causal, window)) continue;
    __syncthreads();
    load_rows<T, T, HD, C::LDT, BK>(Ks, k + kv_off, j * BK, Skv, 1.f);
    load_rows<T, T, HD, C::LDT, BK>(Vs, v + kv_off, j * BK, Skv, 1.f);
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
    scores<float, T, HD, C::LDQ, C::LDT>(Qs, Ks, ty, tx, s);
    scores<T, T, HD, C::LDT, C::LDT>(Os, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ty * RPT + r;
      const int qp = i * BQ + row;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + c * TX;
        const bool ok = qp < Sq && seen(qp, j * BK + col, Skv, causal, window);
        const float p = expf((ok ? s[r][c] : NEG_INF) - Ls[row]);
        Ds[row * C::LDP + col] = p * (dp[r][c] - Dl[row]) * scale;
      }
    }
    __syncwarp();  // a dS row is written and read by the same half-warp
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kk[C::DPT];
#pragma unroll
      for (int e = 0; e < C::DPT; ++e)
        kk[e] = to_f(Ks[c * C::LDT + tx + e * TX]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float ds = Ds[(ty * RPT + r) * C::LDP + c];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) acc[r][e] = fmaf(ds, kk[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i * BQ + ty * RPT + r;
    if (row >= Sq) continue;
    T* o = dq + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) o[tx + e * TX] = from_f<T>(acc[r][e]);
  }
}

// --- dk / dv ----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
               float scale, int causal, int window) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + BQ * C::LDQ;
  float* Ds = Ps + BQ * C::LDP;
  float* Ls = Ds + BQ * C::LDP;
  float* Dl = Ls + BQ;
  T* Os = reinterpret_cast<T*>(Dl + BQ);
  T* Ks = Os + BQ * C::LDT;
  T* Vs = Ks + BK * C::LDT;

  const int j = blockIdx.y;
  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int hk = bk % Hkv, b = bk / Hkv;
  const int group = H / Hkv;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const size_t kv_off = static_cast<size_t>(bk) * Skv * HD;

  load_rows<T, T, HD, C::LDT, BK>(Ks, k + kv_off, j * BK, Skv, 1.f);
  load_rows<T, T, HD, C::LDT, BK>(Vs, v + kv_off, j * BK, Skv, 1.f);

  // rows ty*RPT + rr of this kv tile, columns tx + e*TX
  float dk_acc[RPT][C::DPT], dv_acc[RPT][C::DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  const int n_q = (Sq + BQ - 1) / BQ;
  for (int i = 0; i < n_q; ++i) {
    if (!tile_live(i, j, causal, window)) continue;
    for (int g = 0; g < group; ++g) {
      const size_t bh = static_cast<size_t>(b) * H + hk * group + g;
      const size_t q_off = bh * Sq * HD;
      __syncthreads();  // the previous (i, g) tiles are no longer read
      load_rows<float, T, HD, C::LDQ, BQ>(Qs, q + q_off, i * BQ, Sq, scale);
      load_rows<T, T, HD, C::LDT, BQ>(Os, dout + q_off, i * BQ, Sq, 1.f);
      load_stats(Ls, lse + bh * Sq, i * BQ, Sq);
      load_stats(Dl, delta + bh * Sq, i * BQ, Sq);
      __syncthreads();
      float s[RPT][CPT], dp[RPT][CPT];
      scores<float, T, HD, C::LDQ, C::LDT>(Qs, Ks, ty, tx, s);
      scores<T, T, HD, C::LDT, C::LDT>(Os, Vs, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = ty * RPT + r;
        const int qp = i * BQ + row;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tx + c * TX;
          const bool ok =
              qp < Sq && seen(qp, j * BK + col, Skv, causal, window);
          const float p = expf((ok ? s[r][c] : NEG_INF) - Ls[row]);
          Ps[row * C::LDP + col] = p;
          Ds[row * C::LDP + col] = p * (dp[r][c] - Dl[row]) * scale;
        }
      }
      __syncthreads();  // every thread reads every row of P and dS
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float o[C::DPT], qq[C::DPT];
#pragma unroll
        for (int e = 0; e < C::DPT; ++e) {
          o[e] = to_f(Os[r * C::LDT + tx + e * TX]);
          qq[e] = Qs[r * C::LDQ + tx + e * TX];
        }
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          const float pv = Ps[r * C::LDP + ty * RPT + rr];
          const float dsv = Ds[r * C::LDP + ty * RPT + rr];
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
  for (int rr = 0; rr < RPT; ++rr) {
    const int kr = j * BK + ty * RPT + rr;
    if (kr >= Skv) continue;
    T* gk = dk + kv_off + static_cast<size_t>(kr) * HD;
    T* gv = dv + kv_off + static_cast<size_t>(kr) * HD;
#pragma unroll
    for (int e = 0; e < C::DPT; ++e) {
      gk[tx + e * TX] = from_f<T>(dk_acc[rr][e] / scale);
      gv[tx + e * TX] = from_f<T>(dv_acc[rr][e]);
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

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const Dims& d, cudaStream_t st) {
  using C = Cfg<T, HD>;
  const size_t smem = (BQ * C::LDQ + BQ * C::LDP) * sizeof(float) +
                      2 * BK * C::LDT * sizeof(T);
  if (int e = prepare(fwd_kernel<T, HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + BQ - 1) / BQ);
  fwd_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Dims& d,
              cudaStream_t st) {
  using C = Cfg<T, HD>;
  const size_t smem = (BQ * C::LDQ + BQ * C::LDP + 2 * BQ) * sizeof(float) +
                      (BQ + 2 * BK) * C::LDT * sizeof(T);
  if (int e = prepare(dq_kernel<T, HD>, smem)) return e;
  const dim3 grid(d.B * d.H, (d.Sq + BQ - 1) / BQ);
  dq_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), d.H, d.Hkv, d.Sq, d.Skv, d.scale, d.causal,
      d.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Dims& d, cudaStream_t st) {
  using C = Cfg<T, HD>;
  const size_t smem =
      (BQ * C::LDQ + 2 * BQ * C::LDP + 2 * BQ) * sizeof(float) +
      (BQ + 2 * BK) * C::LDT * sizeof(T);
  if (int e = prepare(dkv_kernel<T, HD>, smem)) return e;
  const dim3 grid(d.B * d.Hkv, (d.Skv + BK - 1) / BK);
  dkv_kernel<T, HD><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), d.H, d.Hkv, d.Sq, d.Skv,
      d.scale, d.causal, d.window);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = float32, 1 = bfloat16; head dims 16, 32, 64, 128
#define FLASH_DISPATCH(FN, ...)                                      \
  do {                                                               \
    if (dtype == 0) {                                                \
      switch (hd) {                                                  \
        case 16: return FN<float, 16>(__VA_ARGS__);                  \
        case 32: return FN<float, 32>(__VA_ARGS__);                  \
        case 64: return FN<float, 64>(__VA_ARGS__);                  \
        case 128: return FN<float, 128>(__VA_ARGS__);                \
      }                                                              \
    } else if (dtype == 1) {                                         \
      switch (hd) {                                                  \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);          \
        case 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__);          \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);          \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);        \
      }                                                              \
    }                                                                \
    return static_cast<int>(cudaErrorInvalidValue);                  \
  } while (0)

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_fwd(int dtype, int hd, const void* q, const void* k, const void* v,
              void* out, void* lse, int B, int H, int Hkv, int Sq, int Skv,
              float scale, int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, d, st);
}

int flash_dq(int dtype, int hd, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta, void* dq,
             int B, int H, int Hkv, int Sq, int Skv, float scale, int causal,
             int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, d, st);
}

int flash_dkv(int dtype, int hd, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dk,
              void* dv, int B, int H, int Hkv, int Sq, int Skv, float scale,
              int causal, int window, void* stream) {
  if (B == 0 || Hkv == 0 || Skv == 0) return 0;
  const Dims d{B, H, Hkv, Sq, Skv, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, d, st);
}

}  // extern "C"
