// The Mamba-2 SSD chunked scan for Hopper (sm_90a): the forward, and its
// gradient as one backward kernel.
//
// Replaces:
//   ssd_fwd <- repro/kernels/ssd_scan/kernel.py ssd_scan_fwd (body
//              _ssd_kernel), the same function as the model's pure-jnp
//              repro/models/ssm.py ssd_chunked
//   ssd_bwd <- no Pallas kernel: the JAX package differentiates the jnp
//              ssd_chunked with jax.grad; this is that gradient
// The plain PyTorch versions are in repro_torch/kernels/ssd_scan/ref.py
// (ssd_fwd_plain; ssd_grads_plain, autograd through it, for the backward).
//
// Layouts, all contiguous: x [B, S, H, P] and Bm, Cm [B, S, N] in T
// (float or bfloat16); dt [B, S, H], A [H], states [B, H, nc, P, N] and
// the chunk states init / final [B, H, P, N] in f32; y [B, S, H, P] f32.
// A chunk is Q consecutive tokens (S = nc * Q). Per chunk, with cum the
// in-chunk cumsum of dt * A and xdt = x * dt:
//   y_t   = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) xdt_j
//           + exp(cum_t) S0 C_t
//   S_end = exp(cum_Q) S0 + sum_j exp(cum_Q - cum_j) xdt_j B_j^T
// with S0 the state at the chunk's start — the math of ssd_chunked,
// blocked as it is (the state passes only at chunk boundaries), in f32.
//
// What bounds them on an H100: at the training shape (x [8,4096,48,64],
// B/C [8,4096,128] bf16, chunk 256) the forward does ~129 GFLOP counted
// as the reference computes it (C.B^T for every head) over the causal
// pairs only, against ~0.84 GB of tensors (the saved chunk-start states
// included) — ~150 operations per byte, below the H100's balance point
// for bf16, so the bytes bound it; the backward likewise. This first
// version does its products in f32 on the CUDA cores (67 TFLOP/s): one
// block of 256 threads per (batch, head) walks the chunks in order and
// carries the [P, N] state in shared memory (the Pallas grid's
// sequential chunk axis becomes the loop; batch x heads = 384 blocks).
// A 256-token chunk's Q x Q decay tile (256 KB in f32) does not fit in
// the 227 KB of shared memory, so a chunk is cut into 64-row tiles: each
// 64 x 64 tile pair of the causal lower triangle is computed in turn
// (scores over N, the decay, then the product with xdt), which is the
// chunk-Q math summed in another order. Each thread owns a 4 x 4 piece of
// a 64 x 64 tile with rows ty + 16a and columns tx + 16b, so that in
// every product neighbouring threads read neighbouring banks; [., N]
// tiles are padded to N + 1 floats a row. Tensor cores (wgmma on bf16
// tiles) and fusing C.B^T across the heads are later work.
//
// Numerics: the in-chunk cumsum is accumulated in double and rounded to
// f32 once per token; exp is taken only on and below the diagonal (above
// it exp(cum_i - cum_j) overflows to inf and inf * 0 would be NaN).
//
// The backward walks the chunks in reverse per (batch, head), carries
// the state's gradient [P, N] in shared memory and recomputes each
// chunk's intra terms from the chunk-start states the forward saved. It
// uses no atomics: every sum has one owner and a fixed order. dB and dC
// sum over the heads and dA over batch and sequence, so the kernel writes
// per-head partials (dB_part, dC_part [B, H, S, N], dA_part [B, H]) that
// the wrapper sums in a fixed order — a training step is the same bits
// on every run.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launch (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;            // rows of a sub-tile of a chunk
constexpr int NT = 256;           // threads: 16 x 16
constexpr int MAXP = 64;          // head dim the kernels take
constexpr int MAXN = 128;         // state dim
constexpr int MAXQ = 1024;        // chunk length
constexpr int LDN = MAXN + 1;     // f32 row of a [., N] tile
constexpr int LDP = MAXP + 1;     // f32 row of a [., P] tile
constexpr int LDT = TQ + 1;       // f32 row of a [TQ, TQ] tile

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

struct Dims {
  int B, S, H, P, N, Q;
};

// rows [r0, r0 + TQ) of a [B, S, ...] tensor (row stride `stride`, `w`
// values per row starting at `base`) into the first `width` columns of a
// [TQ][ld] f32 tile; rows past `rows` and columns past `w` load as 0, so
// every column a product reads (up to MAXP / MAXN) is defined
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long stride, int r0, int rows,
                                          int w, int width) {
  for (int i = threadIdx.x; i < TQ * width; i += NT) {
    const int r = i / width, c = i % width;
    float v = 0.f;
    if (r0 + r < rows && c < w) v = to_f(base[(long)(r0 + r) * stride + c]);
    dst[r * ld + c] = v;
  }
}

// the chunk's dt into sdt[0, Q) and cum = cumsum(dt * A) into scum[0, Q),
// accumulated in double by one thread
__device__ __forceinline__ void chunk_cum(float* sdt, float* scum,
                                          const float* dt, float A,
                                          const Dims& d, int b, int h,
                                          int t0) {
  for (int i = threadIdx.x; i < d.Q; i += NT)
    sdt[i] = dt[((long)b * d.S + t0 + i) * d.H + h];
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = 0.0;
    for (int i = 0; i < d.Q; ++i) {
      acc += (double)(sdt[i] * A);
      scum[i] = (float)acc;
    }
  }
  __syncthreads();
}

// sum of v over the 16 threads of a half warp (same ty), in a fixed order
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Av, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               float* __restrict__ y, float* __restrict__ final_state,
               float* __restrict__ states, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                      // [MAXP][LDN] the carried state
  float* sC = sS + MAXP * LDN;           // [TQ][LDN]
  float* sB = sC + TQ * LDN;             // [TQ][LDN]
  float* sX = sB + TQ * LDN;             // [TQ][LDP] x * dt (* decay)
  float* sPt = sX + TQ * LDP;            // [TQ][LDT] scores * decay
  float* sdt = sPt + TQ * LDT;           // [Q]
  float* scum = sdt + d.Q;               // [Q]

  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int P = d.P, N = d.N, Q = d.Q;
  const float A = Av[h];
  const long PN = (long)P * N;
  const long bh = (long)b * d.H + h;
  const int nc = d.S / Q, nt = (Q + TQ - 1) / TQ;
  const long xs = (long)d.H * P;          // row stride of x and y

  for (int i = threadIdx.x; i < MAXP * LDN; i += NT) {
    const int p = i / LDN, n = i % LDN;
    sS[i] = (init != nullptr && p < P && n < N) ? init[bh * PN + p * N + n]
                                               : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    chunk_cum(sdt, scum, dt, A, d, b, h, t0);   // syncs: sS is written
    if (states != nullptr) {
      float* dst = states + (bh * nc + c) * PN;
      for (int i = threadIdx.x; i < P * N; i += NT)
        dst[i] = sS[(i / N) * LDN + i % N];
    }
    const T* xb = x + ((long)b * d.S + t0) * xs + (long)h * P;
    const T* Bb = Bm + ((long)b * d.S + t0) * N;
    const T* Cb = Cm + ((long)b * d.S + t0) * N;

    for (int it = 0; it < nt; ++it) {
      const int r0 = it * TQ;
      load_tile(sC, LDN, Cb, N, r0, Q, N, MAXN);
      __syncthreads();
      float acc[4][4];
      // inter-chunk: exp(cum_t) * sum_n C_t[n] S0[p][n]
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cr[4], sp[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cr[a] = sC[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) sp[q] = sS[(tx + 16 * q) * LDN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] += cr[a] * sp[q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = r0 + ty + 16 * a;
        const float e = t < Q ? expf(scum[t]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] *= e;
      }
      // intra-chunk: the causal tiles jt <= it
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        load_tile(sB, LDN, Bb, N, j0, Q, N, MAXN);
        for (int i = threadIdx.x; i < TQ * MAXP; i += NT) {
          const int r = i / MAXP, p = i % MAXP;
          const int t = j0 + r;
          sX[r * LDP + p] =
              (t < Q && p < P) ? to_f(xb[(long)t * xs + p]) * sdt[t] : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cr[a] = sC[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) br[q] = sB[(tx + 16 * q) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[a][q] += cr[a] * br[q];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ti = r0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tj = j0 + tx + 16 * q;
            const float e =
                (tj <= ti && ti < Q) ? expf(scum[ti] - scum[tj]) : 0.f;
            sPt[(ty + 16 * a) * LDT + tx + 16 * q] = s[a][q] * e;
          }
        }
        __syncthreads();
        for (int k = 0; k < TQ; ++k) {
          float pr[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pr[a] = sPt[(ty + 16 * a) * LDT + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = sX[k * LDP + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] += pr[a] * xv[q];
        }
        __syncthreads();
      }
      float* yb = y + ((long)b * d.S + t0) * xs + (long)h * P;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = r0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (t < Q && p < P) yb[(long)t * xs + p] = acc[a][q];
        }
      }
    }

    // state update: S = exp(cum_Q) S + sum_t exp(cum_Q - cum_t) xdt_t B_t^T
    // thread owns p = ty + 16a, n = tx + 16q
    const float clast = scum[Q - 1];
    float st[4][8];
    const float g = expf(clast);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        st[a][q] = sS[(ty + 16 * a) * LDN + tx + 16 * q] * g;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TQ;
      load_tile(sB, LDN, Bb, N, j0, Q, N, MAXN);
      for (int i = threadIdx.x; i < TQ * MAXP; i += NT) {
        const int r = i / MAXP, p = i % MAXP;
        const int t = j0 + r;
        sX[r * LDP + p] = (t < Q && p < P) ? to_f(xb[(long)t * xs + p]) *
                                                 sdt[t] * expf(clast - scum[t])
                                           : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < TQ; ++k) {
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = sX[k * LDP + ty + 16 * a];
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = sB[k * LDN + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) st[a][q] += xv[a] * bv[q];
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = ty + 16 * a, n = tx + 16 * q;
        sS[p * LDN + n] = (p < P && n < N) ? st[a][q] : 0.f;
      }
    // the next chunk's chunk_cum syncs before sS is read
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * N; i += NT)
    final_state[bh * PN + i] = sS[(i / N) * LDN + i % N];
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Av, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ states,
               const float* __restrict__ dy, const float* __restrict__ dfinal,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* sS0 = smem;                     // [MAXP][LDN] chunk-start state
  float* sdS = sS0 + MAXP * LDN;         // [MAXP][LDN] d(chunk-end state)
  float* sC = sdS + MAXP * LDN;          // [TQ][LDN]
  float* sB = sC + TQ * LDN;             // [TQ][LDN]
  float* sX = sB + TQ * LDN;             // [TQ][LDP] x
  float* sDy = sX + TQ * LDP;            // [TQ][LDP] dy
  float* sMw = sDy + TQ * LDP;           // [TQ][LDT] (dy . xdt) * decay
  float* sMs = sMw + TQ * LDT;           // [TQ][LDT] (C . B) * decay
  float* scol = sMs + TQ * LDT;          // [16][TQ] column partials
  float* sred = scol + 16 * TQ;          // [NT] block reduction
  float* sdt = sred + NT;                // [Q]
  float* scum = sdt + d.Q;               // [Q]
  float* sdr = scum + d.Q;               // [Q] d cum: row terms
  float* sdc = sdr + d.Q;                // [Q] d cum: column terms
  float* sgx = sdc + d.Q;                // [Q] sum_p dxdt * x
  float* sU = sgx + d.Q;                 // [Q] the state term of d cum

  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int P = d.P, N = d.N, Q = d.Q;
  const float A = Av[h];
  const long PN = (long)P * N;
  const long bh = (long)b * d.H + h;
  const int nc = d.S / Q, nt = (Q + TQ - 1) / TQ;
  const long xs = (long)d.H * P;
  float dA_acc = 0.f;                    // thread 0's, in chunk order

  for (int i = threadIdx.x; i < MAXP * LDN; i += NT) {
    const int p = i / LDN, n = i % LDN;
    sdS[i] = (dfinal != nullptr && p < P && n < N)
                 ? dfinal[bh * PN + p * N + n] : 0.f;
  }

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q;
    for (int i = threadIdx.x; i < Q; i += NT) {
      sdr[i] = 0.f;
      sdc[i] = 0.f;
    }
    {
      const float* src = states + (bh * nc + c) * PN;
      for (int i = threadIdx.x; i < MAXP * LDN; i += NT) {
        const int p = i / LDN, n = i % LDN;
        sS0[i] = (p < P && n < N) ? src[p * N + n] : 0.f;
      }
    }
    chunk_cum(sdt, scum, dt, A, d, b, h, t0);
    const float clast = scum[Q - 1];
    const T* xb = x + ((long)b * d.S + t0) * xs + (long)h * P;
    const float* dyb = dy + ((long)b * d.S + t0) * xs + (long)h * P;
    const T* Bb = Bm + ((long)b * d.S + t0) * N;
    const T* Cb = Cm + ((long)b * d.S + t0) * N;

    // ---- pass B: for each column tile j, sum over the row tiles i >= j:
    // dB_j, dxdt_j and the column terms of d cum; then the state terms
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * TQ;
      load_tile(sB, LDN, Bb, N, j0, Q, N, MAXN);
      load_tile(sX, LDP, xb, xs, j0, Q, P, MAXP);
      float dBa[4][8], dXa[4][4];   // rows ty + 16a; n / p = tx + 16q
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int q = 0; q < 8; ++q) dBa[a][q] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) dXa[a][q] = 0.f;
      }
      for (int it = jt; it < nt; ++it) {
        const int r0 = it * TQ;
        load_tile(sC, LDN, Cb, N, r0, Q, N, MAXN);
        load_tile(sDy, LDP, dyb, xs, r0, Q, P, MAXP);
        __syncthreads();
        // the tile: rows t = r0 + ty + 16a, columns j = j0 + tx + 16q
        float s[4][4], w[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = w[a][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cr[4], br[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cr[a] = sC[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) br[q] = sB[(tx + 16 * q) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[a][q] += cr[a] * br[q];
        }
        for (int p = 0; p < P; ++p) {
          float dr[4], xr[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) dr[a] = sDy[(ty + 16 * a) * LDP + p];
#pragma unroll
          for (int q = 0; q < 4; ++q) xr[q] = sX[(tx + 16 * q) * LDP + p];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) w[a][q] += dr[a] * xr[q];
        }
        float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ti = r0 + ty + 16 * a;
          float rowp = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tj = j0 + tx + 16 * q;
            const bool live = tj <= ti && ti < Q;
            const float e = live ? expf(scum[ti] - scum[tj]) : 0.f;
            const float mw = live ? w[a][q] * sdt[tj] * e : 0.f;
            const float ms = s[a][q] * e;
            sMw[(ty + 16 * a) * LDT + tx + 16 * q] = mw;
            sMs[(ty + 16 * a) * LDT + tx + 16 * q] = ms;
            const float m = mw * s[a][q];
            rowp += m;
            colp[q] += m;
          }
          rowp = half_warp_sum(rowp);
          if (tx == 0 && ti < Q) sdr[ti] += rowp;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) scol[ty * TQ + tx + 16 * q] = colp[q];
        __syncthreads();
        if (threadIdx.x < TQ) {
          const int tj = j0 + threadIdx.x;
          float v = 0.f;
          for (int k = 0; k < 16; ++k) v += scol[k * TQ + threadIdx.x];
          if (tj < Q) sdc[tj] += v;
        }
        for (int k = 0; k < TQ; ++k) {
          float mw[4], ms[4], cv[8], dv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            mw[a] = sMw[k * LDT + ty + 16 * a];
            ms[a] = sMs[k * LDT + ty + 16 * a];
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) cv[q] = sC[k * LDN + tx + 16 * q];
#pragma unroll
          for (int q = 0; q < 4; ++q) dv[q] = sDy[k * LDP + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int q = 0; q < 8; ++q) dBa[a][q] += mw[a] * cv[q];
#pragma unroll
            for (int q = 0; q < 4; ++q) dXa[a][q] += ms[a] * dv[q];
          }
        }
        __syncthreads();
      }
      // state terms of tile j (dS is the gradient of the chunk-end state):
      // dB_j += g_end xdt_j dS, dxdt_j += g_end dS B_j, U_j = xdt_j . that
      float* dBp = dB_part + (bh * d.S + t0) * N;
      T* dxb = dx + ((long)b * d.S + t0) * xs + (long)h * P;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a, tj = j0 + r;
        const bool ok = tj < Q;
        const float dtj = ok ? sdt[tj] : 0.f;
        const float ge = ok ? expf(clast - scum[tj]) * dtj : 0.f;
        float sb[8], sx[4];
#pragma unroll
        for (int q = 0; q < 8; ++q) sb[q] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) sx[q] = 0.f;
        for (int p = 0; p < P; ++p) {
          const float xv = sX[r * LDP + p];
#pragma unroll
          for (int q = 0; q < 8; ++q) sb[q] += xv * sdS[p * LDN + tx + 16 * q];
        }
        const float gs = ok ? expf(clast - scum[tj]) : 0.f;
        for (int n = 0; n < N; ++n) {
          const float bv = sB[r * LDN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) sx[q] += sdS[(tx + 16 * q) * LDN + n] * bv;
        }
        float u = 0.f, gx = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          const float xs_state = gs * sx[q];
          const float xv = p < P ? sX[r * LDP + p] : 0.f;
          u += xv * dtj * xs_state;
          const float dxdt = dXa[a][q] + xs_state;
          gx += dxdt * xv;
          if (ok && p < P) dxb[(long)tj * xs + p] = from_f<T>(dxdt * dtj);
        }
        u = half_warp_sum(u);
        gx = half_warp_sum(gx);
        if (tx == 0 && ok) {
          sU[tj] = u;
          sgx[tj] = gx;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (ok && n < N) dBp[(long)tj * N + n] = dBa[a][q] + ge * sb[q];
        }
      }
      __syncthreads();
    }

    // ---- pass A: for each row tile i: dC_i over the column tiles j <= i
    // plus the inter-chunk term; the inter term of d cum; dS0
    float dS0[4][8];   // p = ty + 16a, n = tx + 16q
    float sdot = 0.f;  // <S0, dS>, this thread's entries
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int idx = (ty + 16 * a) * LDN + tx + 16 * q;
        dS0[a][q] = 0.f;
        sdot += sS0[idx] * sdS[idx];
      }
    for (int it = 0; it < nt; ++it) {
      const int r0 = it * TQ;
      load_tile(sC, LDN, Cb, N, r0, Q, N, MAXN);
      load_tile(sDy, LDP, dyb, xs, r0, Q, P, MAXP);
      __syncthreads();
      float dCa[4][8];   // rows t = ty + 16a, n = tx + 16q
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) dCa[a][q] = 0.f;
      for (int p = 0; p < P; ++p) {
        float dr[4], sv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dr[a] = sDy[(ty + 16 * a) * LDP + p];
#pragma unroll
        for (int q = 0; q < 8; ++q) sv[q] = sS0[p * LDN + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) dCa[a][q] += dr[a] * sv[q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ti = r0 + ty + 16 * a;
        const float gin = ti < Q ? expf(scum[ti]) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          dCa[a][q] *= gin;
          v += sC[(ty + 16 * a) * LDN + tx + 16 * q] * dCa[a][q];
        }
        v = half_warp_sum(v);
        if (tx == 0 && ti < Q) sdr[ti] += v;
      }
      // dS0 += sum_t exp(cum_t) dy_t[p] C_t[n]
      for (int k = 0; k < TQ; ++k) {
        const int t = r0 + k;
        const float gin = t < Q ? expf(scum[t]) : 0.f;
        float dv[4], cv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = sDy[k * LDP + ty + 16 * a] * gin;
#pragma unroll
        for (int q = 0; q < 8; ++q) cv[q] = sC[k * LDN + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 8; ++q) dS0[a][q] += dv[a] * cv[q];
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TQ;
        load_tile(sB, LDN, Bb, N, j0, Q, N, MAXN);
        load_tile(sX, LDP, xb, xs, j0, Q, P, MAXP);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[a][q] = 0.f;
        for (int p = 0; p < P; ++p) {
          float dr[4], xr[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) dr[a] = sDy[(ty + 16 * a) * LDP + p];
#pragma unroll
          for (int q = 0; q < 4; ++q) xr[q] = sX[(tx + 16 * q) * LDP + p];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) w[a][q] += dr[a] * xr[q];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ti = r0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tj = j0 + tx + 16 * q;
            const bool live = tj <= ti && ti < Q;
            sMw[(ty + 16 * a) * LDT + tx + 16 * q] =
                live ? w[a][q] * sdt[tj] * expf(scum[ti] - scum[tj]) : 0.f;
          }
        }
        __syncthreads();
        for (int k = 0; k < TQ; ++k) {
          float mw[4], bv[8];
#pragma unroll
          for (int a = 0; a < 4; ++a) mw[a] = sMw[(ty + 16 * a) * LDT + k];
#pragma unroll
          for (int q = 0; q < 8; ++q) bv[q] = sB[k * LDN + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 8; ++q) dCa[a][q] += mw[a] * bv[q];
        }
        __syncthreads();
      }
      float* dCp = dC_part + (bh * d.S + t0) * N;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = r0 + ty + 16 * a;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = tx + 16 * q;
          if (t < Q && n < N) dCp[(long)t * N + n] = dCa[a][q];
        }
      }
    }

    // <S0, dS> over the block, in a fixed tree
    sred[threadIdx.x] = sdot;
    __syncthreads();
    for (int o = NT / 2; o > 0; o >>= 1) {
      if (threadIdx.x < o) sred[threadIdx.x] += sred[threadIdx.x + o];
      __syncthreads();
    }
    // the gradient of the chunk-start state, for the previous chunk
    const float glast = expf(clast);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = ty + 16 * a, n = tx + 16 * q;
        const int idx = p * LDN + n;
        sdS[idx] = (p < P && n < N) ? glast * sdS[idx] + dS0[a][q] : 0.f;
      }
    // d cum -> d dA (reverse cumsum) -> ddt, dA; one thread, in order
    if (threadIdx.x == 0) {
      float usum = 0.f;
      for (int t = 0; t < Q; ++t) usum += sU[t];
      float run = 0.f;
      for (int t = Q - 1; t >= 0; --t) {
        float dc = sdr[t] - sdc[t] - sU[t];
        if (t == Q - 1) dc += usum + glast * sred[0];
        run += dc;
        ddt[((long)b * d.S + t0 + t) * d.H + h] = run * A + sgx[t];
        dA_acc += run * sdt[t];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) dA_part[bh] = dA_acc;
}

size_t fwd_smem(int Q) {
  return sizeof(float) *
         ((size_t)MAXP * LDN + 2 * TQ * LDN + TQ * LDP + TQ * LDT + 2 * Q);
}

size_t bwd_smem(int Q) {
  return sizeof(float) * ((size_t)2 * MAXP * LDN + 2 * TQ * LDN +
                          2 * TQ * LDP + 2 * TQ * LDT + 16 * TQ + NT + 6 * Q);
}

template <typename K>
int prepare(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool dims_ok(const Dims& d) {
  return d.P >= 1 && d.P <= MAXP && d.N >= 1 && d.N <= MAXN && d.Q >= 1 &&
         d.Q <= MAXQ && d.S % d.Q == 0;
}

template <typename T>
int launch_fwd(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* init, float* y, float* fin,
               float* states, const Dims& d, cudaStream_t st) {
  const size_t smem = fwd_smem(d.Q);
  if (int e = prepare(ssd_fwd_kernel<T>, smem)) return e;
  ssd_fwd_kernel<T><<<d.B * d.H, NT, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, y, fin, states, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* states, const float* dy,
               const float* dfinal, void* dx, float* ddt, float* dA_part,
               float* dB_part, float* dC_part, const Dims& d,
               cudaStream_t st) {
  const size_t smem = bwd_smem(d.Q);
  if (int e = prepare(ssd_bwd_kernel<T>, smem)) return e;
  ssd_bwd_kernel<T><<<d.B * d.H, NT, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), states, dy, dfinal, static_cast<T*>(dx),
      ddt, dA_part, dB_part, dC_part, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm); init and states may be null
int ssd_fwd(int dtype, const void* x, const void* dt, const void* A,
            const void* Bm, const void* Cm, const void* init, void* y,
            void* final_state, void* states, int B, int S, int H, int P,
            int N, int Q, void* stream) {
  const Dims d{B, S, H, P, N, Q};
  if (B == 0 || H == 0 || S == 0) return 0;
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_init = static_cast<const float*>(init);
  float* f_y = static_cast<float*>(y);
  float* f_fin = static_cast<float*>(final_state);
  float* f_st = static_cast<float*>(states);
  if (dtype == 0)
    return launch_fwd<float>(x, f_dt, f_A, Bm, Cm, f_init, f_y, f_fin, f_st,
                             d, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, f_dt, f_A, Bm, Cm, f_init, f_y,
                                     f_fin, f_st, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dfinal may be null (a zero gradient of the final state)
int ssd_bwd(int dtype, const void* x, const void* dt, const void* A,
            const void* Bm, const void* Cm, const void* states,
            const void* dy, const void* dfinal, void* dx, void* ddt,
            void* dA_part, void* dB_part, void* dC_part, int B, int S, int H,
            int P, int N, int Q, void* stream) {
  const Dims d{B, S, H, P, N, Q};
  if (B == 0 || H == 0 || S == 0) return 0;
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_st = static_cast<const float*>(states);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_df = static_cast<const float*>(dfinal);
  float* f_ddt = static_cast<float*>(ddt);
  float* f_dA = static_cast<float*>(dA_part);
  float* f_dB = static_cast<float*>(dB_part);
  float* f_dC = static_cast<float*>(dC_part);
  if (dtype == 0)
    return launch_bwd<float>(x, f_dt, f_A, Bm, Cm, f_st, f_dy, f_df, dx,
                             f_ddt, f_dA, f_dB, f_dC, d, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, f_dt, f_A, Bm, Cm, f_st, f_dy, f_df,
                                     dx, f_ddt, f_dA, f_dB, f_dC, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
