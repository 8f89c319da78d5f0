// The RG-LRU gated linear recurrence for Hopper (sm_90a): the forward and
// its backward.
//
// rg_lru_fwd replaces: repro/kernels/rg_lru/kernel.py rg_lru_fwd (body
// _rglru_kernel), the same function as the model's associative scan
// repro/models/hybrid.py rg_lru. The plain PyTorch versions are
// repro_torch/kernels/rg_lru/ref.py rg_lru_plain, and rg_lru_phased_plain,
// this kernel's three phases in plain tensors.
//
// rg_lru_bwd replaces no TPU kernel: the JAX package takes the gradient of
// its associative scan with jax.grad (repro/models/hybrid.py rg_lru), and
// the port needs a kernel for it to train the hybrid family on the card.
// Its plain version is ref.py rg_lru_bwd_plain. See the note above it.
//
// Layouts, all contiguous f32: x, r, i, h [B, S, W]; lam [W]; h0 [B, W]
// (null: a zero state). Per channel w, with sp = softplus(lam[w]):
//   log_a_t = -8 sp r_t,  a_t = exp(log_a_t),
//   gate_t  = sqrt(-expm1(2 log_a_t))          (= sqrt(1 - a_t^2))
//   h_t     = a_t h_{t-1} + gate_t (i_t x_t),  h_{-1} = h0
// softplus in the stable form jax.nn.softplus takes,
// max(lam, 0) + log1p(exp(-|lam|)); the gate through expm1f, since
// 1 - a^2 loses every digit as a approaches 1.
//
// What bounds it on an H100: each element reads x, r, i and writes h (16
// B) for ~10 operations, so the bytes bound it: at the prefill shape
// (B = 2, S = 32,768, W = 4,096) 4.29 GB, 1.28 ms at 3.35 TB/s. The
// recurrence is elementwise over channels and sequential in time, and
// one thread per (batch, channel) walking the whole sequence gives
// B x W = 8,192 threads, 32 of 132 SMs. So time is cut into chunks of
// TCHUNK tokens and the scan takes three phases, each over (batch,
// chunk, channel) or (batch, channel):
//   local (every chunk c but the last, from a zero state): its decay
//          product A_c = expf(sum of its log_a, summed in double in token
//          order) — a sum, not a running product — and its end value;
//   carry (per (batch, channel), the chunks in order): the carry into
//          chunk c + 1, h_c = A_c h_{c-1} + end_c, from h0 or zero;
//   out   (every chunk from its carry-in): the recurrence again, writing
//          h — inside a chunk the one-thread scan's own rounding.
// At the prefill shape that is 128 chunks, a million threads. x, r and i
// are read twice, so this design moves 28 bytes an element, not 16:
// 7.52 GB, 2.24 ms at 3.35 TB/s; a single pass with a chained carry
// (decoupled look-back) would reach the 16-byte bound. Neighbouring
// threads read neighbouring channels (coalesced), and each thread issues
// the loads of the next UNROLL steps before the dependent chain of FMAs
// that consumes them. No atomics and a fixed order: the result is the
// same bits on every run.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launches (0 = cudaSuccess).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // channels per block
constexpr int UNROLL = 8;        // time steps loaded ahead of their use
constexpr int TCHUNK = 256;      // tokens per chunk (ref.TIME_CHUNK)
constexpr int CARRY_BATCH = 16;  // chunks the carry pass loads at once
constexpr float GATE_C = 8.0f;

__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float step(float h, float xv, float rv, float iv,
                                      float neg_c_sp) {
  const float log_a = neg_c_sp * rv;
  const float a = expf(log_a);
  const float gate = sqrtf(-expm1f(2.0f * log_a));
  return a * h + gate * (iv * xv);
}

// h after tokens [t0, t1) of one (batch, channel) from h (element t at
// base + t W). WRITE stores every h_t; otherwise the tokens' log_a are
// summed in double, in token order, into *lsum.
template <bool WRITE>
__device__ __forceinline__ float run(const float* __restrict__ x,
                                     const float* __restrict__ r,
                                     const float* __restrict__ gi,
                                     float* __restrict__ h_out,
                                     long long base, int t0, int t1, int W,
                                     float neg_c_sp, float h, double* lsum) {
  double ls = 0.0;
  int t = t0;
  for (; t + UNROLL <= t1; t += UNROLL) {
    float xv[UNROLL], rv[UNROLL], iv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long o = base + (long long)(t + u) * W;
      xv[u] = __ldg(x + o);
      rv[u] = __ldg(r + o);
      iv[u] = __ldg(gi + o);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!WRITE) ls += (double)(neg_c_sp * rv[u]);
      h = step(h, xv[u], rv[u], iv[u], neg_c_sp);
      if (WRITE) h_out[base + (long long)(t + u) * W] = h;
    }
  }
  for (; t < t1; ++t) {                       // the ragged tail
    const long long o = base + (long long)t * W;
    const float rv = __ldg(r + o);
    if (!WRITE) ls += (double)(neg_c_sp * rv);
    h = step(h, __ldg(x + o), rv, __ldg(gi + o), neg_c_sp);
    if (WRITE) h_out[o] = h;
  }
  if (!WRITE) *lsum = ls;
  return h;
}

// --- local: chunk c < nc - 1 from a zero state -----------------------------
//
// dec, loc [B, nc - 1, W]: the chunk's decay product and end value
__global__ void __launch_bounds__(THREADS)
rg_lru_local_kernel(const float* __restrict__ x, const float* __restrict__ r,
                    const float* __restrict__ gi,
                    const float* __restrict__ lam, float* __restrict__ dec,
                    float* __restrict__ loc, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, nl = gridDim.y;
  const long long b = blockIdx.z;
  const float neg_c_sp = -GATE_C * softplus(lam[w]);
  double ls;
  const float h = run<false>(x, r, gi, nullptr, b * (long long)S * W + w,
                             c * TCHUNK, (c + 1) * TCHUNK, W, neg_c_sp, 0.0f,
                             &ls);
  const long long o = (b * nl + c) * W + w;
  dec[o] = expf((float)ls);
  loc[o] = h;
}

// --- carry: h_c = A_c h_{c-1} + end_c, in place over loc -------------------
//
// afterwards loc[b, c] holds the state entering chunk c + 1
__global__ void __launch_bounds__(THREADS)
rg_lru_carry_kernel(const float* __restrict__ h0,
                    const float* __restrict__ dec, float* __restrict__ loc,
                    int W, int nl) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  float h = h0 != nullptr ? h0[b * W + w] : 0.0f;
  for (int c0 = 0; c0 < nl; c0 += CARRY_BATCH) {
    float dv[CARRY_BATCH], lv[CARRY_BATCH];
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      const long long o = (b * nl + c0 + k) * W + w;
      dv[k] = c0 + k < nl ? dec[o] : 0.0f;
      lv[k] = c0 + k < nl ? loc[o] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      if (c0 + k >= nl) break;
      h = __fmaf_rn(dv[k], h, lv[k]);
      loc[(b * nl + c0 + k) * W + w] = h;
    }
  }
}

// --- out: every chunk from its carry-in, writing h -------------------------
__global__ void __launch_bounds__(THREADS)
rg_lru_out_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  const float* __restrict__ gi, const float* __restrict__ lam,
                  const float* __restrict__ h0,
                  const float* __restrict__ carry, float* __restrict__ h_out,
                  int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, nl = gridDim.y - 1;
  const long long b = blockIdx.z;
  const float neg_c_sp = -GATE_C * softplus(lam[w]);
  float h;
  if (c > 0)
    h = carry[(b * nl + c - 1) * W + w];
  else
    h = h0 != nullptr ? h0[b * W + w] : 0.0f;
  run<true>(x, r, gi, h_out, b * (long long)S * W + w, c * TCHUNK,
            min(S, (c + 1) * TCHUNK), W, neg_c_sp, h, nullptr);
}

// =========================================================================
// backward
// =========================================================================
//
// With g_t the whole gradient reaching h_t, the reverse scan
//   g_t = dy_t + a_{t+1} g_{t+1},      g_{S-1} = dy_{S-1},
// and then, per element,
//   dx = g gate i,  di = g gate x,
//   d log_a = g (h_{t-1} a - (i x) a^2 / gate),   dr = -8 sp d log_a,
// (d gate / d log_a = -a^2 / gate, as jax.grad of the reference's gate),
//   dlam = -8 sigmoid(lam) sum over (b, t) of d log_a r,   dh0 = a_0 g_0.
// h_{t-1} is read from the forward's output h (h0 or zero before t = 0).
//
// What bounds it on an H100: each element reads x, r, i, h and dy and
// writes dx, dr, di: 32 bytes for ~20 operations, so the bytes bound it:
// at the training shape (B = 2, S = 4,096, W = 4,096) 1.07 GB, 0.32 ms at
// 3.35 TB/s. The reverse scan is sequential in time, so the schedule is
// the forward's mirrored in time, chunks of TCHUNK tokens:
//   local (every chunk c but the first, from a zero carry, walking its
//          tokens backwards): its decay product A_c (the forward's) and
//          a_lo g_lo, what it passes to the chunk on its left; reads r
//          and dy only;
//   carry (per (batch, channel), the chunks from the last down): the
//          carry into chunk c - 1, q_{c-1} = A_c q_c + end_c, q_last = 0;
//   out   (every chunk from its carry, backwards): the gradients, and
//          the chunk's share of dlam's sum (f32, in token order from the
//          chunk's end) into dlp [B, nc, W]; chunk 0 also writes dh0;
//   lam   (per channel): dlp summed in double over (b, c) in that order,
//          times -8 sigmoid(lam).
// So r and dy are read twice: 40 bytes an element, not 32. No atomics and
// a fixed order: the result is the same bits on every run.

// the reverse walk of tokens [t0, t1) of one (batch, channel) from the
// carry g (what reaches h_{t1-1} from its right). OUT stores each token's
// dx, dr, di and adds d log_a r into *part; otherwise the tokens' log_a
// are summed in double into *lsum. h_before is h_{t0-1}. Returns a_{t0}
// g_{t0}, what passes to the chunk on the left.
template <bool OUT>
__device__ __forceinline__ float run_bwd(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ gi, const float* __restrict__ h,
    const float* __restrict__ dy, float* __restrict__ dx,
    float* __restrict__ dr, float* __restrict__ di, long long base, int t0,
    int t1, int W, float neg_c_sp, float g, float h_before, double* lsum,
    float* part) {
  double ls = 0.0;
  float acc = 0.0f;
  float a_next = 1.0f;
  int t = t1;
  for (; t - UNROLL >= t0; t -= UNROLL) {
    float rv[UNROLL], dv[UNROLL], xv[UNROLL], iv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int tt = t - 1 - u;
      const long long o = base + (long long)tt * W;
      rv[u] = __ldg(r + o);
      dv[u] = __ldg(dy + o);
      if (OUT) {
        xv[u] = __ldg(x + o);
        iv[u] = __ldg(gi + o);
        hv[u] = tt > t0 ? __ldg(h + o - W) : h_before;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float log_a = neg_c_sp * rv[u];
      const float a = expf(log_a);
      g = __fmaf_rn(a_next, g, dv[u]);
      a_next = a;
      if (OUT) {
        const long long o = base + (long long)(t - 1 - u) * W;
        const float gate = sqrtf(-expm1f(2.0f * log_a));
        const float gg = g * gate;
        const float dla = g * (hv[u] * a - (iv[u] * xv[u]) * (a * a) / gate);
        dx[o] = gg * iv[u];
        di[o] = gg * xv[u];
        dr[o] = neg_c_sp * dla;
        acc += dla * rv[u];
      } else {
        ls += (double)log_a;
      }
    }
  }
  for (; t > t0; --t) {                       // the ragged head
    const int tt = t - 1;
    const long long o = base + (long long)tt * W;
    const float rv = __ldg(r + o);
    const float log_a = neg_c_sp * rv;
    const float a = expf(log_a);
    g = __fmaf_rn(a_next, g, __ldg(dy + o));
    a_next = a;
    if (OUT) {
      const float xv = __ldg(x + o), iv = __ldg(gi + o);
      const float hv = tt > t0 ? __ldg(h + o - W) : h_before;
      const float gate = sqrtf(-expm1f(2.0f * log_a));
      const float gg = g * gate;
      const float dla = g * (hv * a - (iv * xv) * (a * a) / gate);
      dx[o] = gg * iv;
      di[o] = gg * xv;
      dr[o] = neg_c_sp * dla;
      acc += dla * rv;
    } else {
      ls += (double)log_a;
    }
  }
  if (OUT) *part = acc;
  else *lsum = ls;
  return a_next * g;
}

// --- local: chunk c >= 1 from a zero carry ---------------------------------
//
// dec, loc [B, nc - 1, W]: chunk c's decay product and a_lo g_lo at c - 1
__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_local_kernel(const float* __restrict__ r,
                        const float* __restrict__ dy,
                        const float* __restrict__ lam,
                        float* __restrict__ dec, float* __restrict__ loc,
                        int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y + 1, nl = gridDim.y;
  const long long b = blockIdx.z;
  const float neg_c_sp = -GATE_C * softplus(lam[w]);
  double ls;
  const float end = run_bwd<false>(
      nullptr, r, nullptr, nullptr, dy, nullptr, nullptr, nullptr,
      b * (long long)S * W + w, c * TCHUNK, min(S, (c + 1) * TCHUNK), W,
      neg_c_sp, 0.0f, 0.0f, &ls, nullptr);
  const long long o = (b * nl + c - 1) * W + w;
  dec[o] = expf((float)ls);
  loc[o] = end;
}

// --- carry: q_{c-1} = A_c q_c + end_c, in place over loc -------------------
//
// afterwards loc[b, c] holds the carry into chunk c from its right
__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_carry_kernel(const float* __restrict__ dec,
                        float* __restrict__ loc, int W, int nl) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  float q = 0.0f;
  for (int c1 = nl; c1 > 0; c1 -= CARRY_BATCH) {  // chunks [c1 - 16, c1)
    float dv[CARRY_BATCH], lv[CARRY_BATCH];
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      const int c = c1 - 1 - k;
      const long long o = (b * nl + c) * W + w;
      dv[k] = c >= 0 ? dec[o] : 0.0f;
      lv[k] = c >= 0 ? loc[o] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CARRY_BATCH; ++k) {
      const int c = c1 - 1 - k;
      if (c < 0) break;
      q = __fmaf_rn(dv[k], q, lv[k]);
      loc[(b * nl + c) * W + w] = q;
    }
  }
}

// --- out: every chunk from its carry, writing the gradients ----------------
__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_out_kernel(const float* __restrict__ x,
                      const float* __restrict__ r,
                      const float* __restrict__ gi,
                      const float* __restrict__ lam,
                      const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ dy,
                      const float* __restrict__ carry,
                      float* __restrict__ dx, float* __restrict__ dr,
                      float* __restrict__ di, float* __restrict__ dlp,
                      float* __restrict__ dh0, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, nc = gridDim.y, nl = nc - 1;
  const long long b = blockIdx.z;
  const long long base = b * (long long)S * W + w;
  const float neg_c_sp = -GATE_C * softplus(lam[w]);
  const float q = c < nl ? carry[(b * nl + c) * W + w] : 0.0f;
  const int t0 = c * TCHUNK;
  float h_before;
  if (c > 0)
    h_before = h[base + (long long)(t0 - 1) * W];
  else
    h_before = h0 != nullptr ? h0[b * W + w] : 0.0f;
  float part;
  const float left = run_bwd<true>(x, r, gi, h, dy, dx, dr, di, base, t0,
                                   min(S, t0 + TCHUNK), W, neg_c_sp, q,
                                   h_before, nullptr, &part);
  dlp[(b * nc + c) * W + w] = part;
  if (c == 0 && dh0 != nullptr) dh0[b * W + w] = left;
}

// --- lam: dlam = -8 sigmoid(lam) * (dlp summed over (b, c) in order) -------
__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_lam_kernel(const float* __restrict__ lam,
                      const float* __restrict__ dlp,
                      float* __restrict__ dlam, int B, int nc, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  double s = 0.0;
  for (int bc = 0; bc < B * nc; ++bc) s += (double)dlp[(long long)bc * W + w];
  const float sig = 1.0f / (1.0f + expf(-lam[w]));
  dlam[w] = (float)s * (-GATE_C * sig);
}

}  // namespace

extern "C" {

const char* rg_lru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the chunks the kernel cuts a sequence of S tokens into
int rg_lru_chunks(int S) { return (S + TCHUNK - 1) / TCHUNK; }

// h0 may be null (a zero initial state). Scratch, allocated by the
// caller: dec and loc f32 [B, nc - 1, W] with nc = rg_lru_chunks(S),
// null where nc = 1.
int rg_lru_fwd(const void* x, const void* r, const void* i, const void* lam,
               const void* h0, void* h, void* dec, void* loc, int B, int S,
               int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const int nc = rg_lru_chunks(S);
  if (B < 0 || S < 0 || W < 0 || B > 65535 || nc > 65535 ||
      (nc > 1 && (dec == nullptr || loc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(x);
  const float* fr = static_cast<const float*>(r);
  const float* fi = static_cast<const float*>(i);
  const float* flam = static_cast<const float*>(lam);
  const float* fh0 = static_cast<const float*>(h0);
  float* fdec = static_cast<float*>(dec);
  float* floc = static_cast<float*>(loc);
  const int wb = (W + THREADS - 1) / THREADS;
  if (nc > 1) {
    rg_lru_local_kernel<<<dim3(wb, nc - 1, B), THREADS, 0, st>>>(
        fx, fr, fi, flam, fdec, floc, S, W);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
    rg_lru_carry_kernel<<<dim3(wb, B), THREADS, 0, st>>>(fh0, fdec, floc, W,
                                                         nc - 1);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
  }
  rg_lru_out_kernel<<<dim3(wb, nc, B), THREADS, 0, st>>>(
      fx, fr, fi, flam, fh0, floc, static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

// The gradients of rg_lru_fwd. x, r, i, h (the forward's output), dy (the
// gradient with respect to h) f32 [B, S, W]; lam [W]; h0 [B, W] or null.
// Outputs dx, dr, di [B, S, W], dlam [W], and dh0 [B, W] (null: not
// written). Scratch, allocated by the caller: dec and loc f32 [B, nc - 1,
// W] with nc = rg_lru_chunks(S), null where nc = 1; dlp f32 [B, nc, W].
int rg_lru_bwd(const void* x, const void* r, const void* i, const void* lam,
               const void* h, const void* h0, const void* dy, void* dx,
               void* dr, void* di, void* dlam, void* dh0, void* dec,
               void* loc, void* dlp, int B, int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const int nc = rg_lru_chunks(S);
  if (B < 0 || S < 0 || W < 0 || B > 65535 || nc > 65535 || dlp == nullptr ||
      (nc > 1 && (dec == nullptr || loc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fr = static_cast<const float*>(r);
  const float* fdy = static_cast<const float*>(dy);
  const float* flam = static_cast<const float*>(lam);
  float* fdec = static_cast<float*>(dec);
  float* floc = static_cast<float*>(loc);
  float* fdlp = static_cast<float*>(dlp);
  const int wb = (W + THREADS - 1) / THREADS;
  if (nc > 1) {
    rg_lru_bwd_local_kernel<<<dim3(wb, nc - 1, B), THREADS, 0, st>>>(
        fr, fdy, flam, fdec, floc, S, W);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
    rg_lru_bwd_carry_kernel<<<dim3(wb, B), THREADS, 0, st>>>(fdec, floc, W,
                                                             nc - 1);
    if (int e = static_cast<int>(cudaGetLastError())) return e;
  }
  rg_lru_bwd_out_kernel<<<dim3(wb, nc, B), THREADS, 0, st>>>(
      static_cast<const float*>(x), fr, static_cast<const float*>(i), flam,
      static_cast<const float*>(h), static_cast<const float*>(h0), fdy, floc,
      static_cast<float*>(dx), static_cast<float*>(dr),
      static_cast<float*>(di), fdlp, static_cast<float*>(dh0), S, W);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  rg_lru_bwd_lam_kernel<<<wb, THREADS, 0, st>>>(
      flam, fdlp, static_cast<float*>(dlam), B, nc, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
