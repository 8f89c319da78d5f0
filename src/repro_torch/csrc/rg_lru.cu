// The RG-LRU gated linear recurrence (forward) for Hopper (sm_90a).
//
// Replaces: repro/kernels/rg_lru/kernel.py rg_lru_fwd (body _rglru_kernel),
// the same function as the model's associative scan repro/models/hybrid.py
// rg_lru. The plain PyTorch version is repro_torch/kernels/rg_lru/ref.py
// (rg_lru_plain).
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
// recurrence is elementwise over channels and sequential in time. The
// Pallas kernel tiles channels by 512 lanes and time by 256-token chunks
// carried in VMEM along a sequential grid axis; here one thread owns one
// (batch, channel) and walks the whole sequence, so the carry never
// leaves a register and no block waits on another. Neighbouring threads
// read neighbouring channels (coalesced), and each thread issues the
// loads of the next UNROLL steps before the dependent chain of FMAs that
// consumes them, to keep loads in flight. No atomics and a fixed order:
// the result is the same bits on every run. With B x W = 8,192 threads
// the grid fills only 32 of 132 SMs; a chunked three-phase scan (local
// scans and decay products per chunk, a carry pass across chunks, a
// fix-up) is the later fast version.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launch (0 = cudaSuccess).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // channels per block
constexpr int UNROLL = 16;     // time steps loaded ahead of their use
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

__global__ void __launch_bounds__(THREADS)
rg_lru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ r,
                  const float* __restrict__ gi, const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ h_out,
                  int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long b = blockIdx.y;
  const float neg_c_sp = -GATE_C * softplus(lam[w]);
  float h = h0 != nullptr ? h0[b * W + w] : 0.0f;
  const long long base = b * (long long)S * W + w;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
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
      h = step(h, xv[u], rv[u], iv[u], neg_c_sp);
      h_out[base + (long long)(t + u) * W] = h;
    }
  }
  for (; t < S; ++t) {                       // the ragged tail
    const long long o = base + (long long)t * W;
    h = step(h, __ldg(x + o), __ldg(r + o), __ldg(gi + o), neg_c_sp);
    h_out[o] = h;
  }
}

}  // namespace

extern "C" {

const char* rg_lru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h0 may be null (a zero initial state)
int rg_lru_fwd(const void* x, const void* r, const void* i, const void* lam,
               const void* h0, void* h, int B, int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  if (B < 0 || S < 0 || W < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rg_lru_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<const float*>(i), static_cast<const float*>(lam),
      static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
