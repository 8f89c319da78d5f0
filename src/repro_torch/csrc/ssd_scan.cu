// The Mamba-2 SSD chunked scan for Hopper (sm_90a): the forward as four
// kernels and its gradient as six, chunk-parallel on the tensor cores.
//
// Replaces:
//   ssd_fwd <- repro/kernels/ssd_scan/kernel.py ssd_scan_fwd (body
//              _ssd_kernel), the same function as the model's pure-jnp
//              repro/models/ssm.py ssd_chunked
//   ssd_bwd <- no Pallas kernel: the JAX package differentiates the jnp
//              ssd_chunked with jax.grad; this is that gradient
// The plain PyTorch versions are in repro_torch/kernels/ssd_scan/ref.py
// (ssd_fwd_plain, and ssd_fwd_phased_plain, the forward's four phases in
// plain tensors; ssd_grads_plain, autograd through ssd_fwd_plain, for the
// backward, and ssd_bwd_phased_plain, the backward's three phases).
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
// for bf16, so the bytes bound it; the backward likewise.
//
// Both directions are chunk-parallel, because given the state at a chunk's
// start (forward) or the gradient of its end state (backward) every output of
// the chunk is local to it, and those states follow a short linear recurrence
// over chunks. The forward: C.B^T once per (batch, chunk) tile pair (no head
// axis: every head reads it); per (batch, chunk, head) the chunk's cum and its
// end state from a zero start, dS_c = sum_j exp(cum_Q - cum_j) xdt_j B_j^T; the
// pass per (batch, head) over [P, N] tiles, S_{c+1} = exp(cum_Q,c) S_c + dS_c,
// which turns dS into the chunk-start states in place; then y per (batch,
// chunk, head). That is 6,144 blocks at the training shape where one block per
// (batch, head) walking the chunks on the CUDA cores gave 384 (the first
// version, 11.4 ms on an H100; it also redid C.B^T for every head and summed
// each chunk's cum on one thread). In the output kernel, building M = G
// exp(cum_i - cum_j) dt_j for the MMAs first cost more than the MMAs: G^T read
// four bytes at a time from its scores and an exponential per element sat on
// the path of every tile pair, behind 2 blocks an SM (PERF.md §6). So G^T tiles
// come through shared memory in 16-byte loads, and below the diagonal the decay
// factors through the last token of the column tile (see the kernel). What
// stays above the bound: the f32 operands' extra bf16 terms (~250 GFLOP of MMAs
// issued for the 129 counted), x and the states read a second time, and 4-warp
// blocks at ~200 registers whose loads wait behind a barrier per tile.
//
// The backward: the gradient of chunk c's end state follows dS_{c-1} =
// exp(cum_Q,c) dS_c + W_c with W_c = sum_i exp(cum_i) dy_i C_i^T, and
// given dS_c and the saved start state every gradient of chunk c is
// local to it. So: W_c per (batch, chunk, head), then the short reverse
// pass per (batch, head), then the chunk gradients. The chunk gradients
// are three kernels because their sums nest the other way round: dx and
// ddt sum over the tokens that read a token (a loop over column tiles
// inside one head), dB and dC also sum over the heads (a loop over heads
// inside one tile pair, whose head sum then meets B or C once per group
// of 8 heads); the inter-chunk terms, which read the start state but no
// other chunk gradient, are a third kernel per head group that runs
// first.
//
// All products run on the tensor cores (see below). No atomics: every sum
// has one owner and a fixed order, and the head-group partials of dB and
// dC ([B, ceil(H/8), S, N]) and the (batch, chunk) partials of dA are
// summed in a fixed order by the wrapper, so a call gives the same bits
// on every run.
//
// Numerics: the in-chunk cumsum is accumulated in double, each of 128
// threads a run of consecutive tokens added to the runs before it by a
// fixed scan, and rounded to f32 once per token; exp is taken only on
// and below the diagonal (above it exp(cum_i - cum_j) overflows to inf
// and inf * 0 would be NaN).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launches (0 = cudaSuccess).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAXP = 64;          // head dim the kernels take
constexpr int MAXN = 128;         // state dim
constexpr int MAXQ = 1024;        // chunk length

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

// =========================================================================
// the tensor-core machinery
// =========================================================================
//
// The forward is four kernels and the backward six, each launched in
// order on one stream (see launch_fwd, launch_bwd):
//   scores (G^T = B C^T per (batch, chunk) tile pair, into gt; both),
//   fwd state (the chunk's cum into `cum`, its end state from a zero
//           start into `states`), fwd pass (states -> chunk-start states
//           in place, and final), fwd out (y);
//   w      (the chunk's cum into `cum`, W_c = sum_i e_i dy_i C_i^T into w),
//   pass   (w -> dS in place: the reverse recurrence over chunks),
//   inter  (per (batch, chunk, head group): the inter-chunk terms, of dC
//           into that group's dC rows and of d cum per head into ddt),
//   chunk  (per (batch, chunk, head): dx, ddt, the head's share of dA),
//   dbc    (per (batch, chunk, head group): that group's dB, and the
//           in-chunk term of its dC).
// The inter-chunk term of d cum, exp(cum_i) dy_i . (S0 C_i), is taken in
// the per-group kernel, not the per-head one: there it is a dot of C_i
// with the chain of MMAs that dC's term computes anyway (dy_i . S0),
// while as a loop of its own tile products (S0 C_i^T) in the per-head
// kernel it cost that kernel 1.27 of its 3.64 ms on an H100 (PERF.md §6).
// Every product is mma.sync m16n8k16 on bf16 with f32 accumulators. An f32
// operand goes in as three bf16 terms (hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid), 24 bits of significand between them); a
// product of two such takes the six MMAs whose terms reach 2^-16 of it
// (hh, hm, mh, hl, mm, lh), a product with a bf16 operand three. Two
// terms (2^-17 a product) were measured on this card to move dx and dC
// of a small bf16 case past their limits, where one bf16 rounding of
// the output decides: the limits hold the kernel to the plain version's
// f32 within 4x its own reblocking spread. Per-token factors (exp(cum),
// dt) scale a chain's rows or the f32 operand, so x, B and C stay exact
// bf16 operands. Each chain of MMAs covers 64 of K from zero
// accumulators and is folded in with f32 adds (the tensor cores' own
// accumulation drifts over long chains).

using bf16 = __nv_bfloat16;

constexpr int MT = 128;          // threads of a tensor-core block: 4 warps
constexpr int BT = 64;           // rows of a tile; each warp owns 16
constexpr int LDK = MAXP + 8;    // bf16 row of a [., 64] tile (P or tokens)
constexpr int LDW = MAXN + 8;    // bf16 row of a [., 128] tile (N)
constexpr int LDG = BT + 4;      // f32 row of a [64, 64] tile of G^T
constexpr int HG = 8;            // heads per owner of the dB / dC sums
constexpr int PASS_NT = 256;     // threads of the reverse state pass
constexpr int PASS_BATCH = 8;    // chunks whose W a pass thread loads at once
constexpr unsigned FULL = 0xffffffffu;

// bf16 planes an input of this type takes, and its values per 16 bytes
template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int planes = 3, vec = 4;
};
template <> struct Elem<bf16> {
  static constexpr int planes = 1, vec = 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// d[j] += A.B_j for J n8 blocks, over the bf16 terms of A (NA of them)
// and of each B_j (NB), the pairs whose weight reaches 2^-16: (0,0),
// (0,1), (1,0), (0,2), (1,1), (2,0). The J blocks are the inner loop, so
// consecutive MMAs go to different accumulators and are in flight
// together; each accumulator takes its terms in the same order whatever J.
template <int NA, int NB, int J>
__device__ __forceinline__ void mma_terms(float (&d)[J][4],
                                          const uint32_t (&a)[3][4],
                                          const uint32_t (&b)[J][3][2]) {
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int ia = 0; ia <= s; ++ia)
      if (ia < NA && s - ia < NB)
#pragma unroll
        for (int j = 0; j < J; ++j)
          mma_bf16(d[j], a[ia], b[j][s - ia][0], b[j][s - ia][1]);
}

// J consecutive accumulators of t from n8 block n0 on
template <int J, int NB>
__device__ __forceinline__ float (&blocks(float (&t)[NB][4], int n0))[J][4] {
  return *reinterpret_cast<float(*)[J][4]>(&t[n0]);
}

// An m16n8 f32 accumulator c[4] of lane l = 4g + t holds rows g (c[0],
// c[1]) and g + 8 (c[2], c[3]), columns 2t and 2t + 1. Two accumulators
// side by side (columns 0-7 and 8-15) hold an m16k16 A fragment's
// elements in its register order.

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + mid + lo, each a pair of bf16 (the differences are
// exact in f32)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&o)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  o[0] = bf16x2_bits(h);
  o[1] = bf16x2_bits(m);
  o[2] = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// accumulators c0 (columns 0-7), c1 (8-15) -> the three A fragments of
// the m16k16 block they form
__device__ __forceinline__ void a_split3(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[3][4]) {
  uint32_t o[3];
  split3(c0[0], c0[1], o);
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k][0] = o[k];
  split3(c0[2], c0[3], o);
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k][1] = o[k];
  split3(c1[0], c1[1], o);
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k][2] = o[k];
  split3(c1[2], c1[3], o);
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k][3] = o[k];
}

// acc += t, rows g scaled by s0 and rows g + 8 by s1
__device__ __forceinline__ void add_to(float (&acc)[4], const float (&t)[4],
                                       float s0 = 1.f, float s1 = 1.f) {
  acc[0] += t[0] * s0;
  acc[1] += t[1] * s0;
  acc[2] += t[2] * s1;
  acc[3] += t[3] * s1;
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int ld, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane % 16)) * ld + c0 + (lane / 16) * 8);
}

// the same from a tile stored transposed, [c][r]
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0, int lane) {
  ldsm_x4_t(a, tile + (c0 + (lane / 16) * 8 + (lane % 8)) * ld + r0 +
                   ((lane / 8) % 2) * 8);
}

// B fragments of two n8 blocks n0..n0+15 at k0..k0+15 (b[0], b[1] for
// n0..n0+7, b[2], b[3] for n0+8..n0+15): NK, the tile is [n][k]
// (B = T^T); otherwise it is [k][n] (B = T); row-major either way
template <bool NK>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* tile,
                                     int ld, int n0, int k0, int lane) {
  if (NK)
    ldsm_x4(b, tile + (n0 + (lane / 16) * 8 + (lane % 8)) * ld + k0 +
                   ((lane / 8) % 2) * 8);
  else
    ldsm_x4_t(b, tile + (k0 + ((lane / 8) % 2) * 8 + (lane % 8)) * ld + n0 +
                     (lane / 16) * 8);
}

// the sum over a warp, the same bits on every lane (a tree to lane 0,
// then broadcast)
__device__ __forceinline__ float warp_total(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// the values of a 16-byte vector as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// a tile in shared memory as its bf16 planes (hi, mid, lo; one plane for
// a bf16 input)
struct Planes {
  bf16* p[3];
};

template <int NP>
__device__ __forceinline__ Planes planes_at(bf16* base, int size) {
  Planes r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.p[k] = k < NP ? base + k * size : nullptr;
  return r;
}

// two values, as NP planes, into dst at offset o (or, TRANS, at o and
// o + ld: the transposed tile's next row)
template <int NP, bool TRANS>
__device__ __forceinline__ void put2(const Planes& dst, int o, int ld,
                                     float v0, float v1) {
  uint32_t s[3];
  split3(v0, v1, s);
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (TRANS) {
      dst.p[k][o] = __ushort_as_bfloat16(static_cast<unsigned short>(s[k]));
      dst.p[k][o + ld] =
          __ushort_as_bfloat16(static_cast<unsigned short>(s[k] >> 16));
    } else {
      *reinterpret_cast<uint32_t*>(dst.p[k] + o) = s[k];
    }
  }
}

// rows [r0, r0 + 64) and columns [0, W) of a row-major source (row stride
// rs; rows at or past `rows` and columns at or past `w` are zeros) ->
// NP planes with row stride ld, or with TRANS the transpose (element
// (r, c) at [c][r]). SCALE multiplies row t = r0 + r by exp(f[t])
// (SCALE_EXP) or by f[t] (SCALE_BY).
// Where the rows are whole 16-byte vectors, each thread issues its loads
// four at a time before it converts any, so that they are in flight
// together.
enum Scale { SCALE_NONE, SCALE_EXP, SCALE_BY };

__device__ __forceinline__ float row_scale(int mode, const float* f, int t) {
  return mode == SCALE_EXP ? expf(f[t]) : mode == SCALE_BY ? f[t] : 1.f;
}

template <int W, bool TRANS, int NP, int SCALE, typename T>
__device__ __forceinline__ void load_planes(const Planes& dst, int ld,
                                            const T* __restrict__ src,
                                            long rs, int r0, int rows, int w,
                                            const float* f = nullptr) {
  constexpr int VEC = Elem<T>::vec, VPR = W / VEC;
  constexpr int NV = BT * VPR / MT;   // vectors per thread
  const bool vec_ok = w % VEC == 0 && rs % VEC == 0 &&
                      reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec_ok) {
    constexpr int NB4 = NV;   // loads in flight per batch
#pragma unroll
    for (int k0 = 0; k0 < NV; k0 += NB4) {
      uint4 buf[NB4];
#pragma unroll
      for (int k = 0; k < NB4; ++k) {
        const int idx = threadIdx.x + (k0 + k) * MT, r = idx / VPR;
        const int c = (idx - r * VPR) * VEC, t = r0 + r;
        buf[k] = t < rows && c < w
                     ? *reinterpret_cast<const uint4*>(src + t * rs + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < NB4; ++k) {
        const int idx = threadIdx.x + (k0 + k) * MT, r = idx / VPR;
        const int c = (idx - r * VPR) * VEC, t = r0 + r;
        float v[VEC];
        unpack(buf[k], v);
        const float sc = t < rows ? row_scale(SCALE, f, t) : 1.f;
#pragma unroll
        for (int e = 0; e < VEC; e += 2)
          put2<NP, TRANS>(dst, TRANS ? (c + e) * ld + r : r * ld + c + e, ld,
                          v[e] * sc, v[e + 1] * sc);
      }
    }
    return;
  }
  constexpr int HW = W / 2;
  for (int idx = threadIdx.x; idx < BT * HW; idx += MT) {
    const int r = idx / HW, c = 2 * (idx - r * HW), t = r0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (t < rows) {
      const T* row = src + t * rs;
      const float sc = row_scale(SCALE, f, t);
      if (c < w) v0 = to_f(row[c]) * sc;
      if (c + 1 < w) v1 = to_f(row[c + 1]) * sc;
    }
    put2<NP, TRANS>(dst, TRANS ? c * ld + r : r * ld + c, ld, v0, v1);
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&a)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// acc[NB][4] += A.B for the warp's 16 rows a0.. of A (NA planes,
// row-major [m][k], or with AKM [k][m]; K = KT) and B (NBP planes; BNK:
// [n][k], else [k][n]); each 64 of K is one chain of MMAs per n8 block
// from zero,
// folded into acc with f32 adds, rows g scaled by s0 and rows g + 8 by
// s1. The k16 steps are the outer loop, so the NB chains are independent
// MMAs in flight together.
template <int NB, int KT, int NA, int NBP, bool BNK, bool AKM = false>
__device__ __forceinline__ void warp_mma(float (&acc)[NB][4], const Planes& A,
                                         int lda, int a0, const Planes& Bp,
                                         int ldb, int lane, float s0 = 1.f,
                                         float s1 = 1.f) {
#pragma unroll
  for (int k0 = 0; k0 < KT; k0 += 64) {
    float t[NB][4];
    zero(t);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t a[3][4];
#pragma unroll
      for (int k = 0; k < NA; ++k) {
        if (AKM)
          ld_a_t(a[k], A.p[k], lda, a0, k0 + 16 * kt, lane);
        else
          ld_a(a[k], A.p[k], lda, a0, k0 + 16 * kt, lane);
      }
#pragma unroll
      for (int np = 0; np < NB / 2; np += 2) {
        uint32_t f[4][3][2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < NBP; ++k) {
            uint32_t b[4];
            ld_b<BNK>(b, Bp.p[k], ldb, (np + q) * 16, k0 + 16 * kt, lane);
            f[2 * q][k][0] = b[0];
            f[2 * q][k][1] = b[1];
            f[2 * q + 1][k][0] = b[2];
            f[2 * q + 1][k][1] = b[3];
          }
        mma_terms<NA, NBP, 4>(blocks<4>(t, 2 * np), a, f);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) add_to(acc[n], t[n], s0, s1);
  }
}

// acc[NB][4] += A.B for A the warp's 16 x 64 f32 accumulator tile a[8][4]
// (three bf16 terms) and B columns b0.. of NBP planes [k][n], K = 64: one
// chain per n8 block, folded into acc with an f32 add (with KOUTER, rows
// g scaled by s0 and rows g + 8 by s1). KOUTER steps over
// k first, so that the NB chains are in flight together and only one
// step's A fragments are live (for a narrow acc); otherwise the n8 blocks
// go first with every A fragment split once (for a wide acc).
template <int NB, int NBP, bool KOUTER>
__device__ __forceinline__ void warp_mma_regs(float (&acc)[NB][4],
                                              const float (&a)[8][4],
                                              const Planes& Bp, int ldb,
                                              int b0, int lane,
                                              float s0 = 1.f, float s1 = 1.f) {
  // the B fragments of n8 blocks b0 + 8 (2 np) .. + 31 at k step kt
  auto frags = [&](int np, int kt, uint32_t (&f)[4][3][2]) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < NBP; ++k) {
        uint32_t b[4];
        ld_b<false>(b, Bp.p[k], ldb, b0 + (np + q) * 16, 16 * kt, lane);
        f[2 * q][k][0] = b[0];
        f[2 * q][k][1] = b[1];
        f[2 * q + 1][k][0] = b[2];
        f[2 * q + 1][k][1] = b[3];
      }
  };
  if (KOUTER) {
    float t[NB][4];
    zero(t);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t af[3][4];
      a_split3(a[2 * kt], a[2 * kt + 1], af);
#pragma unroll
      for (int np = 0; np < NB / 2; np += 2) {
        uint32_t f[4][3][2];
        frags(np, kt, f);
        mma_terms<3, NBP, 4>(blocks<4>(t, 2 * np), af, f);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) add_to(acc[n], t[n], s0, s1);
    return;
  }
  uint32_t af[4][3][4];
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) a_split3(a[2 * kt], a[2 * kt + 1], af[kt]);
#pragma unroll
  for (int np = 0; np < NB / 2; np += 2) {
    float t[4][4];
    zero(t);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t f[4][3][2];
      frags(np, kt, f);
      mma_terms<3, NBP, 4>(t, af[kt], f);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) add_to(acc[2 * np + q], t[q]);
  }
}

// scum[t] = sum_{s <= t} dt_s * A over the chunk's Q tokens (dtp[s *
// dstride]), summed in double and rounded to f32 once per token: each
// thread sums a run of consecutive tokens, a fixed scan adds the runs
// before it. sw: 4 doubles of shared memory. Syncs before returning.
__device__ __forceinline__ void chunk_cum_scan(float* scum, const float* dtp,
                                               long dstride, float A, int Q,
                                               double* sw) {
  const int per = (Q + MT - 1) / MT;
  const int lo = threadIdx.x * per, hi = min(Q, lo + per);
  double tot = 0.0;
  for (int t = lo; t < hi; ++t)
    tot += static_cast<double>(__fmul_rn(dtp[t * dstride], A));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  double run = incl - tot;
  for (int k = 0; k < warp; ++k) run += sw[k];
  for (int t = lo; t < hi; ++t) {
    run += static_cast<double>(__fmul_rn(dtp[t * dstride], A));
    scum[t] = static_cast<float>(run);
  }
  __syncthreads();
}

// the value at offset o of a tile held as NP planes: hi + mid + lo gives
// back the f32 exactly
template <int NP>
__device__ __forceinline__ float plane_val(const Planes& t, int o) {
  float v = __bfloat162float(t.p[0][o]);
  if (NP > 1) v += __bfloat162float(t.p[1][o]);
  if (NP > 2) v += __bfloat162float(t.p[2][o]);
  return v;
}

// two consecutive values to o, as one store where aligned
__device__ __forceinline__ void store2(float* o, float v0, float v1,
                                       bool aligned) {
  if (aligned) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    o[1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* o, float v0, float v1,
                                       bool aligned) {
  if (aligned) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    o[0] = __float2bfloat16_rn(v0);
    o[1] = __float2bfloat16_rn(v1);
  }
}

// --- scores: G^T_ji = B_j . C_i^T for one tile pair i >= j of a chunk ---------
//
// gt [B * nc, qp, qp] f32 (qp = the chunk padded to whole tiles), row j,
// column i; tiles above the diagonal are not written. It has no head
// axis: every head of the chunk reads it, in the forward and the
// backward alike.
template <typename T>
__global__ void __launch_bounds__(MT)
ssd_scores_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                      float* __restrict__ gt, Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* p = reinterpret_cast<bf16*>(bsm);
  const Planes sB = planes_at<NP>(p, BT * LDW);
  const Planes sC = planes_at<NP>(p + NP * BT * LDW, BT * LDW);

  const int nc = d.S / d.Q, nt = (d.Q + BT - 1) / BT, qp = nt * BT;
  int i = 0, j = blockIdx.x;
  while (j > i) j -= ++i;
  const int bc = blockIdx.y;
  const long tok0 = static_cast<long>(bc / nc) * d.S +
                    static_cast<long>(bc % nc) * d.Q;
  load_planes<MAXN, false, NP, SCALE_NONE>(sB, LDW, Bm + tok0 * d.N, d.N,
                                           j * BT, d.Q, d.N);
  load_planes<MAXN, false, NP, SCALE_NONE>(sC, LDW, Cm + tok0 * d.N, d.N,
                                           i * BT, d.Q, d.N);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[8][4];
  zero(g);
  warp_mma<8, MAXN, NP, NP, true>(g, sB, LDW, warp * 16, sC, LDW, lane);
  float* out = gt + (static_cast<long>(bc) * qp + j * BT + warp * 16) * qp +
               i * BT;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + static_cast<long>(lane / 4 + 8 * r) *
                                           qp + nb * 8 + 2 * (lane % 4)) =
          make_float2(g[nb][2 * r], g[nb][2 * r + 1]);
}

// --- fwd state: the chunk's cum and its end state from a zero start --------
//
// dS_c = sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T per (batch, chunk, head),
// into states[b, h, c] ([B, H, nc, P, N] f32; the pass turns it into the
// chunk-start state); cum [B, H, S] f32. The A operand is x_j scaled by
// its token's factor, three bf16 terms, stored as x is ([j][p]) and read
// transposed by ldmatrix (a transposed store would put a warp's 2-byte
// stores on few banks); B stays an exact bf16 operand.
template <typename T>
__global__ void __launch_bounds__(MT)
ssd_fwd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Av, const T* __restrict__ Bm,
                     float* __restrict__ cum, float* __restrict__ states,
                     Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  double* sw = reinterpret_cast<double*>(bsm);
  bf16* p = reinterpret_cast<bf16*>(bsm + 64);
  const Planes sX = planes_at<3>(p, BT * LDK);    // x_j sf_j: [j][p]
  p += 3 * BT * LDK;
  const Planes sB = planes_at<NP>(p, BT * LDW);   // B_j: [j][n]
  p += NP * BT * LDW;
  float* scum = reinterpret_cast<float*>(p);
  float* sf = scum + d.Q;                  // dt_j exp(cum_Q - cum_j)

  const int h = blockIdx.x, bc = blockIdx.y;
  const int Q = d.Q, nc = d.S / Q, b = bc / nc, c = bc % nc;
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * Q;
  const long bh = static_cast<long>(b) * d.H + h;
  const long xs = static_cast<long>(d.H) * d.P;
  chunk_cum_scan(scum, dt + tok0 * d.H + h, d.H, Av[h], Q, sw);
  for (int t = threadIdx.x; t < Q; t += MT) {
    cum[bh * d.S + static_cast<long>(c) * Q + t] = scum[t];
    sf[t] = dt[(tok0 + t) * d.H + h] * expf(scum[Q - 1] - scum[t]);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[16][4];
  zero(acc);
  for (int k0 = 0; k0 < Q; k0 += BT) {
    __syncthreads();
    load_planes<MAXP, false, 3, SCALE_BY>(sX, LDK, x + tok0 * xs + h * d.P,
                                          xs, k0, Q, d.P, sf);
    load_planes<MAXN, false, NP, SCALE_NONE>(sB, LDW, Bm + tok0 * d.N, d.N,
                                             k0, Q, d.N);
    __syncthreads();
    warp_mma<16, BT, 3, NP, false, true>(acc, sX, LDK, warp * 16, sB, LDW,
                                         lane);
  }
  float* out = states + (bh * nc + c) * d.P * d.N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = warp * 16 + lane / 4 + 8 * r;
    if (pr >= d.P) continue;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nb * 8 + 2 * (lane % 4) + e;
        if (n < d.N) out[pr * d.N + n] = acc[nb][2 * r + e];
      }
  }
}

// --- fwd pass: S_{c+1} = exp(cum_Q,c) S_c + dS_c, in place over states ------
//
// One thread per element of a (batch, head)'s [P, N] tile, the chunks in
// order, PASS_BATCH chunks' dS loaded at once; afterwards states[b, h, c]
// holds the state at chunk c's start and final the state after the last.
__global__ void __launch_bounds__(PASS_NT)
ssd_fwd_pass_kernel(const float* __restrict__ cum,
                    const float* __restrict__ init,
                    float* __restrict__ states,
                    float* __restrict__ final_state, Dims d) {
  const long PN = static_cast<long>(d.P) * d.N;
  const long e = static_cast<long>(blockIdx.x) * PASS_NT + threadIdx.x;
  if (e >= PN) return;
  const long bh = blockIdx.y;
  const int nc = d.S / d.Q;
  float carry = init != nullptr ? init[bh * PN + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float wv[PASS_BATCH], gv[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int c = c0 + k;
      wv[k] = c < nc ? states[(bh * nc + c) * PN + e] : 0.f;
      gv[k] = c < nc ? cum[bh * d.S + static_cast<long>(c) * d.Q + d.Q - 1]
                     : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int c = c0 + k;
      if (c >= nc) break;
      states[(bh * nc + c) * PN + e] = carry;
      carry = __fadd_rn(__fmul_rn(expf(gv[k]), carry), wv[k]);
    }
  }
  final_state[bh * PN + e] = carry;
}

// --- fwd out: y of one (batch, chunk, head) ----------------------------------
//
// Per 64-row tile i of the chunk, in the warp's 16 rows:
//   y_i = exp(cum_i) C_i . S0^T + sum over tiles j <= i of M_ij x_j,
//   M_ij = G_ij exp(cum_i - cum_j) dt_j   (j <= i; 0 above the diagonal)
// C and x are exact bf16 operands and S0 three terms in shared memory; M
// is built in registers from the scores kernel's G^T tile, which the
// block loads into shared memory with whole 16-byte loads, and goes in
// as three terms (warp_mma_regs). The inter-chunk term comes first, then
// the tiles j in order. cum falls through a chunk (dt >= 0, A <= 0: the
// model's softplus dt and A = -exp, and the wrapper's stated
// precondition), so below the diagonal the decay factors through the last
// token e of tile j: exp(cum_i - cum_j) = exp(cum_i - cum_e) exp(cum_e -
// cum_j), both at most 1 (a factor that underflows leaves a product below
// 1e-38; with a rising cum one factor could overflow instead).
// dt_j exp(cum_e - cum_j) is taken once per token (sw), and exp(cum_i -
// cum_e) scales the chain's rows; only the diagonal tiles take an
// exponential per element, masked before it.
template <typename T>
__global__ void __launch_bounds__(MT, 2)
ssd_fwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ Cm, const float* __restrict__ cum,
                   const float* __restrict__ gt,
                   const float* __restrict__ states, float* __restrict__ y,
                   Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* p = reinterpret_cast<bf16*>(bsm);
  const Planes sS = planes_at<3>(p, MAXP * LDW);   // S0: [p][n]
  p += 3 * MAXP * LDW;
  const Planes sC = planes_at<NP>(p, BT * LDW);    // C_i: [i][n]
  p += NP * BT * LDW;
  const Planes sX = planes_at<NP>(p, BT * LDK);    // x_j: [j][p]
  p += NP * BT * LDK;
  float* sG = reinterpret_cast<float*>(p);         // G^T: [j][i]
  float* sdt = sG + BT * LDG;
  float* scum = sdt + d.Q;
  float* sw = scum + d.Q;

  const int h = blockIdx.x, bc = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N;
  const int nc = d.S / Q, b = bc / nc, c = bc % nc;
  const int nt = (Q + BT - 1) / BT, qp = nt * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * Q;
  const long bh = static_cast<long>(b) * d.H + h;
  const long PN = static_cast<long>(P) * N;
  const long xs = static_cast<long>(d.H) * P;
  const T* xc = x + tok0 * xs + h * P;
  const float* gtc = gt + static_cast<long>(bc) * qp * qp;

  for (int t = tid; t < Q; t += MT) {
    sdt[t] = dt[(tok0 + t) * d.H + h];
    scum[t] = cum[bh * d.S + static_cast<long>(c) * Q + t];
  }
  load_planes<MAXN, false, 3, SCALE_NONE>(sS, LDW, states + (bh * nc + c) * PN,
                                          N, 0, P, N);
  __syncthreads();
  for (int t = tid; t < Q; t += MT) {
    const int e = min(Q - 1, t / BT * BT + BT - 1);
    sw[t] = sdt[t] * expf(scum[e] - scum[t]);
  }

  for (int it = 0; it < nt; ++it) {
    const int i0 = it * BT;
    __syncthreads();
    load_planes<MAXN, false, NP, SCALE_NONE>(sC, LDW, Cm + tok0 * N, N, i0,
                                             Q, N);
    __syncthreads();
    int ir[2];
    float ci[2], ei[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ir[r] = i0 + warp * 16 + g + 8 * r;
      ci[r] = ir[r] < Q ? scum[ir[r]] : 0.f;
      ei[r] = ir[r] < Q ? expf(ci[r]) : 0.f;
    }
    float acc[8][4];
    zero(acc);
    warp_mma<8, MAXN, NP, 3, true>(acc, sC, LDW, warp * 16, sS, LDW, lane,
                                   ei[0], ei[1]);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * BT;
      __syncthreads();
      load_planes<MAXP, false, NP, SCALE_NONE>(sX, LDK, xc, xs, j0, Q, P);
      // G^T rows j0.., columns i0.. (whole tiles: the scores kernel
      // writes every element of a tile pair, padding included)
#pragma unroll
      for (int k = 0; k < BT * BT / 4 / MT; ++k) {
        const int e = tid + k * MT, row = e / (BT / 4), col = e % (BT / 4) * 4;
        *reinterpret_cast<float4*>(sG + row * LDG + col) =
            __ldg(reinterpret_cast<const float4*>(
                gtc + static_cast<long>(j0 + row) * qp + i0 + col));
      }
      __syncthreads();
      float m[8][4], s[2];
      const bool diag = jt == it;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s[r] = 1.f;
        if (!diag)
          s[r] = ir[r] < Q ? expf(ci[r] - scum[j0 + BT - 1]) : 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = nb * 8 + 2 * tq + e, j = j0 + jl;
            const float G = sG[jl * LDG + ir[r] - i0];
            float v;
            if (!diag)
              v = G * sw[j];
            else
              v = j <= ir[r] && ir[r] < Q
                      ? G * expf(ci[r] - scum[j]) * sdt[j] : 0.f;
            m[nb][2 * r + e] = v;
          }
      }
      warp_mma_regs<8, NP, true>(acc, m, sX, LDK, 0, lane, s[0], s[1]);
    }
    float* yb = y + tok0 * xs + h * P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (ir[r] >= Q) continue;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int pc = nb * 8 + 2 * tq;
        if (pc >= P) continue;
        float* o = yb + static_cast<long>(ir[r]) * xs + pc;
        if (pc + 1 < P)
          store2(o, acc[nb][2 * r], acc[nb][2 * r + 1], P % 2 == 0);
        else
          o[0] = acc[nb][2 * r];
      }
    }
  }
}

// --- w: the chunk's cum and W_c = sum_i exp(cum_i) dy_i C_i^T -----------------
//
// One block per (batch, chunk, head); cum [B, H, S] f32, w [B, H, nc, P,
// N] f32. The A operand is dy scaled and split, stored transposed ([p][i]).
template <typename T>
__global__ void __launch_bounds__(MT)
ssd_bwd_w_kernel(const float* __restrict__ dt, const float* __restrict__ Av,
                 const T* __restrict__ Cm, const float* __restrict__ dy,
                 float* __restrict__ cum, float* __restrict__ w, Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  double* sw = reinterpret_cast<double*>(bsm);
  bf16* p = reinterpret_cast<bf16*>(bsm + 64);
  const Planes sDy = planes_at<3>(p, MAXP * LDK);
  p += 3 * MAXP * LDK;
  const Planes sC = planes_at<NP>(p, BT * LDW);
  p += NP * BT * LDW;
  float* scum = reinterpret_cast<float*>(p);

  const int h = blockIdx.x, bc = blockIdx.y;
  const int nc = d.S / d.Q, b = bc / nc, c = bc % nc;
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * d.Q;
  const long bh = static_cast<long>(b) * d.H + h;
  const long xs = static_cast<long>(d.H) * d.P;
  chunk_cum_scan(scum, dt + tok0 * d.H + h, d.H, Av[h], d.Q, sw);
  for (int t = threadIdx.x; t < d.Q; t += MT)
    cum[bh * d.S + static_cast<long>(c) * d.Q + t] = scum[t];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[16][4];
  zero(acc);
  for (int k0 = 0; k0 < d.Q; k0 += BT) {
    __syncthreads();
    load_planes<MAXP, true, 3, SCALE_EXP>(sDy, LDK, dy + tok0 * xs + h * d.P,
                                          xs, k0, d.Q, d.P, scum);
    load_planes<MAXN, false, NP, SCALE_NONE>(sC, LDW, Cm + tok0 * d.N, d.N,
                                             k0, d.Q, d.N);
    __syncthreads();
    warp_mma<16, BT, 3, NP, false>(acc, sDy, LDK, warp * 16, sC, LDW, lane);
  }
  float* out = w + (bh * nc + c) * d.P * d.N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = warp * 16 + lane / 4 + 8 * r;
    if (pr >= d.P) continue;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nb * 8 + 2 * (lane % 4) + e;
        if (n < d.N) out[pr * d.N + n] = acc[nb][2 * r + e];
      }
  }
}

// --- pass: dS_{c-1} = exp(cum_Q,c) dS_c + W_c, in place over w ------------------
//
// One thread per element of a (batch, head)'s [P, N] tile, the chunks in
// reverse, PASS_BATCH chunks' W loaded at once; afterwards w[b, h, c]
// holds the gradient of chunk c's end state.
__global__ void __launch_bounds__(PASS_NT)
ssd_bwd_pass_kernel(const float* __restrict__ cum,
                    const float* __restrict__ dfinal, float* __restrict__ w,
                    Dims d) {
  const long PN = static_cast<long>(d.P) * d.N;
  const long e = static_cast<long>(blockIdx.x) * PASS_NT + threadIdx.x;
  if (e >= PN) return;
  const long bh = blockIdx.y;
  const int nc = d.S / d.Q;
  float carry = dfinal != nullptr ? dfinal[bh * PN + e] : 0.f;
  for (int top = nc - 1; top >= 0; top -= PASS_BATCH) {
    float wv[PASS_BATCH], gv[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int c = top - k;
      wv[k] = c >= 0 ? w[(bh * nc + c) * PN + e] : 0.f;
      gv[k] = c >= 0 ? cum[bh * d.S + static_cast<long>(c) * d.Q + d.Q - 1]
                     : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      const int c = top - k;
      if (c < 0) break;
      w[(bh * nc + c) * PN + e] = carry;
      carry = __fadd_rn(__fmul_rn(expf(gv[k]), carry), wv[k]);
    }
  }
}

// --- chunk: dx, ddt and dA's share of one (batch, chunk, head) -----------------
//
// Works in the transposed orientation, rows j (the source token) and
// columns i >= j (the token that reads it), so that dxdt_j, a sum over i,
// stays in registers while the column tiles i go by; G^T comes from the
// scores kernel, and each tile pair's dG^T = (x_j . dy_i) dt_j L^T goes to
// dgt for the dB / dC kernel. d cum collects its + terms (index i) in drow
// and its - terms (index j) in dcol, each with one owner per entry, in a
// fixed order.
template <typename T>
__global__ void __launch_bounds__(MT, 2)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Av, const T* __restrict__ Bm,
                     const T* __restrict__ Cm,
                     const float* __restrict__ states,
                     const float* __restrict__ dy,
                     const float* __restrict__ cum,
                     const float* __restrict__ gt,
                     const float* __restrict__ dS, T* __restrict__ dx,
                     float* ddt, float* __restrict__ dA_part,
                     float* __restrict__ dgt, Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* p = reinterpret_cast<bf16*>(bsm);
  const Planes sS = planes_at<3>(p, MAXP * LDW);   // dS: [p][n]
  p += 3 * MAXP * LDW;
  const Planes sX = planes_at<NP>(p, BT * LDK);    // x_j: [j][p]
  p += NP * BT * LDK;
  const Planes sW = planes_at<NP>(p, BT * LDW);    // C_i, then B_j: [.][n]
  p += NP * BT * LDW;
  const Planes sD = planes_at<3>(p, BT * LDK);     // dy_i: [i][p]
  p += 3 * BT * LDK;
  float* colp = reinterpret_cast<float*>(p);       // [4][BT] column partials
  float* sred = colp + 4 * BT;                     // [MT]
  float* sdt = sred + MT;                          // [Q] each:
  float* scum = sdt + d.Q;
  float* drow = scum + d.Q;
  float* dcol = drow + d.Q;
  float* sgx = dcol + d.Q;
  float* su = sgx + d.Q;

  const int h = blockIdx.x, bc = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N;
  const int nc = d.S / Q, b = bc / nc, c = bc % nc;
  const int nt = (Q + BT - 1) / BT, qp = nt * BT, npairs = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const float A = Av[h];
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * Q;
  const long bh = static_cast<long>(b) * d.H + h;
  const long PN = static_cast<long>(P) * N;
  const long xs = static_cast<long>(d.H) * P;
  const T* xc = x + tok0 * xs + h * P;
  const float* dyc = dy + tok0 * xs + h * P;
  const float* S0g = states + (bh * nc + c) * PN;
  const float* dSg = dS + (bh * nc + c) * PN;
  const float* gtc = gt + static_cast<long>(bc) * qp * qp;

  for (int t = tid; t < Q; t += MT) {
    sdt[t] = dt[(tok0 + t) * d.H + h];
    scum[t] = cum[bh * d.S + static_cast<long>(c) * Q + t];
    drow[t] = ddt[(tok0 + t) * d.H + h];   // the inter kernel's term
    dcol[t] = sgx[t] = su[t] = 0.f;
  }
  float dot = 0.f;                                 // <S0, dS>, this thread's
  for (long e = tid; e < PN; e += MT) dot += S0g[e] * dSg[e];
  sred[tid] = dot;
  __syncthreads();
  for (int o = MT / 2; o > 0; o >>= 1) {
    if (tid < o) sred[tid] += sred[tid + o];
    __syncthreads();
  }
  const float sdot = sred[0];

  __syncthreads();
  load_planes<MAXN, false, 3, SCALE_NONE>(sS, LDW, dSg, N, 0, P, N);

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * BT;
    __syncthreads();
    load_planes<MAXP, false, NP, SCALE_NONE>(sX, LDK, xc, xs, j0, Q, P);
    load_planes<MAXN, false, NP, SCALE_NONE>(sW, LDW, Bm + tok0 * N, N, j0, Q,
                                             N);
    __syncthreads();
    // the state term: dxdt_j = exp(cum_Q - cum_j) dS B_j, and its share
    // of d cum, u_j = xdt_j . dxdt_j (- at j, + at the chunk's end)
    float acc[8][4];
    zero(acc);
    warp_mma<8, MAXN, NP, 3, true>(acc, sW, LDW, warp * 16, sS, LDW, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + warp * 16 + g + 8 * r;
      const bool ok = j < Q;
      const float eo = ok ? expf(scum[Q - 1] - scum[j]) : 0.f;
      float uu = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pc = nb * 8 + 2 * tq + e;
          acc[nb][2 * r + e] *= eo;
          if (ok && pc < P)
            uu += plane_val<NP>(sX, (j - j0) * LDK + pc) * acc[nb][2 * r + e];
        }
      uu = quad_sum(uu) * (ok ? sdt[j] : 0.f);
      if (tq == 0 && ok) {
        su[j] = uu;
        dcol[j] += uu;
      }
    }

    for (int it = jt; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();
      load_planes<MAXP, false, 3, SCALE_NONE>(sD, LDK, dyc, xs, i0, Q, P);
      __syncthreads();
      float m[8][4];   // x_j . dy_i^T, then G^T L^T
      zero(m);
      warp_mma<8, MAXP, NP, 3, true>(m, sX, LDK, warp * 16, sD, LDK, lane);
      const float* gtile =
          gtc + static_cast<long>(j0 + warp * 16) * qp + i0;
      // this head's dG^T tile, for the dB / dC kernel
      float* dtile = dgt + ((static_cast<long>(bc) * d.H + h) * npairs +
                            it * (it + 1) / 2 + jt) * BT * BT +
                     warp * 16 * BT;
      float rs[2] = {0.f, 0.f}, cs[8][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int jl = g + 8 * r, j = j0 + warp * 16 + jl;
        const float dtj = j < Q ? sdt[j] : 0.f;
        const float cj = j < Q ? scum[j] : 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const float2 gv = *reinterpret_cast<const float2*>(
              gtile + static_cast<long>(jl) * qp + nb * 8 + 2 * tq);
          float dgv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + nb * 8 + 2 * tq + e;
            const bool live = i >= j && i < Q;
            const float L = live ? expf(scum[i] - cj) : 0.f;
            const float G = e ? gv.y : gv.x;
            dgv[e] = m[nb][2 * r + e] * dtj * L;
            const float gd = G * dgv[e];
            rs[r] += gd;
            cs[nb][e] = r == 0 ? gd : cs[nb][e] + gd;
            m[nb][2 * r + e] = G * L;
          }
          *reinterpret_cast<float2*>(dtile + jl * BT + nb * 8 + 2 * tq) =
              make_float2(dgv[0], dgv[1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + warp * 16 + g + 8 * r;
        const float v = quad_sum(rs[r]);
        if (tq == 0 && j < Q) dcol[j] += v;
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = cs[nb][e];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (g == 0) colp[warp * BT + nb * 8 + 2 * tq + e] = v;
        }
      // dxdt_j += (G L)^T_ji dy_i
      warp_mma_regs<8, 3, true>(acc, m, sD, LDK, 0, lane);
      __syncthreads();
      if (tid < BT && i0 + tid < Q)
        drow[i0 + tid] += colp[tid] + colp[BT + tid] + colp[2 * BT + tid] +
                          colp[3 * BT + tid];
    }

    // dx = dxdt dt (two columns a store), and sum_p dxdt x for ddt
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = j0 + warp * 16 + g + 8 * r;
      const bool ok = j < Q;
      const float dtj = ok ? sdt[j] : 0.f;
      float gx = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int pc = nb * 8 + 2 * tq;
        if (!ok || pc >= P) continue;
        const float v0 = acc[nb][2 * r], v1 = acc[nb][2 * r + 1];
        T* o = dx + (tok0 + j) * xs + h * P + pc;
        gx += v0 * plane_val<NP>(sX, (j - j0) * LDK + pc);
        if (pc + 1 < P) {
          gx += v1 * plane_val<NP>(sX, (j - j0) * LDK + pc + 1);
          store2(o, v0 * dtj, v1 * dtj, P % 2 == 0);
        } else {
          o[0] = from_f<T>(v0 * dtj);
        }
      }
      gx = quad_sum(gx);
      if (tq == 0 && ok) sgx[j] = gx;
    }
  }
  __syncthreads();
  // d cum -> its reverse cumsum -> ddt and dA's share, by one warp: each
  // lane a run of consecutive tokens, the runs after it added by a fixed
  // shuffle scan, every sum in a fixed order
  if (warp == 0) {
    const int per = (Q + 31) / 32, lo = min(Q, lane * per),
              hi = min(Q, lo + per);
    float us = 0.f;
    for (int t = lo; t < hi; ++t) us += su[t];
    us = warp_total(us);
    const float tail = us + expf(scum[Q - 1]) * sdot;   // d cum at Q - 1
    float own = 0.f;
    for (int t = hi - 1; t >= lo; --t)
      own += drow[t] - dcol[t] + (t == Q - 1 ? tail : 0.f);
    float after = own;                   // the runs of lanes >= this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(FULL, after, o);
      if (lane + o < 32) after += v;
    }
    float run = __shfl_down_sync(FULL, after, 1);
    if (lane == 31) run = 0.f;
    float dA_acc = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
      run += drow[t] - dcol[t] + (t == Q - 1 ? tail : 0.f);
      ddt[(tok0 + t) * d.H + h] = run * A + sgx[t];
      dA_acc += run * sdt[t];
    }
    dA_acc = warp_total(dA_acc);
    if (lane == 0) dA_part[bh * nc + c] = dA_acc;
  }
}

// the planes' columns from n0 on
__device__ __forceinline__ Planes shifted(const Planes& s, int n0) {
  Planes r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.p[k] = s.p[k] != nullptr ? s.p[k] + n0 : nullptr;
  return r;
}

// rows r0.. (the warp's 16) and columns n0..n0+8NB-1 of a [rows][N] f32
// array: out = (add ? out : 0) + t, within Q rows and N columns; a pair
// of columns at a time where N is even, every old value loaded before
// any is stored
template <int NB>
__device__ __forceinline__ void rmw_rows(float* out, int r0, int n0, int Q,
                                         int N, bool add,
                                         const float (&t)[NB][4], int lane) {
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + lane / 4 + 8 * r;
    if (row >= Q) continue;
    float* o = out + static_cast<long>(row) * N + n0 + 2 * (lane % 4);
    float2 old[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = n0 + nb * 8 + 2 * (lane % 4);
      old[nb] = make_float2(0.f, 0.f);
      if (add && pairs && n < N)
        old[nb] = *reinterpret_cast<const float2*>(o + nb * 8);
      else if (add) {
        if (n < N) old[nb].x = o[nb * 8];
        if (n + 1 < N) old[nb].y = o[nb * 8 + 1];
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = n0 + nb * 8 + 2 * (lane % 4);
      const float2 v = make_float2(old[nb].x + t[nb][2 * r],
                                   old[nb].y + t[nb][2 * r + 1]);
      if (pairs && n < N) {
        *reinterpret_cast<float2*>(o + nb * 8) = v;
      } else {
        if (n < N) o[nb * 8] = v.x;
        if (n + 1 < N) o[nb * 8 + 1] = v.y;
      }
    }
  }
}

// --- inter: dC's inter-chunk term and d cum's, per head group -----------------
//
// dC_i += sum_h exp(cum_i) (dy_i . S0^h) and, per head, d cum_i's
// inter-chunk term exp(cum_i) C_i . (dy_i . S0^h): the same chain of
// MMAs gives both, so one owner per (batch, chunk, group of HG heads)
// computes it once for each head and tile, folds it into the group's dC
// rows (written first: the dbc kernel adds the in-chunk term to them) and
// dots it with C_i. The d cum term goes to ddt's positions [B, S, H],
// which the chunk kernel of the same (batch, chunk, head) reads before it
// writes ddt there.
template <typename T>
__global__ void __launch_bounds__(MT)
ssd_bwd_inter_kernel(const T* __restrict__ Cm, const float* __restrict__ states,
                     const float* __restrict__ dy,
                     const float* __restrict__ cum, float* __restrict__ dinter,
                     float* __restrict__ dC_part, Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* p = reinterpret_cast<bf16*>(bsm);
  const Planes sD = planes_at<3>(p, BT * LDK);     // dy_i: [i][p]
  p += 3 * BT * LDK;
  const Planes sC = planes_at<NP>(p, BT * LDW);    // C_i: [i][n]
  p += NP * BT * LDW;
  const Planes sS = planes_at<3>(p, MAXP * LDW);   // S0: [p][n]

  const int gi = blockIdx.x, bc = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N;
  const int nc = d.S / Q, b = bc / nc, c = bc % nc;
  const int ng = (d.H + HG - 1) / HG, h0 = gi * HG, nh = min(HG, d.H - h0);
  const int nt = (Q + BT - 1) / BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * Q;
  const long PN = static_cast<long>(P) * N;
  const long xs = static_cast<long>(d.H) * P;
  float* dCg = dC_part + ((static_cast<long>(b) * ng + gi) * d.S +
                          static_cast<long>(c) * Q) * N;

  for (int it = 0; it < nt; ++it) {
    const int i0 = it * BT;
    float t[16][4];
    zero(t);
    for (int k = 0; k < nh; ++k) {
      const int h = h0 + k;
      const long bh = static_cast<long>(b) * d.H + h;
      float sc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + warp * 16 + g + 8 * r;
        sc[r] = i < Q ? expf(__ldg(cum + bh * d.S + static_cast<long>(c) * Q +
                                   i))
                      : 0.f;
      }
      __syncthreads();
      if (k == 0)
        load_planes<MAXN, false, NP, SCALE_NONE>(sC, LDW, Cm + tok0 * N, N,
                                                 i0, Q, N);
      load_planes<MAXP, false, 3, SCALE_NONE>(sD, LDK, dy + tok0 * xs + h * P,
                                              xs, i0, Q, P);
      load_planes<MAXN, false, 3, SCALE_NONE>(
          sS, LDW, states + (bh * nc + c) * PN, N, 0, P, N);
      __syncthreads();
      float ch[16][4];   // dy_i . S0: the warp's 16 rows, every column n
      zero(ch);
      warp_mma<16, MAXP, 3, 3, false>(ch, sD, LDK, warp * 16, sS, LDW, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int il = warp * 16 + g + 8 * r;
        float v = 0.f;
#pragma unroll
        for (int nb = 0; nb < 16; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nb * 8 + 2 * tq + e;
            if (n < N) v += plane_val<NP>(sC, il * LDW + n) * ch[nb][2 * r + e];
          }
        v = quad_sum(v);
        if (tq == 0 && i0 + il < Q)
          dinter[(tok0 + i0 + il) * d.H + h] = v * sc[r];
      }
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) add_to(t[nb], ch[nb], sc[0], sc[1]);
    }
    rmw_rows(dCg, i0 + warp * 16, 0, Q, N, false, t, lane);
  }
}

// --- dbc: one head group's dB and dC for a (batch, chunk) -------------------------
//
// dB_j = sum_i dGs^T_ji C_i + sum_h exp(cum_Q - cum_j) dt_j (x_j . dS^h)
// dC_i += sum_j dGs_ij B_j   (onto the inter kernel's term)
// with dGs = sum over the group's heads, in order, of (dy_i . x_j) dt_j L_ij
// (each head's tile written by the chunk kernel): one owner per (batch,
// chunk, group), which writes dB_part / dC_part [B, n_groups, S, N] f32
// for the wrapper's fixed-order sum over groups. The head loop is
// innermost, so dGs of a tile pair stays in registers and meets B and C
// once; dB_j stays in registers over the pairs, dC_i is added to its rows
// of dC_part pair by pair. The state term's per-token factor scales the
// rows of each head's chain before it is folded in.
template <typename T>
__global__ void __launch_bounds__(MT)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const float* __restrict__ cum,
                   const float* __restrict__ dS,
                   const float* __restrict__ dgt, float* __restrict__ dB_part,
                   float* __restrict__ dC_part, Dims d) {
  constexpr int NP = Elem<T>::planes;
  extern __shared__ __align__(16) unsigned char bsm[];
  bf16* p = reinterpret_cast<bf16*>(bsm);
  const Planes sX = planes_at<NP>(p, BT * LDK);    // x_j: [j][p]
  p += NP * BT * LDK;
  const Planes sB = planes_at<NP>(p, BT * LDW);    // B_j: [j][n]
  p += NP * BT * LDW;
  // one region for either C_i and dGs ([i][n], [i][j]) or a state [p][n]
  const Planes sC = planes_at<NP>(p, BT * LDW);
  const Planes sG = planes_at<3>(p + NP * BT * LDW, BT * LDK);
  const Planes sS = planes_at<3>(p, MAXP * LDW);

  const int gi = blockIdx.x, bc = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N;
  const int nc = d.S / Q, b = bc / nc, c = bc % nc;
  const int ng = (d.H + HG - 1) / HG, h0 = gi * HG, nh = min(HG, d.H - h0);
  const int nt = (Q + BT - 1) / BT, npairs = nt * (nt + 1) / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const long tok0 = static_cast<long>(b) * d.S + static_cast<long>(c) * Q;
  const long PN = static_cast<long>(P) * N;
  const long xs = static_cast<long>(d.H) * P;
  const T* Bc = Bm + tok0 * N;
  const T* Cc = Cm + tok0 * N;
  const long grow = ((static_cast<long>(b) * ng + gi) * d.S +
                     static_cast<long>(c) * Q) * N;
  float* dBg = dB_part + grow;
  float* dCg = dC_part + grow;
  // head k's cum and dt at token t
  auto hcum = [&](int k, int t) {
    return __ldg(cum + (static_cast<long>(b) * d.H + h0 + k) * d.S +
                 static_cast<long>(c) * Q + t);
  };
  auto hdt = [&](int k, int t) { return __ldg(dt + (tok0 + t) * d.H + h0 + k); };

  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * BT;
    __syncthreads();
    load_planes<MAXN, false, NP, SCALE_NONE>(sB, LDW, Bc, N, j0, Q, N);
    float db[16][4];
    zero(db);
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * BT;
      __syncthreads();
      load_planes<MAXN, false, NP, SCALE_NONE>(sC, LDW, Cc, N, i0, Q, N);
      // dGs: the group's heads' dG^T tiles (from the chunk kernel), in
      // head order
      float dg[8][4];
      zero(dg);
      const float* dsrc = dgt + (static_cast<long>(bc) * d.H + h0) * npairs *
                                    BT * BT +
                          static_cast<long>(it * (it + 1) / 2 + jt) * BT * BT +
                          warp * 16 * BT;
      for (int k = 0; k < nh; ++k) {
        const float* tk = dsrc + static_cast<long>(k) * npairs * BT * BT;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const float2 v = *reinterpret_cast<const float2*>(
                tk + (g + 8 * r) * BT + nb * 8 + 2 * tq);
            dg[nb][2 * r] += v.x;
            dg[nb][2 * r + 1] += v.y;
          }
      }
      __syncthreads();   // C_i is in shared memory
      // dB_j += dGs^T_ji C_i
      warp_mma_regs<16, NP, false>(db, dg, sC, LDW, 0, lane);
      // dC_i += dGs_ij B_j: dGs through shared memory, transposed
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int jl = warp * 16 + g + 8 * r, il = nb * 8 + 2 * tq;
          put2<3, true>(sG, il * LDK + jl, LDK, dg[nb][2 * r],
                        dg[nb][2 * r + 1]);
        }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float t[8][4];
        zero(t);
        warp_mma<8, BT, 3, NP, false>(t, sG, LDK, warp * 16,
                                      shifted(sB, 64 * half), LDW, lane);
        rmw_rows(dCg, i0 + warp * 16, 64 * half, Q, N, true, t, lane);
      }
    }
    // the state term of dB_j, head by head
    for (int k = 0; k < nh; ++k) {
      const int h = h0 + k;
      const long bh = static_cast<long>(b) * d.H + h;
      float sc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = j0 + warp * 16 + g + 8 * r;
        sc[r] = j < Q ? expf(hcum(k, Q - 1) - hcum(k, j)) * hdt(k, j) : 0.f;
      }
      __syncthreads();
      load_planes<MAXP, false, NP, SCALE_NONE>(sX, LDK, x + tok0 * xs + h * P,
                                               xs, j0, Q, P);
      load_planes<MAXN, false, 3, SCALE_NONE>(sS, LDW, dS + (bh * nc + c) * PN,
                                              N, 0, P, N);
      __syncthreads();
      warp_mma<16, MAXP, NP, 3, false>(db, sX, LDK, warp * 16, sS, LDW,
                                       lane, sc[0], sc[1]);
    }
    rmw_rows(dBg, j0 + warp * 16, 0, Q, N, false, db, lane);
  }

}

size_t fwd_state_smem(int Q, int np) {
  return 64 + sizeof(bf16) * (3 * BT * LDK + np * BT * LDW) +
         sizeof(float) * 2 * Q;
}

size_t fwd_out_smem(int Q, int np) {
  return sizeof(bf16) * (3 * MAXP * LDW + np * BT * LDW + np * BT * LDK) +
         sizeof(float) * (BT * LDG + 3 * Q);
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
int launch_fwd(const void* xv, const float* dt, const float* A,
               const void* Bv, const void* Cv, const float* init, float* y,
               float* fin, float* states, float* cum, float* gt,
               const Dims& d, cudaStream_t st) {
  const int np = Elem<T>::planes;
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  const int nc = d.S / d.Q, nt = (d.Q + BT - 1) / BT;
  const unsigned bnc = static_cast<unsigned>(d.B * nc);
  const size_t s0 = sizeof(bf16) * 2 * np * BT * LDW;
  const size_t s1 = fwd_state_smem(d.Q, np), s3 = fwd_out_smem(d.Q, np);
  if (int e = prepare(ssd_scores_kernel<T>, s0)) return e;
  if (int e = prepare(ssd_fwd_state_kernel<T>, s1)) return e;
  if (int e = prepare(ssd_fwd_out_kernel<T>, s3)) return e;
  ssd_scores_kernel<T><<<dim3(nt * (nt + 1) / 2, bnc), MT, s0, st>>>(
      Bm, Cm, gt, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_fwd_state_kernel<T><<<dim3(d.H, bnc), MT, s1, st>>>(x, dt, A, Bm, cum,
                                                           states, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  const unsigned pn = static_cast<unsigned>(
      (static_cast<long>(d.P) * d.N + PASS_NT - 1) / PASS_NT);
  ssd_fwd_pass_kernel<<<dim3(pn, d.B * d.H), PASS_NT, 0, st>>>(cum, init,
                                                               states, fin, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_fwd_out_kernel<T><<<dim3(d.H, bnc), MT, s3, st>>>(x, dt, Cm, cum, gt,
                                                         states, y, d);
  return static_cast<int>(cudaGetLastError());
}

size_t w_smem(int Q, int np) {
  return 64 + sizeof(bf16) * (3 * MAXP * LDK + np * BT * LDW) +
         sizeof(float) * Q;
}

size_t chunk_smem(int Q, int np) {
  return sizeof(bf16) * (3 * MAXP * LDW + np * BT * LDK + np * BT * LDW +
                         3 * BT * LDK) +
         sizeof(float) * (4 * BT + MT + 6 * Q);
}

size_t inter_smem(int np) {
  return sizeof(bf16) * (3 * BT * LDK + np * BT * LDW + 3 * MAXP * LDW);
}

size_t dbc_smem(int np) {
  const int region = std::max(np * BT * LDW + 3 * BT * LDK, 3 * MAXP * LDW);
  return sizeof(bf16) * (np * BT * LDK + np * BT * LDW + region);
}

template <typename T>
int launch_bwd(const void* xv, const float* dt, const float* A,
               const void* Bv, const void* Cv, const float* states,
               const float* dy, const float* dfinal, void* dxv, float* ddt,
               float* dA_part, float* dB_part, float* dC_part, float* cum,
               float* gt, float* w, float* dg, const Dims& d,
               cudaStream_t st) {
  const int np = Elem<T>::planes;
  const T* x = static_cast<const T*>(xv);
  const T* Bm = static_cast<const T*>(Bv);
  const T* Cm = static_cast<const T*>(Cv);
  const int nc = d.S / d.Q, nt = (d.Q + BT - 1) / BT;
  const int ng = (d.H + HG - 1) / HG;
  const unsigned bnc = static_cast<unsigned>(d.B * nc);
  const size_t s0 = sizeof(bf16) * 2 * np * BT * LDW;
  const size_t s1 = w_smem(d.Q, np), s2 = inter_smem(np),
               s3 = chunk_smem(d.Q, np),
               s4 = dbc_smem(np);
  if (int e = prepare(ssd_scores_kernel<T>, s0)) return e;
  if (int e = prepare(ssd_bwd_w_kernel<T>, s1)) return e;
  if (int e = prepare(ssd_bwd_inter_kernel<T>, s2)) return e;
  if (int e = prepare(ssd_bwd_chunk_kernel<T>, s3)) return e;
  if (int e = prepare(ssd_bwd_dbc_kernel<T>, s4)) return e;
  ssd_scores_kernel<T><<<dim3(nt * (nt + 1) / 2, bnc), MT, s0, st>>>(
      Bm, Cm, gt, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_bwd_w_kernel<T><<<dim3(d.H, bnc), MT, s1, st>>>(dt, A, Cm, dy, cum, w,
                                                       d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  const unsigned pn = static_cast<unsigned>(
      (static_cast<long>(d.P) * d.N + PASS_NT - 1) / PASS_NT);
  ssd_bwd_pass_kernel<<<dim3(pn, d.B * d.H), PASS_NT, 0, st>>>(cum, dfinal,
                                                               w, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_bwd_inter_kernel<T><<<dim3(ng, bnc), MT, s2, st>>>(Cm, states, dy, cum,
                                                          ddt, dC_part, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_bwd_chunk_kernel<T><<<dim3(d.H, bnc), MT, s3, st>>>(
      x, dt, A, Bm, Cm, states, dy, cum, gt, w, static_cast<T*>(dxv), ddt,
      dA_part, dg, d);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  ssd_bwd_dbc_kernel<T><<<dim3(ng, bnc), MT, s4, st>>>(
      x, dt, Bm, Cm, cum, w, dg, dB_part, dC_part, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype 0 = float32, 1 = bfloat16 (x, Bm, Cm); init may be null (a zero
// state). Scratch, all f32 and allocated by the caller: cum [B, H, S]; gt
// [B, nc, qp, qp] with qp = Q rounded up to a multiple of 64. states [B,
// H, nc, P, N] is written in any case (the pass needs it).
int ssd_fwd(int dtype, const void* x, const void* dt, const void* A,
            const void* Bm, const void* Cm, const void* init, void* y,
            void* final_state, void* states, void* cum, void* gt, int B,
            int S, int H, int P, int N, int Q, void* stream) {
  const Dims d{B, S, H, P, N, Q};
  if (B == 0 || H == 0 || S == 0) return 0;
  if (!dims_ok(d) || states == nullptr || cum == nullptr || gt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_A = static_cast<const float*>(A);
  const float* f_init = static_cast<const float*>(init);
  float* f_y = static_cast<float*>(y);
  float* f_fin = static_cast<float*>(final_state);
  float* f_st = static_cast<float*>(states);
  float* f_cum = static_cast<float*>(cum);
  float* f_gt = static_cast<float*>(gt);
  if (dtype == 0)
    return launch_fwd<float>(x, f_dt, f_A, Bm, Cm, f_init, f_y, f_fin, f_st,
                             f_cum, f_gt, d, st);
  if (dtype == 1)
    return launch_fwd<bf16>(x, f_dt, f_A, Bm, Cm, f_init, f_y, f_fin, f_st,
                            f_cum, f_gt, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dfinal may be null (a zero gradient of the final state). Scratch, all
// f32 and allocated by the caller: cum [B, H, S]; gt [B, nc, qp, qp] with
// qp = Q rounded up to a multiple of 64; w [B, H, nc, P, N]; dg [B, nc, H,
// nt (nt + 1) / 2, 64, 64] with nt = qp / 64. Outputs:
// dx (x's dtype), ddt [B, S, H], dA_part [B, H, nc], dB_part and dC_part
// [B, ceil(H / 8), S, N], the partials summed by the caller.
int ssd_bwd(int dtype, const void* x, const void* dt, const void* A,
            const void* Bm, const void* Cm, const void* states,
            const void* dy, const void* dfinal, void* dx, void* ddt,
            void* dA_part, void* dB_part, void* dC_part, void* cum, void* gt,
            void* w, void* dg, int B, int S, int H, int P, int N, int Q,
            void* stream) {
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
  float* f_cum = static_cast<float*>(cum);
  float* f_gt = static_cast<float*>(gt);
  float* f_w = static_cast<float*>(w);
  float* f_dg = static_cast<float*>(dg);
  if (dtype == 0)
    return launch_bwd<float>(x, f_dt, f_A, Bm, Cm, f_st, f_dy, f_df, dx,
                             f_ddt, f_dA, f_dB, f_dC, f_cum, f_gt, f_w, f_dg,
                             d, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, f_dt, f_A, Bm, Cm, f_st, f_dy, f_df,
                                     dx, f_ddt, f_dA, f_dB, f_dC, f_cum, f_gt,
                                     f_w, f_dg, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
