// Flash attention at head dim 256 in bfloat16 for Hopper (sm_90a): the
// forward with its row log-sum-exp, and the backward as two kernels, dq
// and dk/dv, plus the fixed-order sum of dk/dv's partials. The head dim
// of recurrentgemma-9b's local attention (16 query heads over one kv
// head, window 2,048).
//
// Replaces, at head dim 256, the Pallas TPU kernels of the JAX package:
//   wg_fwd_kernel  <- repro/kernels/flash_attention/kernel.py:86
//                     flash_attention_fwd (body _flash_kernel)
//   wg_dq_kernel   <- repro/kernels/flash_attention/backward.py:130
//                     flash_attention_bwd, call :161 (_dq_kernel)
//   wg_dkv_kernel  <- the same function's call :185 (_dkv_kernel)
// The other head dims and float32 stay in flash_attention.cu; the plain
// PyTorch versions of all three are in
// repro_torch/kernels/flash_attention/ops.py.
//
// Layouts, masks and numerics are flash_attention.cu's: q, out, dout
// [B, H, Sq, 256]; k, v [B, Hkv, Skv, 256]; lse and delta f32 [B, H, Sq];
// head h reads kv head h / (H/Hkv); key kp is seen by query qp iff
// kp < Skv, (causal) kp <= qp, (window > 0) qp - kp < window; masked
// scores are -1e30; scores in log2 units (exp2); lse = m ln2 + log(max(l,
// 1e-30)); tiles wholly outside the causal limit or the window are
// skipped (tile_live); the longest blocks are launched first.
//
// What bounds them on an H100: at recurrentgemma-9b's training shape (q
// [2,16,4096,256], k/v [2,1,4096,256], causal, window 2,048: 201.3 M seen
// pairs) the forward does 2 products of 103 GFLOP, dq 3 and dk/dv 4,
// against ~140 MB of tensors: arithmetic bounds them, 989 TFLOP/s in bf16
// on the tensor cores, 0.2085 / 0.3128 / 0.4170 ms. P and dS go to the
// tensor cores as two bf16 terms (below), so the floor of a design with
// that split is 1.5x the forward's products (0.313 ms), 4/3 x dq's
// (0.417 ms) and 6/4 x dk/dv's (0.625 ms); this one gives P three terms
// in dV, 7/4 x dk/dv's (0.730 ms).
//
// Design. Every block is three warpgroups: two consumers of 128 threads
// and one producer. Each warpgroup multiplies on the tensor cores with
// wgmma (64 rows a warpgroup, f32 accumulators in registers); one thread
// of the producer keeps TMA copies in flight into a two-stage ring of
// shared memory, each stage's arrival signalled by an mbarrier and its
// release by the consumers' warps on another. Tiles are 64 rows by the
// whole head dim; a TMA box is 64 rows x 64 columns (128 bytes, the
// 128-byte swizzle's span), four boxes across the head dim, so the wgmma
// descriptors read K-major tiles (rows of 128 bytes, 8-row groups 1 KB
// apart) and MN-major ones (the same boxes read down their rows: V, K,
// Q, dout as the B of a product over keys or queries) without any copy.
// The tensor maps are 3-D over [B x heads, rows, 256]: rows past Sq or
// Skv are zero-filled by the copy, never read from the next head. No
// block owns part of the head dim, so no score is computed twice.
//
//   forward: a block owns 128 query rows of one head, 64 a consumer, and
//     the two read each K/V tile together (one head's 128 rows rather
//     than the same 64 rows of two heads of the group: it takes every
//     GQA group, a group of 1 too, and costs one consumer an idle tile at
//     the edges of the causal limit and the window). S = Q.K^T by 16
//     wgmma m64n64k16 from shared memory; online softmax in registers;
//     O = O corr + P.V with P's hi and lo terms as register A operands,
//     V MN-major, 64 output columns at a time from fresh accumulators
//     (the rescale folded into the add). O is 64 x 256 f32: 128
//     registers a consumer thread.
//   dq: a block owns 64 query rows. Consumer 0 computes S and P, consumer
//     1 dP = dout.V^T, each product once; they swap P and dP through
//     shared memory (f32, in accumulator order) and each forms dS; each
//     then owns 128 of dQ's 256 columns, dQ += dS.K with K MN-major.
//   dk/dv: a block owns 64 kv rows, K and V resident, Q and dout tiles
//     through the ring. Consumer 0 computes S^T = K.Q^T and P^T and owns
//     all of dV (+= P^T.dout, P^T's third term read back from shared
//     memory); consumer 1 computes dP^T = V.dout^T, takes
//     P^T through shared memory, forms dS^T and owns all of dK (+= dS^T.Q):
//     each product once, half the products' work to each consumer, one
//     exchange a tile (rather than the two-way exchange and column halves
//     of dK and dV a consumer, which hold the same 128 accumulators and
//     need a second exchange). Each GQA group is split over `nsplit`
//     blocks writing f32 partials, summed in split order by
//     wg_dkv_sum_kernel. A block walks its heads in the outer loop and
//     the live q tiles in the inner one, so the blocks of neighbouring kv
//     tiles that run together read the same Q and dout tiles a few
//     iterations apart, from L2 (a head-fastest order, whose running
//     blocks read four heads' tiles each, was slower).
//
// Occupancy, registers, shared memory. One block an SM: 384 threads;
// setmaxnreg gives each consumer thread 240 registers and the producer 24
// (2 x 128 x 240 + 128 x 24 = 64,512 of the SM's 65,536: the 168 each
// thread has at launch, moved). The forward holds O (128 accumulators),
// a tile's hi/lo operands (32) and a fresh chain (32); dk/dv the same
// with dV or dK; dq 64 of dQ. While one consumer runs softmax or forms
// dS, the other's wgmmas keep the tensor cores busy. Masks are applied
// only to tiles the causal limit, the window or a ragged edge cuts, as
// selects (a short-circuit per element compiled to branches that
// dominated the softmax); exponentials are ex2.approx.ftz.
// Shared memory (bytes, each plan stated
// below as *_SMEM_BYTES, checked by static_assert and mirrored in ops.py):
// forward Q 64 K + 2 stages x (K 32 K + V 32 K) = 192 KiB; dq Q and dout
// 64 K + 2 x (K + V) 128 K + the P and dP exchange 32 K = 224 KiB; dk/dv
// K and V 64 K + 2 x (Q + dout) 128 K + P^T 16 K + its third term 8 K =
// 216 KiB; plus the mbarriers and 1 KiB to align the swizzled tiles,
// within the 232,448 a block can have.
//
// ptxas (CUDA 12.9, sm_90a, -O3), from chip_smoke.py's build log: each
// kernel 168 registers at launch (__launch_bounds__(384, 1)), consumers
// up to 240 after setmaxnreg; wg_fwd_kernel spills 496 bytes and
// wg_dkv_kernel 480 (~35 of the 128 accumulators a consumer thread keeps
// live in local memory, loaded and stored once a tile), wg_dq_kernel 40,
// wg_dkv_sum_kernel 32 registers and none; shared memory as the plans
// below, dynamic. 32-column chains (16 registers) spill less but run no
// faster; a 288-thread block (one producer warp) cannot give the
// consumers 248, since setmaxnreg.inc draws only on what the producer
// releases from the 168 a thread gets at launch.
//
// Numerics, as flash_attention.cu. P and dS are f32 and enter the tensor
// cores as hi = bf16(x) and lo = bf16(x - hi), two products into one f32
// sum (a residual of 2^-16 of x instead of bf16's 2^-8), which is what
// holds these kernels to the plain versions' f32 P within the checks'
// atol of 1e-5. dV is the exception: it sums P.dout, unscaled, over
// every query and head a kv row sees (4,800 terms at the window's first
// rows with 16 heads and window 300, P up to 0.8), and two terms' random
// residuals put one element of a small dv two bf16 ulps from the plain
// version, past the check (as they did with flash_attention.cu's column
// halves, on the same inputs); so P^T gets a third term, bf16(x - hi -
// lo), a residual of 2^-24, which consumer 0 writes to a swizzled tile
// and reads back as a shared-memory A operand, keeping its registers.
// dS carries the softmax scale (1/16 at this head dim) and the forward
// divides by l, so their two-term residuals stay well inside the
// checks. Every chain of wgmmas that accumulates over keys or
// queries starts from zero accumulators (scale-d 0), covers one 64-row
// tile, and is added into the running sum in f32: the tensor cores' own
// accumulation drifted 2-4 bf16 ulps over long chains on this card. S and
// dP sum the 256 products of one element in one chain, as before. No
// atomics: a second call gives the same bits.
//
// Every entry point builds its tensor maps on the host
// (cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint[ByVersion]: no -lcuda), launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() right after its launches (0 = cudaSuccess), or
// ENCODE_ERROR if a map could not be built.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 256;            // the head dim
constexpr int BR = 64;             // rows of a tile (a warpgroup's M)
constexpr int BOX_COLS = 64;       // columns of a TMA box: 128 bytes
constexpr int BOX_BYTES = BR * BOX_COLS * 2;    // 8,192
constexpr int NBOX = HD / BOX_COLS;             // 4 boxes across hd
constexpr int TILE_BYTES = NBOX * BOX_BYTES;    // 32,768: 64 x 256 bf16
constexpr int STAGES = 2;          // the ring's depth
constexpr int THREADS = 384;       // two consumer warpgroups, a producer
constexpr int XCHG_BYTES = BR * BR * 4;         // a 64 x 64 f32 tile
constexpr int ALIGN = 1024;        // the 128-byte swizzle's period
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr int ENCODE_ERROR = 100001;            // a tensor map failed
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// named barriers (0 is __syncthreads): the exchange, and "my exchange
// buffer may be written again" for each consumer
constexpr int BAR_XCHG = 1;
constexpr int BAR_FREE = 2;        // + the writing consumer's index
constexpr int BAR_WG0 = 4;         // consumer 0's 128 threads alone

// --- shared-memory plans: byte offsets from a 1,024-aligned base ------------
// forward: Q (two tiles: consumer 0's rows, consumer 1's) | K ring | V
// ring | mbarriers [Q, K x STAGES, V x STAGES, empty x STAGES]
constexpr int FWD_Q = 0;
constexpr int FWD_K = FWD_Q + 2 * TILE_BYTES;
constexpr int FWD_V = FWD_K + STAGES * TILE_BYTES;
constexpr int FWD_BAR = FWD_V + STAGES * TILE_BYTES;
constexpr int FWD_NBAR = 1 + 3 * STAGES;
constexpr int FWD_SMEM_BYTES = 197688;
static_assert(FWD_SMEM_BYTES == FWD_BAR + 8 * FWD_NBAR + ALIGN, "plan");

// dq: Q | dout | ring of (K, V) | P (consumer 0's) | dP (consumer 1's) |
// mbarriers [Q and dout, K/V x STAGES, empty x STAGES]
constexpr int DQ_Q = 0;
constexpr int DQ_O = DQ_Q + TILE_BYTES;
constexpr int DQ_RING = DQ_O + TILE_BYTES;      // stage s: K, then V
constexpr int DQ_X = DQ_RING + STAGES * 2 * TILE_BYTES;
constexpr int DQ_BAR = DQ_X + 2 * XCHG_BYTES;
constexpr int DQ_NBAR = 1 + 2 * STAGES;
constexpr int DQ_SMEM_BYTES = 230440;
static_assert(DQ_SMEM_BYTES == DQ_BAR + 8 * DQ_NBAR + ALIGN, "plan");

// dk/dv: K | V | ring of (Q, dout) | P^T (f32) | P^T's third bf16 term
// (a swizzled 64 x 64 A tile) | mbarriers [K and V, Q/dout x STAGES,
// empty x STAGES]
constexpr int DKV_K = 0;
constexpr int DKV_V = DKV_K + TILE_BYTES;
constexpr int DKV_RING = DKV_V + TILE_BYTES;    // stage s: Q, then dout
constexpr int DKV_X = DKV_RING + STAGES * 2 * TILE_BYTES;
constexpr int DKV_P3 = DKV_X + XCHG_BYTES;
constexpr int DKV_BAR = DKV_P3 + BOX_BYTES;
constexpr int DKV_NBAR = 1 + 2 * STAGES;
constexpr int DKV_SMEM_BYTES = 222248;
static_assert(DKV_SMEM_BYTES == DKV_BAR + 8 * DKV_NBAR + ALIGN, "plan");

constexpr int SMEM_LIMIT = 232448;  // a block's most on an H100
static_assert(FWD_SMEM_BYTES <= SMEM_LIMIT && DQ_SMEM_BYTES <= SMEM_LIMIT &&
                  DKV_SMEM_BYTES <= SMEM_LIMIT,
              "a plan exceeds a block's shared memory");
static_assert(2 * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536,
              "setmaxnreg asks for more registers than an SM has");

// --- masks (flash_attention.cu's) -------------------------------------------

__device__ __forceinline__ bool tile_live(int i, int j, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = live && (j * BR <= i * BR + BR - 1);
  if (window > 0) live = live && (i * BR - (j * BR + BR - 1) < window);
  return live;
}

__device__ __forceinline__ bool tile_full(int i, int j, int sq, int skv,
                                          int causal, int window) {
  bool full = (j + 1) * BR <= skv && (i + 1) * BR <= sq;
  if (causal) full = full && (j * BR + BR - 1 <= i * BR);
  if (window > 0) full = full && (i * BR + BR - 1 - j * BR < window);
  return full;
}

// without short-circuits, so a tile's masks compile to selects, not
// branches
__device__ __forceinline__ bool seen(int qp, int kp, int skv, int causal,
                                     int window) {
  return (kp < skv) & (!causal | (kp <= qp)) &
         ((window <= 0) | (qp - kp < window));
}

template <typename F>
__device__ __forceinline__ void live_range(int n, F live, int& lo, int& hi) {
  lo = 0;
  while (lo < n && !live(lo)) ++lo;
  hi = lo;
  while (hi < n && live(hi)) ++hi;
}

// --- PTX: mbarriers, TMA, wgmma, named barriers -----------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of `parity` to complete. A wait that spins past
// 2^26 polls (over a second; a tile takes microseconds) traps, so a lost
// copy ends the kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// one box of a 3-D tensor map (column c0, row c1, head c2) -> shared
// memory, completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a 64-row tile's four boxes (64 rows from `row` of head `head`)
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < NBOX; ++c)
    tma_load(dst + c * BOX_BYTES, map, bar, c * BOX_COLS, row, head);
}

__device__ __forceinline__ void named_sync(int id, int threads = 256) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 at bit
// 62), start address >> 4 in bits 0-13, leading byte offset >> 4 in
// 16-29, stride byte offset >> 4 in 32-45. Tiles start 1,024-aligned.
// Shared addresses stay below 2^18, so an offset within a tile is added
// to a descriptor as (bytes >> 4) without carrying out of bits 0-13.
//
// K-major: rows of 128 bytes (64 bf16 of the K dimension), 8-row groups
// 1,024 bytes apart; a k16 step is 32 bytes further along the row.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// MN-major: rows of the K dimension, each 64 consecutive N (128 bytes),
// 8 K rows 1,024 bytes apart; 64-column blocks of N one box apart; a k16
// step is 16 rows (2,048 bytes) further down.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BOX_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// 2^x on the SFU; subnormal results flush to zero, 2^-inf = 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from touching accumulators before wgmma_wait_all
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

#define WG_NEW32(d)                                                        \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),  \
      "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]),         \
      "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),     \
      "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),     \
      "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),     \
      "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),     \
      "=f"(d[31])

// d (+)= A.B for a 64 x 16 A and a 16 x 64 B, both K-major in shared
// memory. acc is a constant after unrolling: 0 starts a chain (scale-d
// false), and d is then written only, so the compiler keeps no earlier
// value of it alive.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  if (acc)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT32(d)
        : "l"(a), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_NEW32(d)
        : "l"(a), "l"(b), "r"(0));
}

// d += A.B for a 64 x 16 A K-major and a 16 x 64 B MN-major, both in
// shared memory (a chain's later step only)
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (+)= A.B for a 64 x 16 A in registers (the m64k16 fragment: a warp's
// 16 rows as mma.sync's m16k16 A) and a 16 x 64 B MN-major in shared
// memory; acc as wgmma_ss
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  if (acc)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_NEW32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- fragments --------------------------------------------------------------
//
// A 64 x 64 f32 accumulator d[32] of consumer thread (warp w, lane 4g + t)
// holds rows 16w + g (d[4n], d[4n + 1]) and 16w + g + 8 (d[4n + 2],
// d[4n + 3]), columns 8n + 2t and 8n + 2t + 1, n = 0..7. Its columns
// 16k..16k+15 (d[8k .. 8k + 7]) are the register A fragment of a k16
// step over those columns.

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator's 4 k16 steps as A fragments of bf16 terms whose sum
// is x: a[0] = bf16(x), a[1] = bf16(x - a[0]) (the differences exact in
// f32), a residual of 2^-16 |x|. With a tile address `t3` (a warp's
// thread holding rows 16w + g and + 8), the third term bf16(x - a[0] -
// a[1]), a residual of 2^-24 |x|, goes to that 64 x 64 bf16 tile in
// the 128-byte-swizzled K-major layout of an A operand.
__device__ __forceinline__ void split_a(const float (&d)[32],
                                        uint32_t (&a)[2][4][4],
                                        unsigned char* t3 = nullptr,
                                        int row0 = 0, int t = 0) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float x0 = d[8 * k + 2 * r], x1 = d[8 * k + 2 * r + 1];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        a[n][k][r] = bf16x2_bits(h);
        x0 -= hf.x;
        x1 -= hf.y;
      }
      if (t3) {  // row, and the 16-byte chunk (8 columns) of the pair
        const int row = row0 + 8 * (r & 1), chunk = 2 * k + (r >> 1);
        *reinterpret_cast<__nv_bfloat162*>(
            t3 + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
}

// d = A.B over one 64-row tile of the K dimension, A as its hi and lo
// terms (8 wgmmas from zero) and, given its tile's address a3, the third
// term (4 more, A from shared memory), B the 64 columns of an MN-major
// tile at `b`; then acc += d in f32 (the short chain, see the header),
// or with SCALED acc = acc * c[row] + d, c0 for a thread's first row,
// c1 for its second
template <bool SCALED = false>
__device__ __forceinline__ void chain_add(float (&acc)[32], float (&d)[32],
                                          const uint32_t (&a)[2][4][4],
                                          uint32_t b, uint32_t a3 = 0,
                                          float c0 = 1.f, float c1 = 1.f) {
  const uint64_t db = desc_mn(b), da3 = desc_k(a3);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_rs(d, a[0][k], db + (k * 2048 >> 4), k);
    wgmma_rs(d, a[1][k], db + (k * 2048 >> 4), 1);
    if (a3) wgmma_ss_mn(d, da3 + (k * 32 >> 4), db + (k * 2048 >> 4));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
#pragma unroll
  for (int e = 0; e < 32; ++e)
    acc[e] = SCALED ? fmaf(acc[e], e % 4 < 2 ? c0 : c1, d[e])
                    : acc[e] + d[e];
}

// d = A.B^T over the head dim: A, B 64-row tiles, K-major (16 wgmmas)
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a,
                                       uint32_t b) {
  const uint64_t da = desc_k(a), db = desc_k(b);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NBOX; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss(d, da + ((c * BOX_BYTES + k * 32) >> 4),
               db + ((c * BOX_BYTES + k * 32) >> 4), c | k);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

__device__ __forceinline__ void init_barriers(uint32_t bar, int n_full,
                                              int n_empty) {
  for (int b = 0; b < n_full; ++b) mbar_init(bar + 8 * b, 1);
  for (int b = 0; b < n_empty; ++b) mbar_init(bar + 8 * (n_full + b), 8);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a consumer warp is done with a ring stage
__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// --- forward ----------------------------------------------------------------

// Block (b, h) x 128-row query tile i2 (longest first): consumer w owns
// the 64-row tile i = 2 i2 + w.
__global__ void __launch_bounds__(THREADS, 1)
    wg_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  bf16* __restrict__ out, float* __restrict__ lse, int H,
                  int Hkv, int Sq, int Skv, float scale, int causal,
                  int window) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(ALIGN - 1u);
  const uint32_t bar = base + FWD_BAR;
  // mbarriers: Q, K of stage s, V of stage s, stage s empty
  const uint32_t bar_q = bar;
  auto bar_k = [&](int s) { return bar + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  const int n_q = (Sq + BR - 1) / BR, n_kv = (Skv + BR - 1) / BR;
  const int i2 = (n_q + 1) / 2 - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * Hkv + (bh % H) / (H / Hkv);
  // the kv tiles either consumer's query tile sees
  int j0 = n_kv, j1 = 0;
  for (int w = 0; w < 2; ++w) {
    const int i = 2 * i2 + w;
    if (i >= n_q) continue;
    int a, z;
    live_range(n_kv, [&](int j) { return tile_live(i, j, causal, window); },
               a, z);
    if (a < z) {
      j0 = min(j0, a);
      j1 = max(j1, z);
    }
  }
  const int n_it = j1 > j0 ? j1 - j0 : 0;

  if (threadIdx.x == 0) init_barriers(bar, 1 + 2 * STAGES, STAGES);
  __syncthreads();

  // the warpgroup, broadcast so the compiler sees the role is uniform in
  // each warp (setmaxnreg needs the roles' paths to be known)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const bool two = 2 * i2 + 1 < n_q;  // else consumer 1 is idle
      mbar_expect(bar_q, (two ? 2 : 1) * TILE_BYTES);
      tma_tile(base + FWD_Q, &tq, bar_q, 2 * i2 * BR, bh);
      if (two)
        tma_tile(base + FWD_Q + TILE_BYTES, &tq, bar_q, (2 * i2 + 1) * BR,
                 bh);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        const int row = (j0 + it) * BR;
        mbar_expect(bar_k(s), TILE_BYTES);
        tma_tile(base + FWD_K + s * TILE_BYTES, &tk, bar_k(s), row, bkv);
        mbar_expect(bar_v(s), TILE_BYTES);
        tma_tile(base + FWD_V + s * TILE_BYTES, &tv, bar_v(s), row, bkv);
      }
    }
  } else {  // consumer wg: query rows i * 64 ..
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int i = 2 * i2 + wg;
    const int r0 = i * BR + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    const uint32_t qa = base + FWD_Q + wg * TILE_BYTES;
    const float c2 = scale * LOG2E;  // scores in log2 units

    float o[NBOX][32], s[32], d[32];
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, cr[2];
    uint32_t pa[2][4][4];  // P's hi and lo terms

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_it; ++it) {
      const int j = j0 + it, st = it % STAGES;
      const uint32_t par = (it / STAGES) & 1;
      const bool live = i < n_q && tile_live(i, j, causal, window);
      mbar_wait(bar_k(st), par);
      if (live) {
        scores(s, qa, base + FWD_K + st * TILE_BYTES);
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] *= c2;
        if (!tile_full(i, j, Sq, Skv, causal, window)) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = r0 + (e / 2) * 8;
              const int kp = j * BR + n * 8 + 2 * t + (e % 2);
              if (!seen(qp, kp, Skv, causal, window)) s[4 * n + e] = NEG_INF;
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = NEG_INF;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float mn = fmaxf(m[r], mx);
          const float corr = exp2_ftz(m[r] - mn);
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[4 * n + e] = exp2_ftz(s[4 * n + e] - mn);
              rs += s[4 * n + e];
            }
          l[r] = l[r] * corr + rs;
          cr[r] = corr;
          m[r] = mn;
        }
        split_a(s, pa);
      }
      mbar_wait(bar_v(st), par);
      if (live) {  // O = O corr + P.V, 64 output columns a chain
        const uint32_t va = base + FWD_V + st * TILE_BYTES;
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          chain_add<true>(o[c], d, pa, va + c * BOX_BYTES, 0, cr[0], cr[1]);
      }
      release(bar_e(st), lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(FULL, lt, 1);
      lt += __shfl_xor_sync(FULL, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
      const int row = r0 + 8 * r;
      if (i >= n_q || row >= Sq) continue;
      bf16* orow = out + (static_cast<size_t>(bh) * Sq + row) * HD;
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + c * BOX_COLS + n * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(o[c][4 * n + 2 * r] / lc,
                                    o[c][4 * n + 2 * r + 1] / lc);
      if (t == 0)
        lse[static_cast<size_t>(bh) * Sq + row] = m[r] * LN2 + logf(lc);
    }
  }
}

// --- dq ---------------------------------------------------------------------

// Block (b, h) x 64-row query tile i (longest first). Consumer 0: S, P;
// consumer 1: dP; both: dS, then dQ's columns 128 w .. 128 w + 127.
__global__ void __launch_bounds__(THREADS, 1)
    wg_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 int H, int Hkv, int Sq, int Skv, float scale, int causal,
                 int window) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(ALIGN - 1u);
  const uint32_t bar = base + DQ_BAR;
  // mbarriers: Q and dout, K/V of stage s, stage s empty
  const uint32_t bar_q = bar;
  auto bar_f = [&](int s) { return bar + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar + 8 * (1 + STAGES + s); };

  const int n_q = (Sq + BR - 1) / BR, n_kv = (Skv + BR - 1) / BR;
  const int i = n_q - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bkv = b * Hkv + (bh % H) / (H / Hkv);
  int j0, j1;
  live_range(n_kv, [&](int j) { return tile_live(i, j, causal, window); },
             j0, j1);
  const int n_it = j1 - j0;

  if (threadIdx.x == 0) init_barriers(bar, 1 + STAGES, STAGES);
  __syncthreads();

  // the warpgroup, broadcast so the compiler sees the role is uniform in
  // each warp (setmaxnreg needs the roles' paths to be known)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect(bar_q, 2 * TILE_BYTES);
      tma_tile(base + DQ_Q, &tq, bar_q, i * BR, bh);
      tma_tile(base + DQ_O, &tdo, bar_q, i * BR, bh);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        const int row = (j0 + it) * BR;
        const uint32_t ka = base + DQ_RING + s * 2 * TILE_BYTES;
        mbar_expect(bar_f(s), 2 * TILE_BYTES);
        tma_tile(ka, &tk, bar_f(s), row, bkv);
        tma_tile(ka + TILE_BYTES, &tv, bar_f(s), row, bkv);
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int r0 = i * BR + warp * 16 + lane / 4;  // rows r0 and r0 + 8
    const float c2 = scale * LOG2E;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const size_t at = static_cast<size_t>(bh) * Sq + row;
      lse2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
      dl[r] = row < Sq ? delta[at] : 0.f;
    }
    // consumer 0 writes P to its buffer, consumer 1 dP to its own
    float* mine = reinterpret_cast<float*>(
        smem + (base - smem_u32(smem)) + DQ_X + wg * XCHG_BYTES);
    const float* theirs = reinterpret_cast<const float*>(
        smem + (base - smem_u32(smem)) + DQ_X + (1 - wg) * XCHG_BYTES);
    const uint32_t a_tile = base + (wg == 0 ? DQ_Q : DQ_O);

    float acc[2][32], s[32], d[32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    uint32_t ds[2][4][4];  // dS's hi and lo terms

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_it; ++it) {
      const int j = j0 + it, st = it % STAGES;
      mbar_wait(bar_f(st), (it / STAGES) & 1);
      const uint32_t ka = base + DQ_RING + st * 2 * TILE_BYTES;
      // consumer 0: S = Q.K^T; consumer 1: dP = dout.V^T
      scores(s, a_tile, ka + wg * TILE_BYTES);
      if (wg == 0) {  // P; exp2(-inf) = 0 where masked
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = s[e] * c2 - lse2[(e % 4) / 2];
        if (!tile_full(i, j, Sq, Skv, causal, window)) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = r0 + (e / 2) * 8;
              const int kp = j * BR + n * 8 + 2 * t + (e % 2);
              if (!((qp < Sq) & seen(qp, kp, Skv, causal, window)))
                s[4 * n + e] = -INFINITY;
            }
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = exp2_ftz(s[e]);
      }
      // swap P and dP; each forms dS = P (dP - delta) scale
      if (it > 0) named_sync(BAR_FREE + wg);
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e * 128 + tid] = s[e];
      named_sync(BAR_XCHG);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float other = theirs[e * 128 + tid];
        const float p = wg == 0 ? s[e] : other;
        const float dp = wg == 0 ? other : s[e];
        s[e] = p * (dp - dl[(e % 4) / 2]) * scale;
      }
      if (it + 1 < n_it) named_arrive(BAR_FREE + 1 - wg);
      split_a(s, ds);
      // dQ[:, 128 wg + 64 c ..] += dS.K
#pragma unroll
      for (int c = 0; c < 2; ++c)
        chain_add(acc[c], d, ds, ka + (2 * wg + c) * BOX_BYTES);
      release(bar_e(st), lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= Sq) continue;
      bf16* drow =
          dq + (static_cast<size_t>(bh) * Sq + row) * HD + wg * 2 * BOX_COLS;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(drow + c * BOX_COLS + n * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(acc[c][4 * n + 2 * r],
                                    acc[c][4 * n + 2 * r + 1]);
    }
  }
}

// --- dk / dv ----------------------------------------------------------------

// Block (b, kv head, split s) x 64-row kv tile j (longest first): the
// heads s*gps .. s*gps+gps-1 of the kv head's group (gps = group /
// nsplit), every live q tile of each; f32 partials part[s][0 (dK) or 1
// (dV)][b, kv head, row, d]. Consumer 0: S^T, P^T, dV; consumer 1: dP^T,
// dS^T, dK.
__global__ void __launch_bounds__(THREADS, 1)
    wg_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ part,
                  int H, int Hkv, int Sq, int Skv, float scale, int causal,
                  int window, int nsplit) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + ALIGN - 1) & ~(ALIGN - 1u);
  const uint32_t bar = base + DKV_BAR;
  // mbarriers: K and V, Q/dout of stage s, stage s empty
  const uint32_t bar_kv = bar;
  auto bar_f = [&](int s) { return bar + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar + 8 * (1 + STAGES + s); };

  const int j = blockIdx.y;
  const int split = blockIdx.x % nsplit;
  const int bk = blockIdx.x / nsplit;  // b * Hkv + kv head
  const int n_bk = gridDim.x / nsplit;
  const int hk = bk % Hkv, b = bk / Hkv;
  const int group = H / Hkv, gps = group / nsplit;
  const int h0 = b * H + hk * group + split * gps;  // first head, as b*H+h
  const int n_q = (Sq + BR - 1) / BR;
  int i0, i1;
  live_range(n_q, [&](int i) { return tile_live(i, j, causal, window); },
             i0, i1);
  const int n_i = i1 - i0;
  const int n_it = n_i * gps;  // (head, q tile) pairs, q tile fastest

  if (threadIdx.x == 0) init_barriers(bar, 1 + STAGES, STAGES);
  __syncthreads();

  // the warpgroup, broadcast so the compiler sees the role is uniform in
  // each warp (setmaxnreg needs the roles' paths to be known)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect(bar_kv, 2 * TILE_BYTES);
      tma_tile(base + DKV_K, &tk, bar_kv, j * BR, bk);
      tma_tile(base + DKV_V, &tv, bar_kv, j * BR, bk);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        const int row = (i0 + it % n_i) * BR, head = h0 + it / n_i;
        const uint32_t qa = base + DKV_RING + s * 2 * TILE_BYTES;
        mbar_expect(bar_f(s), 2 * TILE_BYTES);
        tma_tile(qa, &tq, bar_f(s), row, head);
        tma_tile(qa + TILE_BYTES, &tdo, bar_f(s), row, head);
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;
    const int kr0 = j * BR + warp * 16 + lane / 4;  // rows kr0 and kr0 + 8
    const float c2 = scale * LOG2E;
    float* xp = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) +
                                         DKV_X);
    const uint32_t a_tile = base + (wg == 0 ? DKV_K : DKV_V);

    float acc[NBOX][32], s[32], d[32];
#pragma unroll
    for (int c = 0; c < NBOX; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int i = i0 + it % n_i, st = it % STAGES;
      const size_t bh = static_cast<size_t>(h0 + it / n_i);
      // this tile's column statistics (queries i*64 + 8n + 2t + {0, 1}):
      // consumer 0 the LSE in log2 units, consumer 1 delta
      float cs[16];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = i * BR + n * 8 + 2 * t + e;
          cs[2 * n + e] = qp >= Sq ? 0.f
                          : wg == 0 ? lse[bh * Sq + qp] * LOG2E
                                    : delta[bh * Sq + qp];
        }
      mbar_wait(bar_f(st), (it / STAGES) & 1);
      const uint32_t qa = base + DKV_RING + st * 2 * TILE_BYTES;
      // consumer 0: S^T = K.Q^T; consumer 1: dP^T = V.dout^T
      scores(s, a_tile, qa + wg * TILE_BYTES);
      if (wg == 0) {  // P^T, to consumer 1 too; exp2(-inf) = 0 where masked
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = s[e] * c2 - cs[2 * (e / 4) + e % 2];
        if (!tile_full(i, j, Sq, Skv, causal, window)) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qp = i * BR + n * 8 + 2 * t + (e % 2);
              const int kp = kr0 + (e / 2) * 8;
              if (!((qp < Sq) & seen(qp, kp, Skv, causal, window)))
                s[4 * n + e] = -INFINITY;
            }
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = exp2_ftz(s[e]);
        if (it > 0) named_sync(BAR_FREE);
#pragma unroll
        for (int e = 0; e < 32; ++e) xp[e * 128 + tid] = s[e];
        named_arrive(BAR_XCHG);
      } else {  // dS^T = P^T (dP^T - delta) scale
        named_sync(BAR_XCHG);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = xp[e * 128 + tid] * (s[e] - cs[2 * (e / 4) + e % 2]) * scale;
        if (it + 1 < n_it) named_arrive(BAR_FREE);
      }
      // consumer 0: dV += P^T.dout with P^T as three terms, the third
      // from shared memory (dV sums P.dout unscaled over a kv row's
      // queries and heads, where two terms' residuals reached the
      // checks' atol); consumer 1: dK += dS^T.Q with dS^T (1/16 of the
      // scale at this head dim) as two
      const uint32_t bt = qa + (1 - wg) * TILE_BYTES;
      uint32_t a[2][4][4];
      uint32_t a3 = 0;
      if (wg == 0) {
        // the last tile's chains read the third term's tile before this
        // consumer passed BAR_FREE; its wgmmas read it after BAR_WG0
        split_a(s, a, smem + (base - smem_u32(smem)) + DKV_P3,
                warp * 16 + lane / 4, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(BAR_WG0, 128);
        a3 = base + DKV_P3;
      } else {
        split_a(s, a);
      }
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
        chain_add(acc[c], d, a, bt + c * BOX_BYTES, a3);
      release(bar_e(st), lane);
    }

    const size_t plane = static_cast<size_t>(n_bk) * Skv * HD;
    float* dst = part + (2 * split + (wg == 0 ? 1 : 0)) * plane +
                 static_cast<size_t>(bk) * Skv * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = kr0 + 8 * r;
      if (row >= Skv) continue;
#pragma unroll
      for (int c = 0; c < NBOX; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * HD +
                                     c * BOX_COLS + n * 8 + 2 * t) =
              make_float2(acc[c][4 * n + 2 * r], acc[c][4 * n + 2 * r + 1]);
    }
  }
}

// dk, dv = the splits' partials summed in split order, rounded to bf16;
// n = B * Hkv * Skv * 256
__global__ void __launch_bounds__(256)
    wg_dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
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

// --- host: tensor maps and launches -----------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, rows, 256] bf16 in 64 x 64 boxes, 128-byte swizzle; rows past
// `rows` read as zeros (a 0-row tensor is mapped as 1 row and never read)
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  rows = rows > 0 ? rows : 1;
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {HD * 2,
                                 static_cast<cuuint64_t>(rows) * HD * 2};
  const cuuint32_t box[3] = {BOX_COLS, BR, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int prepare(K kern, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

const char* flash256_error_string(int code) {
  if (code == ENCODE_ERROR)
    return "cuTensorMapEncodeTiled failed or was not found";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out bf16; lse f32 [B, H, Sq]
int flash256_fwd(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int H, int Hkv, int Sq, int Skv,
                 float scale, int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B * H, Sq) || !encode(&tk, k, B * Hkv, Skv) ||
      !encode(&tv, v, B * Hkv, Skv))
    return ENCODE_ERROR;
  if (int e = prepare(wg_fwd_kernel, FWD_SMEM_BYTES)) return e;
  const int n_q = (Sq + BR - 1) / BR;
  const dim3 grid(B * H, (n_q + 1) / 2);
  wg_fwd_kernel<<<grid, THREADS, FWD_SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Hkv,
      Sq, Skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int flash256_dq(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int B, int H, int Hkv, int Sq, int Skv, float scale,
                int causal, int window, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B * H, Sq) || !encode(&tk, k, B * Hkv, Skv) ||
      !encode(&tv, v, B * Hkv, Skv) || !encode(&tdo, dout, B * H, Sq))
    return ENCODE_ERROR;
  if (int e = prepare(wg_dq_kernel, DQ_SMEM_BYTES)) return e;
  const dim3 grid(B * H, (Sq + BR - 1) / BR);
  wg_dq_kernel<<<grid, THREADS, DQ_SMEM_BYTES,
                 static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Hkv, Sq,
      Skv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch of nsplit * 2 * B*Hkv*Skv*256; nsplit divides H/Hkv
int flash256_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, void* part, int nsplit, int B, int H,
                 int Hkv, int Sq, int Skv, float scale, int causal,
                 int window, void* stream) {
  if (B == 0 || Hkv == 0 || Skv == 0) return 0;
  if (nsplit < 1 || (H / Hkv) % nsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B * H, Sq) || !encode(&tk, k, B * Hkv, Skv) ||
      !encode(&tv, v, B * Hkv, Skv) || !encode(&tdo, dout, B * H, Sq))
    return ENCODE_ERROR;
  if (int e = prepare(wg_dkv_kernel, DKV_SMEM_BYTES)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv * nsplit, (Skv + BR - 1) / BR);
  wg_dkv_kernel<<<grid, THREADS, DKV_SMEM_BYTES, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(part), H, Hkv, Sq,
      Skv, scale, causal, window, nsplit);
  if (int e = static_cast<int>(cudaGetLastError())) return e;
  const size_t n = static_cast<size_t>(B) * Hkv * Skv * HD;
  const size_t blocks = (n / 4 + 255) / 256;
  wg_dkv_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                      256, 0, st>>>(static_cast<const float*>(part),
                                    static_cast<bf16*>(dk),
                                    static_cast<bf16*>(dv), nsplit, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
