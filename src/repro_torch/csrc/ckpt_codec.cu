// Checkpoint codec kernels for Hopper (sm_90a): chunk fingerprint,
// fused dirty-chunk capture, byte XOR, and the int8 snapshot codec's
// block quantize and dequantize.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ckpt_fingerprint     <- repro/kernels/ckpt_codec/kernel.py fingerprint_blocks
//   ckpt_fused_capture   <- repro/kernels/ckpt_codec/kernel.py fused_capture_blocks
//   ckpt_xor             <- repro/kernels/ckpt_codec/kernel.py xor_blocks
//   ckpt_quantize        <- repro/kernels/ckpt_codec/kernel.py quantize_blocks
//   ckpt_dequantize      <- repro/kernels/ckpt_codec/kernel.py dequantize_blocks
// The bit-exact contract of all five is the numpy oracle
// repro_torch/kernels/ckpt_codec/ref.py (fingerprint_ref,
// fused_capture_ref, delta_encode_ref, quantize_ref, dequantize_ref).
//
// What bounds them on an H100: all five read or write every byte once
// and do a few operations per 4-byte lane, far below the ~20
// operations per byte where the arithmetic units would become the
// limit, so each is bound by device-memory bandwidth (3.35 TB/s):
//   fingerprint  n bytes read                         -> n / 3.35 TB/s
//   fused        n bytes read + k dirty chunks written -> (n + k*chunk) / 3.35 TB/s
//   xor          2n read + n written                   -> 3n / 3.35 TB/s
//   quantize     4n read + n + 4n/256 written          -> 5.02n / 3.35 TB/s
//   dequantize   n + 4n/256 read + 4n written          -> 5.02n / 3.35 TB/s
//                (n elements for the codec pair)
// The design answer is the same everywhere: 16-byte (uint4) loads by
// neighbouring threads on neighbouring addresses, enough blocks to
// cover the 132 SMs, and no second pass over the leaf.
//
// The TPU kernel's fused capture gets its prefix sum from the TPU's
// sequential grid: a running count carried from one grid step to the
// next puts every dirty chunk at its final compacted slot in the same
// pass. Hopper blocks run in no order, and the output must still come
// out in chunk order with no atomics deciding the order (restores are
// checked bit for bit). So the fused capture here is three launches on
// one stream: hash + compare + flag (one block per chunk), one block
// that scans the flags in chunk order and writes count and indices,
// and a copy of the first min(count, capacity) dirty chunks into the
// compaction buffer.
//
// Hash arithmetic is done in uint32: wraparound of unsigned integers is
// defined in C++, and the JAX kernel's int32 wraparound gives the same
// bits. Sums modulo 2^32 do not depend on their order, so the block
// reduction gives the oracle's bits whatever order it adds in.
//
// The codec pair must give numpy's bits (the manifests and blob names of
// both packages depend on them), so it is plain IEEE float32: the scale
// is max(amax, f32(1e-12)) / 127 and q = rint(x / scale) with a
// correctly rounded division (__fdiv_rn), never x * (1 / scale), which
// differs at and near the ties; rintf rounds half to even as np.rint
// does. The library is built without --use_fast_math, so subnormals are
// kept (no flush to zero). One difference is left as it is: fmaxf drops
// a NaN where np.maximum keeps it, so a block holding a NaN quantizes
// differently here (finite input is the contract).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after its
// launches (0 = cudaSuccess).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kXorC = 0x5BD1E995u;
constexpr uint32_t kMulC = 0x9E3779B1u;
constexpr int kHashThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kCopySplit = 8;  // blocks per copied chunk
constexpr int kQBlock = 256;   // elements of one codec block (ref.BLOCK)
constexpr int kQWarps = 8;     // codec blocks per CUDA block, a warp each
constexpr int kXorThreads = 256;
constexpr int kXorUnroll = 8;  // 16-byte words of each operand in flight

__device__ __forceinline__ void mix(uint32_t x, uint32_t p, uint32_t& h1,
                                    uint32_t& h2) {
  h1 += x * (2u * p + 1u);
  h2 += (x ^ kXorC) * (2u * p + kMulC);
}

// One 4-byte little-endian lane at byte offset `off`, zero past `nbytes`
// (the oracle zero-pads the tail chunk).
__device__ __forceinline__ uint32_t lane_at(const uint8_t* x, long long nbytes,
                                            long long off, bool aligned4) {
  if (aligned4 && off + 4 <= nbytes) {
    return *reinterpret_cast<const uint32_t*>(x + off);
  }
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    if (off + b < nbytes) v |= static_cast<uint32_t>(x[off + b]) << (8 * b);
  }
  return v;
}

// Both hashes of chunk `c`, summed over this block's threads; the sums
// are valid in thread 0 on return.
__device__ void chunk_hash(const uint8_t* x, long long nbytes,
                           long long chunk_bytes, long long c, bool vec_ok,
                           bool aligned4, uint32_t& h1, uint32_t& h2) {
  h1 = 0u;
  h2 = 0u;
  const long long base = c * chunk_bytes;
  if (vec_ok && base + chunk_bytes <= nbytes) {
    const uint4* v = reinterpret_cast<const uint4*>(x + base);
    const uint32_t nv = static_cast<uint32_t>(chunk_bytes / 16);
    for (uint32_t i = threadIdx.x; i < nv; i += blockDim.x) {
      const uint4 w = v[i];
      const uint32_t p = 4u * i;
      mix(w.x, p, h1, h2);
      mix(w.y, p + 1u, h1, h2);
      mix(w.z, p + 2u, h1, h2);
      mix(w.w, p + 3u, h1, h2);
    }
  } else {
    const uint32_t lanes = static_cast<uint32_t>(chunk_bytes / 4);
    for (uint32_t p = threadIdx.x; p < lanes; p += blockDim.x) {
      mix(lane_at(x, nbytes, base + 4LL * p, aligned4), p, h1, h2);
    }
  }
  __shared__ uint32_t s1[32];
  __shared__ uint32_t s2[32];
  for (int o = 16; o > 0; o >>= 1) {
    h1 += __shfl_down_sync(0xffffffffu, h1, o);
    h2 += __shfl_down_sync(0xffffffffu, h2, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s1[warp] = h1;
    s2[warp] = h2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    h1 = lane < nw ? s1[lane] : 0u;
    h2 = lane < nw ? s2[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      h1 += __shfl_down_sync(0xffffffffu, h1, o);
      h2 += __shfl_down_sync(0xffffffffu, h2, o);
    }
  }
}

// Replaces fingerprint_blocks (repro/kernels/ckpt_codec/kernel.py:101):
// one block per chunk, bound by reading the leaf once.
__global__ void fingerprint_kernel(const uint8_t* __restrict__ x,
                                   long long nbytes, long long chunk_bytes,
                                   bool vec_ok, bool aligned4,
                                   uint32_t* __restrict__ fp) {
  const long long c = blockIdx.x;
  uint32_t h1, h2;
  chunk_hash(x, nbytes, chunk_bytes, c, vec_ok, aligned4, h1, h2);
  if (threadIdx.x == 0) {
    fp[2 * c] = h1;
    fp[2 * c + 1] = h2;
  }
}

// Fused capture, pass 1 of 3 (replaces fused_capture_blocks,
// kernel.py:160, with the scan and copy below): hash, compare against
// the previous fingerprints, flag. Bound by reading the leaf once.
__global__ void hash_flag_kernel(const uint8_t* __restrict__ x,
                                 long long nbytes, long long chunk_bytes,
                                 bool vec_ok, bool aligned4,
                                 const uint32_t* __restrict__ prev_fp,
                                 uint32_t* __restrict__ fp,
                                 int32_t* __restrict__ flags) {
  const long long c = blockIdx.x;
  uint32_t h1, h2;
  chunk_hash(x, nbytes, chunk_bytes, c, vec_ok, aligned4, h1, h2);
  if (threadIdx.x == 0) {
    fp[2 * c] = h1;
    fp[2 * c + 1] = h2;
    flags[c] = (h1 != prev_fp[2 * c] || h2 != prev_fp[2 * c + 1]) ? 1 : 0;
  }
}

// Fused capture, pass 2 of 3. One block walks the flags in chunk
// order, a tile of blockDim.x at a time, carrying the running count
// between tiles: dirty chunk c lands
// at slot (number of dirty chunks before c), exactly the running count
// of the TPU kernel. The total keeps counting past `capacity` — the
// host reads it as the overflow signal.
__global__ void scan_kernel(const int32_t* __restrict__ flags,
                            long long n_chunks, int capacity,
                            int32_t* __restrict__ count,
                            int32_t* __restrict__ idx) {
  __shared__ int32_t s[kScanThreads];
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long t0 = 0; t0 < n_chunks; t0 += blockDim.x) {
    const long long c = t0 + threadIdx.x;
    const int32_t f = c < n_chunks ? flags[c] : 0;
    s[threadIdx.x] = f;
    __syncthreads();
    for (int o = 1; o < static_cast<int>(blockDim.x); o <<= 1) {
      const int32_t add = threadIdx.x >= static_cast<unsigned>(o)
                              ? s[threadIdx.x - o] : 0;
      __syncthreads();
      s[threadIdx.x] += add;
      __syncthreads();
    }
    const long long pos = carry + s[threadIdx.x] - f;
    if (f && pos < capacity) idx[pos] = static_cast<int32_t>(c);
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry += s[threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x == 0) count[0] = static_cast<int32_t>(carry);
}

// Fused capture, pass 3 of 3, bound by writing the kept dirty chunks.
// Block (j, y) copies slice y of compacted slot j; slots at or past the
// dirty count are left untouched (the host reads only `count` rows).
__global__ void copy_kernel(const uint8_t* __restrict__ x, long long nbytes,
                            long long chunk_bytes, bool vec_ok,
                            const int32_t* __restrict__ count,
                            const int32_t* __restrict__ idx,
                            uint8_t* __restrict__ out) {
  const int j = blockIdx.x;
  if (j >= count[0]) return;
  const long long base = static_cast<long long>(idx[j]) * chunk_bytes;
  uint8_t* dst = out + static_cast<long long>(j) * chunk_bytes;
  const long long slice = chunk_bytes / gridDim.y;
  const long long lo = slice * blockIdx.y;
  const long long hi = blockIdx.y + 1 == gridDim.y ? chunk_bytes : lo + slice;
  if (vec_ok && base + chunk_bytes <= nbytes && slice % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(x + base + lo);
    uint4* d = reinterpret_cast<uint4*>(dst + lo);
    const long long nv = (hi - lo) / 16;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) d[i] = src[i];
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      dst[i] = base + i < nbytes ? x[base + i] : 0;
    }
  }
}

// Replaces xor_blocks (kernel.py:65); bound by 2n bytes read + n written.
// Each thread first issues kXorUnroll independent 16-byte loads of each
// operand (streaming loads that skip L1), then XORs and stores them with
// streaming stores: with one word a thread, a 4 MiB view was a launch
// ramp and a tail of dependent load pairs, no stream. A block covers
// kXorUnroll * kXorThreads words; the grid is one block per such step of
// the byte count (128 blocks for a 4 MiB view, under one a SM), and the
// hardware starts each block as an SM frees up. At 100 registers two
// blocks fit an SM; capping the grid at those resident blocks, each
// looping over its share, measured 3.6% slower at 256 MiB on an H100
// (PERF.md). The unaligned path goes byte by byte.
__global__ void __launch_bounds__(kXorThreads)
xor_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           uint8_t* __restrict__ out, long long n, bool vec_ok) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  long long done = 0;
  if (vec_ok) {
    const long long nv = n / 16;
    const uint4* va = reinterpret_cast<const uint4*>(a);
    const uint4* vb = reinterpret_cast<const uint4*>(b);
    uint4* vo = reinterpret_cast<uint4*>(out);
    constexpr long long kStep = static_cast<long long>(kXorThreads) * kXorUnroll;
    for (long long base = static_cast<long long>(blockIdx.x) * kStep +
                          threadIdx.x;
         base < nv; base += static_cast<long long>(gridDim.x) * kStep) {
      uint4 x[kXorUnroll], y[kXorUnroll];
#pragma unroll
      for (int u = 0; u < kXorUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * kXorThreads;
        if (i < nv) {
          x[u] = __ldcs(va + i);
          y[u] = __ldcs(vb + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kXorUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * kXorThreads;
        if (i < nv)
          __stcs(vo + i, make_uint4(x[u].x ^ y[u].x, x[u].y ^ y[u].y,
                                    x[u].z ^ y[u].z, x[u].w ^ y[u].w));
      }
    }
    done = nv * 16;
  }
  for (long long i = done + t; i < n; i += stride) out[i] = a[i] ^ b[i];
}

// Replaces quantize_blocks (kernel.py:38). One warp per 256-element
// block: each lane loads 8 consecutive floats (two 16-byte loads where
// the input is aligned; scalar, zero past n, on the ragged tail), the
// block's amax is a butterfly of __shfl_xor_sync, and each lane stores
// its 8 int8 codes as one 8-byte word. Bound by reading x once.
__global__ void quantize_kernel(const float* __restrict__ x, long long n,
                                long long nb, bool vec_ok,
                                int8_t* __restrict__ q,
                                float* __restrict__ scale) {
  const long long b = static_cast<long long>(blockIdx.x) * kQWarps +
                      (threadIdx.x >> 5);
  if (b >= nb) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long base = b * kQBlock + lane * 8;
  float v[8];
  if (vec_ok && base + 8 <= n) {
    const float4* p = reinterpret_cast<const float4*>(x + base);
    const float4 a = p[0];
    const float4 c = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else {
    for (int i = 0; i < 8; ++i) v[i] = base + i < n ? x[base + i] : 0.0f;
  }
  float amax = 0.0f;
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  // numpy's f32(1e-12): the double literal rounded once to float
  const float s = __fdiv_rn(fmaxf(amax, static_cast<float>(1e-12)), 127.0f);
  uint32_t word[2] = {0u, 0u};
  for (int i = 0; i < 8; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.0f), 127.0f);
    const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(r));
    word[i >> 2] |= byte << (8 * (i & 3));
  }
  reinterpret_cast<uint2*>(q)[b * (kQBlock / 8) + lane] =
      make_uint2(word[0], word[1]);
  if (lane == 0) scale[b] = s;
}

// Replaces dequantize_blocks (kernel.py:214): one thread per 8 codes,
// one 8-byte load of q, two 16-byte stores of the product with the
// block's scale (an exact int8 -> float conversion and one IEEE
// multiply, as numpy's). Bound by writing the f32 output once.
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scale,
                                  long long nb, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= nb * (kQBlock / 8)) return;
  const float s = scale[t / (kQBlock / 8)];
  const uint2 w = reinterpret_cast<const uint2*>(q)[t];
  float r[8];
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = i < 4 ? w.x : w.y;
    const int8_t code =
        static_cast<int8_t>(static_cast<uint8_t>(word >> (8 * (i & 3))));
    r[i] = static_cast<float>(code) * s;
  }
  float4* o = reinterpret_cast<float4*>(out) + 2 * t;
  o[0] = make_float4(r[0], r[1], r[2], r[3]);
  o[1] = make_float4(r[4], r[5], r[6], r[7]);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

extern "C" {

const char* ckpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp: uint32 [n_chunks, 2] where n_chunks = ceil(nbytes / chunk_bytes).
int ckpt_fingerprint(const void* x, long long nbytes, long long chunk_bytes,
                     void* fp, void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  if (n_chunks == 0) return 0;
  const bool vec_ok = aligned(x, 16) && chunk_bytes % 16 == 0;
  fingerprint_kernel<<<static_cast<unsigned>(n_chunks), kHashThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), nbytes, chunk_bytes, vec_ok,
      aligned(x, 4), static_cast<uint32_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}

// prev_fp, fp: uint32 [n_chunks, 2]; flags: int32 [n_chunks] scratch;
// count: int32 [1]; idx: int32 [capacity];
// compact: uint8 [capacity, chunk_bytes], 16-byte aligned.
int ckpt_fused_capture(const void* x, long long nbytes, long long chunk_bytes,
                       const void* prev_fp, int capacity, void* fp,
                       void* flags, void* count, void* idx, void* compact,
                       void* stream) {
  const long long n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const bool vec_ok = aligned(x, 16) && chunk_bytes % 16 == 0;
  if (n_chunks > 0) {
    hash_flag_kernel<<<static_cast<unsigned>(n_chunks), kHashThreads, 0, s>>>(
        xb, nbytes, chunk_bytes, vec_ok, aligned(x, 4),
        static_cast<const uint32_t*>(prev_fp), static_cast<uint32_t*>(fp),
        static_cast<int32_t*>(flags));
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(flags), n_chunks, capacity,
      static_cast<int32_t*>(count), static_cast<int32_t*>(idx));
  const bool copy_vec = vec_ok && aligned(compact, 16);
  dim3 grid(static_cast<unsigned>(capacity), kCopySplit);
  copy_kernel<<<grid, kHashThreads, 0, s>>>(
      xb, nbytes, chunk_bytes, copy_vec, static_cast<const int32_t*>(count),
      static_cast<const int32_t*>(idx), static_cast<uint8_t*>(compact));
  return static_cast<int>(cudaGetLastError());
}

// out = a ^ b over n bytes.
int ckpt_xor(const void* a, const void* b, void* out, long long n,
             void* stream) {
  if (n == 0) return 0;
  const bool vec_ok = aligned(a, 16) && aligned(b, 16) && aligned(out, 16);
  const long long per_block = vec_ok ? 16LL * kXorThreads * kXorUnroll
                                     : static_cast<long long>(kXorThreads);
  const long long blocks = (n + per_block - 1) / per_block;
  xor_kernel<<<static_cast<unsigned>(blocks), kXorThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(out), n, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// x: float32 [n]; q: int8 [nb, 256], 8-byte aligned; scale: float32
// [nb], where nb = ceil(n / 256) (the tail block zero-padded).
int ckpt_quantize(const void* x, long long n, void* q, void* scale,
                  void* stream) {
  const long long nb = (n + kQBlock - 1) / kQBlock;
  if (nb == 0) return 0;
  const long long blocks = (nb + kQWarps - 1) / kQWarps;
  quantize_kernel<<<static_cast<unsigned>(blocks), 32 * kQWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, nb, aligned(x, 16),
      static_cast<int8_t*>(q), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// q: int8 [nb, 256], 8-byte aligned; scale: float32 [nb];
// out: float32 [nb * 256], 16-byte aligned.
int ckpt_dequantize(const void* q, const void* scale, long long nb,
                    void* out, void* stream) {
  const long long threads = nb * (kQBlock / 8);
  if (threads == 0) return 0;
  const long long blocks = (threads + 255) / 256;
  dequantize_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), nb,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
