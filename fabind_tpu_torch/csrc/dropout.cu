// Counter-based inverted dropout for NVIDIA Hopper (sm_90a).
//
//   out[i] = keep(i) ? round_T(float(x[i]) * scale) : 0
//   keep(i) = u32(i) >= threshold,   threshold = floor(rate * 2^32)
//   u32(i)  = word i % 4 of Philox4x32-10(counter = (c, c >> 32, 0, 0),
//             key = K), c = i / 4
//   K       = the first two words of Philox4x32-10(counter = (site, call,
//             round, round >> 32), key = (seed, seed >> 32))
//
// seed and round are int64 scalars read from device memory, so a caller
// (or a traced program) passes them as tensors and nothing waits for the
// host. The mask is a pure function of (seed, site, call, round, i): the
// backward is this kernel on the incoming gradient with the same key, and a
// recomputation (remat) draws the forward's mask. Philox4x32-10 is the
// generator of PyTorch's CUDA generator and cuRAND; the plain version in
// ops/dropout.py computes the same words with int64 tensor arithmetic, so
// both devices and both dtypes draw identical masks.
//
// Not a port of a TPU kernel: the JAX package leaves dropout to XLA's fused
// elementwise code. This is the port's own kernel, the counter-based stream
// that lets a traced program take its randomness as an input.
//
// What bounds it on the H100: memory. It reads x once and writes out once
// (2 x bytes of x); the 11 Philox evaluations per thread (one key, then one
// per 4 elements) are ~10 integer multiply-highs and xors per 4 elements,
// far under the integer pipes' rate at 3.35 TB/s.
//
// Design: a grid-stride loop over chunks of 16 bytes (4 fp32 or 8 bf16
// elements, one or two Philox counters), with one 16-byte load and one
// 16-byte store per chunk when both pointers are 16-byte aligned and the
// chunk is whole; the ragged tail and unaligned tensors take the scalar path.
// The product is an IEEE fp32 multiply (__fmul_rn, never contracted), then
// one round-to-nearest-even to bf16, as the plain version's
// (x.float() * scale).to(bfloat16).
//
// Row-mapped masks (fabind_dropout_rows): data parallelism hands a replica
// or a training rank some rows of a batch, and they must draw the masks of
// those rows in the whole batch. Local element i of a tensor of rows of
// row_len elements draws as global element
//   g(i) = ((i / row_len) * row_mul + row_add) * row_len + i % row_len,
// so u32 is word g % 4 of Philox at counter g / 4. When row_len is not a
// multiple of 4 a group of 4 global elements straddles two rows, so a
// chunk's draws cannot be one counter's words as above. The mapped kernel
// keeps the unmapped one's memory layout (a 16-byte chunk per thread and
// iteration, 16-byte loads and stores when aligned and whole) and builds
// the chunk's keep bits first: it steps g along the row (and to the next
// row's start) and evaluates Philox again only when g / 4 changes, 1-2
// times per 4 fp32 elements and 2-3 per 8 bf16 ones, against 1 and 2 in
// the unmapped kernel. The row and column of a chunk's first element take
// one division (32-bit below 2^32 elements). The identity map never takes
// this kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t M0 = 0xD2511F53u;   // Philox4x32 multipliers
constexpr uint32_t M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u;   // Weyl key increments
constexpr uint32_t W1 = 0xBB67AE85u;
constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 4096;

struct U4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ U4 philox10(U4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = U4{hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0};
    k0 += W0;
    k1 += W1;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const U4& u, int j) {
  return j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
}

// one element: fp32 bits or bf16 bits (in the low 16) in, the same out
template <bool BF16>
__device__ __forceinline__ uint32_t drop_one(uint32_t bits, bool keep,
                                             float scale) {
  if (!keep) return 0u;
  if (BF16) {
    const float v = __fmul_rn(__uint_as_float(bits << 16), scale);
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  return __float_as_uint(__fmul_rn(__uint_as_float(bits), scale));
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const void* __restrict__ x, void* __restrict__ out,
               long long n, const long long* __restrict__ seed,
               const long long* __restrict__ round, uint32_t site,
               uint32_t call, uint32_t threshold, float scale, bool vec) {
  constexpr int VEC = BF16 ? 8 : 4;    // elements per 16-byte chunk
  constexpr int CTRS = VEC / 4;        // Philox counters per chunk
  const uint64_t s = (uint64_t)__ldg(seed);
  const uint64_t r = (uint64_t)__ldg(round);
  const U4 key = philox10(U4{site, call, (uint32_t)r, (uint32_t)(r >> 32)},
                          (uint32_t)s, (uint32_t)(s >> 32));
  const long long chunks = (n + VEC - 1) / VEC;
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x;
       q < chunks; q += (long long)gridDim.x * THREADS) {
    U4 u[CTRS];
#pragma unroll
    for (int t = 0; t < CTRS; ++t) {
      const uint64_t c = (uint64_t)q * CTRS + t;
      u[t] = philox10(U4{(uint32_t)c, (uint32_t)(c >> 32), 0u, 0u}, key.x,
                      key.y);
    }
    const long long base = q * VEC;
    if (vec && base + VEC <= n) {
      const uint4 in = __ldg(reinterpret_cast<const uint4*>(x) + q);
      const uint32_t w[4] = {in.x, in.y, in.z, in.w};
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (BF16) {
          const int j = 2 * k;   // elements j (low half) and j + 1 (high)
          const uint32_t lo = drop_one<true>(
              w[k] & 0xFFFFu, word(u[j / 4], j % 4) >= threshold, scale);
          const uint32_t hi = drop_one<true>(
              w[k] >> 16, word(u[(j + 1) / 4], (j + 1) % 4) >= threshold,
              scale);
          o[k] = lo | (hi << 16);
        } else {
          o[k] = drop_one<false>(w[k], word(u[0], k) >= threshold, scale);
        }
      }
      reinterpret_cast<uint4*>(out)[q] = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int j = 0; j < VEC && base + j < n; ++j) {
        const bool keep = word(u[j / 4], j % 4) >= threshold;
        if (BF16) {
          const uint16_t b = static_cast<const uint16_t*>(x)[base + j];
          static_cast<uint16_t*>(out)[base + j] =
              (uint16_t)drop_one<true>(b, keep, scale);
        } else {
          const uint32_t b = static_cast<const uint32_t*>(x)[base + j];
          static_cast<uint32_t*>(out)[base + j] =
              drop_one<false>(b, keep, scale);
        }
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
dropout_rows_kernel(const void* __restrict__ x, void* __restrict__ out,
                    long long n, const long long* __restrict__ seed,
                    const long long* __restrict__ round, uint32_t site,
                    uint32_t call, uint32_t threshold, float scale,
                    long long row_len, long long row_mul, long long row_add,
                    bool vec) {
  constexpr int VEC = BF16 ? 8 : 4;    // elements per 16-byte chunk
  const uint64_t s = (uint64_t)__ldg(seed);
  const uint64_t r = (uint64_t)__ldg(round);
  const U4 key = philox10(U4{site, call, (uint32_t)r, (uint32_t)(r >> 32)},
                          (uint32_t)s, (uint32_t)(s >> 32));
  // 32-bit division where the tensor allows it (every served shape)
  const bool narrow = n <= 0xFFFFFFFFll;
  const long long chunks = (n + VEC - 1) / VEC;
  for (long long q = blockIdx.x * (long long)THREADS + threadIdx.x;
       q < chunks; q += (long long)gridDim.x * THREADS) {
    const long long base = q * VEC;
    long long row, col;
    if (narrow) {
      const uint32_t b = (uint32_t)base, len = (uint32_t)row_len;
      row = b / len;
      col = b - (uint32_t)row * len;
    } else {
      row = base / row_len;
      col = base - row * row_len;
    }
    // the chunk's keep bits: element j's draw is word g % 4 at counter g / 4
    // of its global index g, which steps along the row and jumps at a row's
    // end (past n the draws are computed and not used)
    uint64_t g = (uint64_t)((row * row_mul + row_add) * row_len + col);
    uint64_t have = ~0ull;
    U4 u{0u, 0u, 0u, 0u};
    uint32_t keep = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint64_t c = g >> 2;
      if (c != have) {
        u = philox10(U4{(uint32_t)c, (uint32_t)(c >> 32), 0u, 0u}, key.x,
                     key.y);
        have = c;
      }
      keep |= (uint32_t)(word(u, (int)(g & 3)) >= threshold) << j;
      if (++col == row_len) {            // the next local row starts
        col = 0;
        ++row;
        g = (uint64_t)((row * row_mul + row_add) * row_len);
      } else {
        ++g;
      }
    }
    if (vec && base + VEC <= n) {
      const uint4 in = __ldg(reinterpret_cast<const uint4*>(x) + q);
      const uint32_t w[4] = {in.x, in.y, in.z, in.w};
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (BF16) {
          const uint32_t lo = drop_one<true>(w[k] & 0xFFFFu,
                                             (keep >> (2 * k)) & 1u, scale);
          const uint32_t hi = drop_one<true>(w[k] >> 16,
                                             (keep >> (2 * k + 1)) & 1u,
                                             scale);
          o[k] = lo | (hi << 16);
        } else {
          o[k] = drop_one<false>(w[k], (keep >> k) & 1u, scale);
        }
      }
      reinterpret_cast<uint4*>(out)[q] = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      for (int j = 0; j < VEC && base + j < n; ++j) {
        const bool kj = (keep >> j) & 1u;
        if (BF16) {
          const uint16_t b = static_cast<const uint16_t*>(x)[base + j];
          static_cast<uint16_t*>(out)[base + j] =
              (uint16_t)drop_one<true>(b, kj, scale);
        } else {
          const uint32_t b = static_cast<const uint32_t*>(x)[base + j];
          static_cast<uint32_t*>(out)[base + j] = drop_one<false>(b, kj,
                                                                   scale);
        }
      }
    }
  }
}

__global__ void philox_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint32_t* a = in + 6 * i;
  const U4 c = philox10(U4{a[0], a[1], a[2], a[3]}, a[4], a[5]);
  out[4 * i] = c.x;
  out[4 * i + 1] = c.y;
  out[4 * i + 2] = c.z;
  out[4 * i + 3] = c.w;
}

}  // namespace

// x, out: n contiguous elements of one dtype (0 fp32, 1 bf16); seed, round:
// one int64 each in device memory. Keeps an element iff its draw is >=
// threshold and writes x * scale there, 0 elsewhere. Returns the CUDA error
// of the launch (0 on success).
extern "C" int fabind_dropout(const void* x, void* out, long long n,
                              const void* seed, const void* round,
                              unsigned site, unsigned call,
                              unsigned threshold, float scale, int dtype,
                              void* stream) {
  if (!x || !out || !seed || !round || n < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int vec_elems = dtype == 1 ? 8 : 4;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long chunks = (n + vec_elems - 1) / vec_elems;
  long long blocks = (chunks + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  const long long* rd = static_cast<const long long*>(round);
  if (dtype == 1)
    dropout_kernel<true><<<(int)blocks, THREADS, 0, s>>>(
        x, out, n, sd, rd, site, call, threshold, scale, vec);
  else
    dropout_kernel<false><<<(int)blocks, THREADS, 0, s>>>(
        x, out, n, sd, rd, site, call, threshold, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// fabind_dropout with a row map: x and out hold rows of row_len elements,
// and local element i draws as global element
// ((i / row_len) * row_mul + row_add) * row_len + i % row_len.
extern "C" int fabind_dropout_rows(const void* x, void* out, long long n,
                                   const void* seed, const void* round,
                                   unsigned site, unsigned call,
                                   unsigned threshold, float scale, int dtype,
                                   long long row_len, long long row_mul,
                                   long long row_add, void* stream) {
  if (!x || !out || !seed || !round || n < 0 || (dtype != 0 && dtype != 1) ||
      row_len < 1 || row_mul < 1 || row_add < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int vec_elems = dtype == 1 ? 8 : 4;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long chunks = (n + vec_elems - 1) / vec_elems;
  long long blocks = (chunks + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sd = static_cast<const long long*>(seed);
  const long long* rd = static_cast<const long long*>(round);
  if (dtype == 1)
    dropout_rows_kernel<true><<<(int)blocks, THREADS, 0, s>>>(
        x, out, n, sd, rd, site, call, threshold, scale, row_len, row_mul,
        row_add, vec);
  else
    dropout_rows_kernel<false><<<(int)blocks, THREADS, 0, s>>>(
        x, out, n, sd, rd, site, call, threshold, scale, row_len, row_mul,
        row_add, vec);
  return static_cast<int>(cudaGetLastError());
}

// Test entry: Philox4x32-10 of m rows of (counter[4], key[2]) uint32 words
// in device memory -> m rows of 4 output words.
extern "C" int fabind_philox4x32(const void* in, void* out, int m,
                                 void* stream) {
  if (!in || !out || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  philox_kernel<<<(m + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), m);
  return static_cast<int>(cudaGetLastError());
}
