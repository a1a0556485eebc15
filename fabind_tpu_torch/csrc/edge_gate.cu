// InterAttention coordinate gate for NVIDIA Hopper (sm_90a), both attention
// directions of one layer in one launch.
//
//   phi_ab[b, i, j] = sum_h w2[h] * act(l1_b[b, j, h] + r[b, i, j] * u[h])
//   phi_ba[b, j, i] = sum_h w2[h] * act(l1_a[b, i, h] + r[b, i, j] * u[h])
//   act in {silu, relu}; l1_a [B, Na, H], l1_b [B, Nb, H], r [B, Na, Nb],
//   u [H], w2 [H] -> phi_ab [B, Na, Nb], phi_ba [B, Nb, Na]
//
// With l1_a and phi_ba null it computes phi_ab alone: the one-direction gate
// phi[b, d, n] = sum_h w2[h] * act(l1_v[b, n, h] + r[b, d, n] * u[h]).
//
// Replaces the TPU kernel phi_rank1_pallas
// (fabind_tpu/ops/pallas/edge_gate.py, pl.pallas_call at :63, body _kernel
// at :41-49), which the JAX model calls once per direction. Like it, the [B, Na, Nb, H] pre-activation never exists
// in memory. Here r is read once, in its [B, Na, Nb] layout, for both
// directions, and no transposed copy of it is made.
//
// What bounds it on the H100: the special-function units (MUFU). Each silu
// gate element costs one ex2 and one reciprocal there, and an SM retires 16
// MUFU results per clock against 128 fp32 FMAs; the other work per element
// is 5 fp32 operations, well under the FMA pipes' rate. The bytes are few
// (~3 MB per launch at the docking shape, about 1 us of HBM time). No
// tensor-core form exists: the activation sits between the rank-1 broadcast
// and the contraction over H, so wgmma (and the TMA pipelines built for it)
// do not apply. relu needs no MUFU and is bound by the FP32 pipes.
//
// Design:
// - Tile: a block owns TI x TJ = 8 x 16 cells of r[b] and stages the rows
//   l1_a[b, i-tile, :] and l1_b[b, j-tile, :] (fp32, all of H, row stride
//   Hp + 4 so the 8 rows a quarter-warp reads lie in 8 different bank
//   groups) plus u and w2 in dynamic shared memory. At H = 512 that is
//   ~54 KB, so 4 blocks share an SM.
// - Register blocking: warp w takes slice w of the (padded) H; lane
//   (ig, jg) = (lane / 8, lane % 8) takes cells i in {ig, ig + 4},
//   j in {jg, jg + 8}: 4 cells, 8 running sums. Per 4 values of h a thread
//   makes 6 vector shared loads (two l1_a rows, two l1_b rows, u, w2; u and
//   w2 and the l1_a rows broadcast) and evaluates 32 gate elements, in 8
//   independent chains.
// - The 8 slices are summed through shared memory in a fixed order, and each
//   thread then writes one output: phi_ab rows of 16 and phi_ba rows of 8
//   consecutive elements, so both global stores coalesce.
// - Tiles: Na = 48 and Nb in {160, 512} divide into 8 x 16 tiles, so no lane
//   of the main path is masked out of the H loop. The grid is persistent:
//   min(tiles, SMs x resident blocks per SM) blocks walk the tiles.
// - Activation: silu(x) = x * rcp(1 + 2^(-x log2 e)) with ex2.approx.ftz and
//   rcp.approx.ftz, one MUFU operation each and no IEEE slow path. For large
//   |x| it keeps F.silu's limits: 2^(+big) = inf, rcp(inf) = 0, so -> -0
//   at the negative end; 2^(-big) = 0, so -> x at the positive end; no NaN
//   for finite x. Inputs are fp32 or bf16, arithmetic fp32, outputs in r's
//   type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TI = 8;            // cells along i (rows of r) per tile
constexpr int TJ = 16;           // cells along j (columns of r) per tile
constexpr int WARPS = 8;         // H slices per tile, one per warp
constexpr int THREADS = 32 * WARPS;
constexpr int HPAD = 4 * WARPS;  // H is padded to a multiple of this
constexpr int OUTS = 8;          // running sums per thread (2 dirs x 4 cells)
constexpr float NEG_LOG2E = -1.4426950408889634f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == 0)
    return x * rcp_approx(1.0f + ex2_approx(x * NEG_LOG2E));   // silu
  else
    return fmaxf(x, 0.0f);                                     // relu
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Shared memory, in floats: a region that first holds the staged rows
// (TJ rows of l1_b, then TI rows of l1_a when PAIR) and then the partial
// sums (WARPS x OUTS x 32), followed by u and w2 (Hp each).
__host__ __device__ inline int region_floats(int Hp, bool pair) {
  const int rows = (pair ? TI + TJ : TJ) * (Hp + 4);
  const int partials = WARPS * OUTS * 32;
  return rows > partials ? rows : partials;
}

template <typename T, int ACT, bool PAIR>
__global__ void __launch_bounds__(THREADS, 4)
edge_gate_kernel(const T* __restrict__ l1_a, const T* __restrict__ l1_b,
                 const T* __restrict__ r, const T* __restrict__ u,
                 const T* __restrict__ w2, T* __restrict__ out_ab,
                 T* __restrict__ out_ba, int Na, int Nb, int H, int Hp,
                 int n_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int HS = Hp + 4;
  float* sb = smem;                       // [TJ][HS]
  float* sa = smem + TJ * HS;             // [TI][HS], PAIR only
  float* red = smem;                      // [WARPS][OUTS][32], after compute
  float* su = smem + region_floats(Hp, PAIR);
  float* sw = su + Hp;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ig = lane >> 3;               // cells i = ig, ig + 4
  const int jg = lane & 7;                // cells j = jg, jg + 8
  const int slice = Hp / WARPS;           // a multiple of 4
  const int hb = warp * slice;
  const int n_tj = (Nb + TJ - 1) / TJ;
  const int n_ti = (Na + TI - 1) / TI;

  for (int h = tid; h < Hp; h += THREADS) {
    su[h] = h < H ? load_f(u + h) : 0.0f;
    sw[h] = h < H ? load_f(w2 + h) : 0.0f;   // padded h contribute 0
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tj = tile % n_tj;
    const int ti = (tile / n_tj) % n_ti;
    const int b = tile / (n_tj * n_ti);
    const int i0 = ti * TI;
    const int j0 = tj * TJ;

    __syncthreads();  // the previous tile's partial sums have been read
    // stage rows: warp per row, lanes along h (coalesced, conflict-free)
    const T* lb = l1_b + (size_t)b * Nb * H;
    for (int row = warp; row < TJ; row += WARPS) {
      const bool ok = j0 + row < Nb;
      const T* src = lb + (size_t)(j0 + row) * H;
      for (int h = lane; h < Hp; h += 32)
        sb[row * HS + h] = ok && h < H ? load_f(src + h) : 0.0f;
    }
    if constexpr (PAIR) {
      const T* la = l1_a + (size_t)b * Na * H;
      for (int row = warp; row < TI; row += WARPS) {
        const bool ok = i0 + row < Na;
        const T* src = la + (size_t)(i0 + row) * H;
        for (int h = lane; h < Hp; h += 32)
          sa[row * HS + h] = ok && h < H ? load_f(src + h) : 0.0f;
      }
    }
    float rv[2][2];
#pragma unroll
    for (int ki = 0; ki < 2; ++ki) {
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const int i = i0 + ig + 4 * ki;
        const int j = j0 + jg + 8 * kj;
        rv[ki][kj] = i < Na && j < Nb
                         ? load_f(r + ((size_t)b * Na + i) * Nb + j)
                         : 0.0f;
      }
    }
    __syncthreads();

    float acc_ab[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float acc_ba[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    const float* pb0 = sb + jg * HS + hb;
    const float* pb1 = sb + (jg + 8) * HS + hb;
    const float* pa0 = sa + ig * HS + hb;
    const float* pa1 = sa + (ig + 4) * HS + hb;
    for (int h = 0; h < slice; h += 4) {
      const float4 U = *reinterpret_cast<const float4*>(su + hb + h);
      const float4 W = *reinterpret_cast<const float4*>(sw + hb + h);
      const float4 B0 = *reinterpret_cast<const float4*>(pb0 + h);
      const float4 B1 = *reinterpret_cast<const float4*>(pb1 + h);
      float4 A0, A1;
      if constexpr (PAIR) {
        A0 = *reinterpret_cast<const float4*>(pa0 + h);
        A1 = *reinterpret_cast<const float4*>(pa1 + h);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float uk = comp(U, k);
        const float wk = comp(W, k);
        const float bk[2] = {comp(B0, k), comp(B1, k)};
#pragma unroll
        for (int ki = 0; ki < 2; ++ki) {
#pragma unroll
          for (int kj = 0; kj < 2; ++kj) {
            const float ru = rv[ki][kj] * uk;
            acc_ab[ki][kj] =
                fmaf(wk, activate<ACT>(bk[kj] + ru), acc_ab[ki][kj]);
            if constexpr (PAIR) {
              const float ak = comp(ki == 0 ? A0 : A1, k);
              acc_ba[ki][kj] =
                  fmaf(wk, activate<ACT>(ak + ru), acc_ba[ki][kj]);
            }
          }
        }
      }
    }

    __syncthreads();  // every warp is done with the staged rows
#pragma unroll
    for (int ki = 0; ki < 2; ++ki) {
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const int o = ki * 2 + kj;
        red[(warp * OUTS + o) * 32 + lane] = acc_ab[ki][kj];
        if constexpr (PAIR)
          red[(warp * OUTS + 4 + o) * 32 + lane] = acc_ba[ki][kj];
      }
    }
    __syncthreads();

    // one output per thread, laid out for coalesced stores: threads 0-127
    // write phi_ab (8 rows of 16 j), threads 128-255 phi_ba (16 rows of 8 i)
    const bool ab = tid < TI * TJ;
    if (ab || PAIR) {
      const int t = ab ? tid : tid - TI * TJ;
      const int il = ab ? t / TJ : t % TI;
      const int jl = ab ? t % TJ : t / TI;
      const int o = (ab ? 0 : 4) + (il >> 2) * 2 + (jl >> 3);
      const int src_lane = (il & 3) * 8 + (jl & 7);
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * OUTS + o) * 32 + src_lane];
      const int i = i0 + il;
      const int j = j0 + jl;
      if (i < Na && j < Nb) {
        if (ab)
          store_f(out_ab + ((size_t)b * Na + i) * Nb + j, s);
        else
          store_f(out_ba + ((size_t)b * Nb + j) * Na + i, s);
      }
    }
  }
}

template <typename T, int ACT, bool PAIR>
cudaError_t launch(const void* l1_a, const void* l1_b, const void* r,
                   const void* u, const void* w2, void* out_ab, void* out_ba,
                   int B, int Na, int Nb, int H, cudaStream_t stream) {
  auto kernel = edge_gate_kernel<T, ACT, PAIR>;
  const int Hp = (H + HPAD - 1) / HPAD * HPAD;
  const size_t smem = sizeof(float) * (region_floats(Hp, PAIR) + 2 * Hp);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * ((Na + TI - 1) / TI) *
                          ((Nb + TJ - 1) / TJ);
  const long long slots = (long long)sms * per_sm;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(l1_a), static_cast<const T*>(l1_b),
      static_cast<const T*>(r), static_cast<const T*>(u),
      static_cast<const T*>(w2), static_cast<T*>(out_ab),
      static_cast<T*>(out_ba), Na, Nb, H, Hp, (int)tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* l1_a, const void* l1_b, const void* r,
                     const void* u, const void* w2, void* out_ab,
                     void* out_ba, int B, int Na, int Nb, int H, int act,
                     cudaStream_t s) {
  const bool pair = l1_a != nullptr;
  if (act == 0)
    return pair ? launch<T, 0, true>(l1_a, l1_b, r, u, w2, out_ab, out_ba, B,
                                     Na, Nb, H, s)
                : launch<T, 0, false>(l1_a, l1_b, r, u, w2, out_ab, out_ba,
                                      B, Na, Nb, H, s);
  return pair ? launch<T, 1, true>(l1_a, l1_b, r, u, w2, out_ab, out_ba, B,
                                   Na, Nb, H, s)
              : launch<T, 1, false>(l1_a, l1_b, r, u, w2, out_ab, out_ba, B,
                                    Na, Nb, H, s);
}

}  // namespace

// act: 0 silu, 1 relu. dtype: 0 fp32, 1 bf16 (all tensors share it).
// l1_a and out_ba both null: phi_ab alone. B * ceil(Na / 8) * ceil(Nb / 16)
// must fit in an int. Returns the first CUDA error of the set-up or the
// launch (0 on success).
extern "C" int fabind_edge_gate_pair(const void* l1_a, const void* l1_b,
                                     const void* r, const void* u,
                                     const void* w2, void* out_ab,
                                     void* out_ba, int B, int Na, int Nb,
                                     int H, int act, int dtype,
                                     void* stream) {
  if ((l1_a == nullptr) != (out_ba == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(l1_a, l1_b, r, u, w2, out_ab, out_ba, B,
                                   Na, Nb, H, act, s)
                 : dispatch<__nv_bfloat16>(l1_a, l1_b, r, u, w2, out_ab,
                                           out_ba, B, Na, Nb, H, act, s);
  return static_cast<int>(err);
}
