// Hand-written Hopper (sm_90a) kernel: the MoE block's expert down product
// and its combine in one launch,
//
//   out[m, :] = bf16( sum over e, ascending, with c[m, e] != 0, of
//                     bf16( h[m, e, :] @ W_down[e] ) * c[m, e] )
//
// with h [M, E, F], W_down [E, F, D], c [M, E] and out [M, D] bf16, every
// sum in float32.  It is JAX's "bsef,efd->bsed" rounded to bf16 followed by
// "bsed,bse->bsd" (src/repro/nn/moe.py:73-75), in the order the plain
// version (`kernels/ref.py` `moe_down_combine_ref`) fixes:
//
//   * y[m, e, d] is the chain y = y + h[m, e, f] * W[e, f, d] for f = 0, 1,
//     ..., F-1 from y = +0, each step one fmaf.  A product of two bf16
//     values is exact in float32 (16 significant bits), so each fmaf
//     rounds as the plain version's add of the product does;
//   * out[m, d] is the same chain over e = 0, 1, ..., E-1 of
//     bf16(y[m, e, d]) * c[m, e].
//
// Neither order depends on M, on the other rows or on the tiling, so a
// row's bits are a function of that row alone (chunked prefill stays
// bitwise token-by-token).  The one difference from the plain version: an
// expert whose c[m, e] is 0 adds nothing here, where the plain version adds
// 0 * y, which is the same bits for every finite y (acc + (+-0) == acc,
// and +0 + -0 == +0) but NaN for y = +-inf or NaN (ROADMAP C.10).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA.
// The port needs its own because its invariants need row-invariant
// products, which cuBLAS (bmm / einsum) does not promise.
//
// What bounds it on the H100: bytes.  A qwen2-moe step (M = 128 rows)
// reads W_down once, 369 MB a layer (0.11 ms at 3.35 TB/s); the work the
// routing asks for is M * top_k expert rows of 2 F D flops, 3 GFLOP.  The
// design does only the routed work, on the CUDA cores (the tensor cores'
// accumulation is not an IEEE chain, and the plain version must be
// reproducible bit for bit):
//   * grid (D / 128 column tiles, E experts); block (j, e) compacts the
//     rows m with c[m, e] != 0 into shared memory, 128 candidate rows at a
//     time, and computes their y over its 128 columns in groups of 16
//     rows: 128 threads, each 4 rows x 4 columns, F streamed in chunks of
//     32 through a double-buffered float32 stage of W (32 x 128) and of
//     the gathered h rows (32 x 16, transposed);
//   * each y is rounded to bf16 and written to the scratch ys[M, E, D];
//   * the last block of a column tile to finish (a per-tile counter,
//     zeroed by the caller, after a __threadfence) combines that tile for
//     every row: a warp a row at a time, a ballot over c[m, :] for the
//     experts in ascending order, the chain over their ys.
// So each expert's W slice is read once, by one block, and nothing is
// computed for an expert a tile's rows did not pick.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTD = 128;      // columns a block
constexpr int kTM = 16;       // gathered rows a group
constexpr int kFC = 32;       // F rows a stage
constexpr int kWindow = 128;  // candidate rows compacted at a time

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ bool bf_nonzero(uint16_t b) {
  return (b & 0x7fffu) != 0;
}

struct Stage {
  float w[kFC][kTD];  // W[e, f0 + f, d0 + d]
  float h[kFC][kTM];  // h[rows[r], e, f0 + f], transposed
};

// One chunk of F rows in registers between its global load and its store
// to shared memory: W as 4 x 8 bf16 a thread, h as 8 bf16 (threads < 64).
struct Regs {
  uint4 w[4];
  uint4 h;
};

__device__ __forceinline__ void load_chunk(
    Regs& r, const __nv_bfloat16* __restrict__ h,
    const __nv_bfloat16* __restrict__ W, const int* rows, int n_rows, int e,
    int E, int F, int D, int d0, int f0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + i * kThreads;  // 32 rows x 16 vectors of 8
    const int fr = idx >> 4, c8 = (idx & 15) * 8;
    const int d = d0 + c8;
    r.w[i] = make_uint4(0, 0, 0, 0);
    if (d < D)
      r.w[i] = *reinterpret_cast<const uint4*>(
          W + ((size_t)e * F + f0 + fr) * D + d);
  }
  r.h = make_uint4(0, 0, 0, 0);
  if (t < kTM * 4) {
    const int row = t >> 2, part = t & 3;
    if (row < n_rows)
      r.h = *reinterpret_cast<const uint4*>(
          h + ((size_t)rows[row] * E + e) * F + f0 + part * 8);
  }
}

__device__ __forceinline__ void store_chunk(const Regs& r, Stage& s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = t + i * kThreads;
    const int fr = idx >> 4, c8 = (idx & 15) * 8;
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r.w[i]);
    *reinterpret_cast<float4*>(&s.w[fr][c8]) =
        make_float4(bf_lo(u[0]), bf_hi(u[0]), bf_lo(u[1]), bf_hi(u[1]));
    *reinterpret_cast<float4*>(&s.w[fr][c8 + 4]) =
        make_float4(bf_lo(u[2]), bf_hi(u[2]), bf_lo(u[3]), bf_hi(u[3]));
  }
  if (t < kTM * 4) {
    const int row = t >> 2, part = t & 3;
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r.h);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s.h[part * 8 + 2 * i][row] = bf_lo(u[i]);
      s.h[part * 8 + 2 * i + 1][row] = bf_hi(u[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
moe_down_combine_kernel(const __nv_bfloat16* __restrict__ h,
                        const __nv_bfloat16* __restrict__ W,
                        const __nv_bfloat16* __restrict__ c,
                        __nv_bfloat16* __restrict__ ys,
                        int* __restrict__ counters,
                        __nv_bfloat16* __restrict__ out, int M, int E,
                        int F, int D) {
  __shared__ __align__(16) Stage stage[2];
  __shared__ int rows[kWindow];
  __shared__ int warp_n[kThreads / 32];
  __shared__ int s_last;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d0 = blockIdx.x * kTD;
  const int e = blockIdx.y;
  // thread (ty, tx): rows 4 ty .. 4 ty + 3 of the group, columns
  // 4 tx .. 4 tx + 3 of the tile; a warp spans 8 tx and the 4 ty, so its
  // stage reads are 128 contiguous bytes of W and 64 of h
  const int tx = (warp & 3) * 8 + (lane & 7), ty = lane >> 3;
  const int nchunks = F / kFC;

  for (int m0 = 0; m0 < M; m0 += kWindow) {
    // compact the window's rows that picked expert e, in ascending order
    const int m = m0 + t;
    const bool use = m < M && bf_nonzero(
        reinterpret_cast<const uint16_t*>(c)[(size_t)m * E + e]);
    const unsigned ball = __ballot_sync(0xffffffffu, use);
    if (lane == 0) warp_n[warp] = __popc(ball);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      base += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (use) rows[base + __popc(ball & ((1u << lane) - 1))] = m;
    __syncthreads();

    for (int g = 0; g < n; g += kTM) {
      const int* grows = rows + g;
      const int n_rows = min(kTM, n - g);
      float y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[i][j] = 0.0f;
      Regs r;
      load_chunk(r, h, W, grows, n_rows, e, E, F, D, d0, 0);
      store_chunk(r, stage[0]);
      __syncthreads();
      for (int k = 0; k < nchunks; ++k) {
        const bool more = k + 1 < nchunks;
        if (more)
          load_chunk(r, h, W, grows, n_rows, e, E, F, D, d0, (k + 1) * kFC);
        const Stage& s = stage[k & 1];
#pragma unroll
        for (int f = 0; f < kFC; ++f) {
          const float4 wv = *reinterpret_cast<const float4*>(&s.w[f][tx * 4]);
          const float4 hv = *reinterpret_cast<const float4*>(&s.h[f][ty * 4]);
          const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
          const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              y[i][j] = fmaf(hh[i], ww[j], y[i][j]);
        }
        if (more) store_chunk(r, stage[(k + 1) & 1]);
        __syncthreads();
      }
      const int d = d0 + tx * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
        if (row < n_rows && d < D) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(y[i][0], y[i][1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(y[i][2], y[i][3]);
          uint2 v;
          v.x = *reinterpret_cast<uint32_t*>(&lo);
          v.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(
              ys + ((size_t)grows[row] * E + e) * D + d) = v;
        }
      }
    }
    __syncthreads();  // rows[] is rewritten by the next window
  }

  // the last of the tile's E blocks combines it
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == E - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int d = d0 + lane * 4;
  const uint16_t* cb = reinterpret_cast<const uint16_t*>(c);
  for (int m = warp; m < M; m += kThreads / 32) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int ee = e0 + lane;
      const uint16_t cv = ee < E ? cb[(size_t)m * E + ee] : 0;
      unsigned picked = __ballot_sync(0xffffffffu, bf_nonzero(cv));
      while (picked) {
        const int b = __ffs(picked) - 1;
        picked &= picked - 1;
        const float cw = __uint_as_float(
            (uint32_t)__shfl_sync(0xffffffffu, cv, b) << 16);
        if (d < D) {
          const uint2 v = __ldcg(reinterpret_cast<const uint2*>(
              ys + ((size_t)m * E + e0 + b) * D + d));
          acc[0] = fmaf(bf_lo(v.x), cw, acc[0]);
          acc[1] = fmaf(bf_hi(v.x), cw, acc[1]);
          acc[2] = fmaf(bf_lo(v.y), cw, acc[2]);
          acc[3] = fmaf(bf_hi(v.y), cw, acc[3]);
        }
      }
    }
    if (d < D) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
      uint2 v;
      v.x = *reinterpret_cast<uint32_t*>(&lo);
      v.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (size_t)m * D + d) = v;
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// h [M, E, F], W [E, F, D], c [M, E], out [M, D] bf16, contiguous; ys an
// [M, E, D] bf16 scratch; counters D / 128 (rounded up) int32 zeros.  F a
// multiple of 32, D of 8 (checked by the caller).
int moe_down_combine(const void* h, const void* W, const void* c, void* ys,
                     void* counters, void* out, int M, int E, int F, int D,
                     void* stream) {
  dim3 grid((D + kTD - 1) / kTD, E);
  moe_down_combine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)W,
      (const __nv_bfloat16*)c, (__nv_bfloat16*)ys, (int*)counters,
      (__nv_bfloat16*)out, M, E, F, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
