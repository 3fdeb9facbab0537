// Hand-written Hopper (sm_90a) kernels for the encode-based (EB) Planter
// pipeline: bucketize (feature encode), ternary_match (TCAM decision
// table) and fused_eb (encode + pack + match in one launch).
//
// Plain C interface, loaded from Python with ctypes.  Every entry launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported by the caller.
//
// Integer contract (bitwise with the plain versions in ../ref.py):
//   codes[b, f] = #{t : thr[f, t] <= v[b, f]} over ALL T columns, the
//                 INT32_MAX padding included (so v == INT32_MAX counts it);
//   match: best = max over rows n with (key & m[n]) == v[n] in every word
//          of pa[n] = prio * 256 + action, starting at -1; the result is
//          best & 255 when best >= 0, else the default action.
// Priorities are unique, so the max does not depend on the row order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory kept at or under the 48 KB that needs no opt-in.
constexpr int kSmemBytes = 48 * 1024;
// fused_eb stages the thresholds in shared memory when they fit this share.
constexpr int kThrSmemBytes = 16 * 1024;
// Widest key the kernels take, in 32-bit words (1024-bit keys).
constexpr int kMaxWords = 32;

// ------------------------------------------------------------- bucketize
// One thread per (b, f).  The block walks the flattened [F*T] threshold
// array in shared-memory tiles; each thread counts the part of its own
// feature's row that falls inside the tile.
__global__ void bucketize_kernel(const int32_t* __restrict__ values,
                                 const int32_t* __restrict__ thr,
                                 int32_t* __restrict__ out,
                                 long long total, int F, int T, int tile) {
  extern __shared__ int32_t s_thr[];
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = idx < total;
  const int f = active ? (int)(idx % F) : 0;
  const int32_t v = active ? values[idx] : 0;
  const int row_lo = f * T, row_hi = row_lo + T;
  const int n_thr = F * T;
  int count = 0;
  for (int base = 0; base < n_thr; base += tile) {
    const int len = min(tile, n_thr - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) s_thr[i] = thr[base + i];
    __syncthreads();
    const int lo = max(row_lo, base), hi = min(row_hi, base + len);
    for (int i = lo; i < hi; ++i) count += (v >= s_thr[i - base]);
  }
  if (active) out[idx] = count;
}

// ------------------------------------------------------------ row match
// Stage rows [base, base + len) of (values, masks, prio_action) into shared
// memory; the caller synchronises.
__device__ __forceinline__ void stage_rows(const uint32_t* __restrict__ rv,
                                           const uint32_t* __restrict__ rm,
                                           const int32_t* __restrict__ pa,
                                           uint32_t* s_v, uint32_t* s_m,
                                           int32_t* s_pa, int base, int len,
                                           int W) {
  const int words = len * W;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    s_v[i] = rv[(long long)base * W + i];
    s_m[i] = rm[(long long)base * W + i];
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) s_pa[i] = pa[base + i];
}

// Running priority-max of one key over one staged tile.  WT > 0 fixes the
// word count at compile time (key in registers); WT == 0 reads W at run time.
template <int WT>
__device__ __forceinline__ int32_t match_tile(const uint32_t* key,
                                              const uint32_t* s_v,
                                              const uint32_t* s_m,
                                              const int32_t* s_pa, int len,
                                              int W, int32_t best) {
  const int nw = WT > 0 ? WT : W;
  for (int n = 0; n < len; ++n) {
    bool hit = true;
#pragma unroll
    for (int w = 0; w < (WT > 0 ? WT : kMaxWords); ++w) {
      if (WT == 0 && w >= nw) break;
      hit &= (key[w] & s_m[n * nw + w]) == s_v[n * nw + w];
    }
    if (hit) best = max(best, s_pa[n]);
  }
  return best;
}

// Walk all N rows in shared-memory tiles for this thread's key.
template <int WT>
__device__ __forceinline__ int32_t match_rows(const uint32_t* key,
                                              const uint32_t* __restrict__ rv,
                                              const uint32_t* __restrict__ rm,
                                              const int32_t* __restrict__ pa,
                                              uint32_t* s_v, uint32_t* s_m,
                                              int32_t* s_pa, int N, int W,
                                              int tile_n) {
  int32_t best = -1;
  for (int base = 0; base < N; base += tile_n) {
    const int len = min(tile_n, N - base);
    __syncthreads();
    stage_rows(rv, rm, pa, s_v, s_m, s_pa, base, len, W);
    __syncthreads();
    best = match_tile<WT>(key, s_v, s_m, s_pa, len, W, best);
  }
  return best;
}

// --------------------------------------------------------- ternary_match
// One thread per key row; the running max lives in a register and the
// row tiles loop inside the block (blocks run in no order on the card).
template <int WT>
__global__ void ternary_match_kernel(const uint32_t* __restrict__ keys,
                                     const uint32_t* __restrict__ rv,
                                     const uint32_t* __restrict__ rm,
                                     const int32_t* __restrict__ pa,
                                     int32_t* __restrict__ out, int B, int N,
                                     int W, int tile_n, int default_action) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_v = smem;
  uint32_t* s_m = s_v + tile_n * W;
  int32_t* s_pa = reinterpret_cast<int32_t*>(s_m + tile_n * W);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  uint32_t key[WT > 0 ? WT : kMaxWords];
  const int nw = WT > 0 ? WT : W;
#pragma unroll
  for (int w = 0; w < (WT > 0 ? WT : kMaxWords); ++w) {
    if (WT == 0 && w >= nw) break;
    key[w] = active ? keys[(long long)b * nw + w] : 0u;
  }
  const int32_t best = match_rows<WT>(key, rv, rm, pa, s_v, s_m, s_pa, N, W,
                                      tile_n);
  if (active) out[b] = best >= 0 ? (best & 255) : default_action;
}

// -------------------------------------------------------------- fused_eb
// One thread per row: F codes against the thresholds (shared memory when
// they fit kThrSmemBytes, else read through the cache), packed into W key
// words by the (word, off, width) layout, then matched against the rows in
// shared-memory tiles.  identity != 0 takes the raw values as the codes
// (KM/KNN quadtree tables).
template <int WT>
__global__ void fused_eb_kernel(const int32_t* __restrict__ values,
                                const int32_t* __restrict__ thr,
                                const uint32_t* __restrict__ rv,
                                const uint32_t* __restrict__ rm,
                                const int32_t* __restrict__ pa,
                                const int32_t* __restrict__ layout,
                                int32_t* __restrict__ out, int B, int F, int T,
                                int N, int W, int identity, int thr_in_smem,
                                int tile_n, int default_action) {
  extern __shared__ uint32_t smem[];
  int32_t* s_layout = reinterpret_cast<int32_t*>(smem);
  int32_t* s_thr = s_layout + 3 * F;
  uint32_t* s_v =
      reinterpret_cast<uint32_t*>(s_thr + (thr_in_smem ? F * T : 0));
  uint32_t* s_m = s_v + tile_n * W;
  int32_t* s_pa = reinterpret_cast<int32_t*>(s_m + tile_n * W);

  for (int i = threadIdx.x; i < 3 * F; i += blockDim.x) s_layout[i] = layout[i];
  if (thr_in_smem && !identity)
    for (int i = threadIdx.x; i < F * T; i += blockDim.x) s_thr[i] = thr[i];
  __syncthreads();
  const int32_t* t_src = thr_in_smem ? s_thr : thr;

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const int nw = WT > 0 ? WT : W;
  uint32_t key[WT > 0 ? WT : kMaxWords];
#pragma unroll
  for (int w = 0; w < (WT > 0 ? WT : kMaxWords); ++w) key[w] = 0u;
  if (active) {
    for (int f = 0; f < F; ++f) {
      const int32_t v = values[(long long)b * F + f];
      uint32_t code;
      if (identity) {
        code = (uint32_t)v;
      } else {
        int count = 0;
        for (int t = 0; t < T; ++t) count += (v >= t_src[f * T + t]);
        code = (uint32_t)count;
      }
      const int word = s_layout[3 * f], off = s_layout[3 * f + 1];
      const int width = s_layout[3 * f + 2];
      const uint32_t field = code & (width >= 32 ? 0xFFFFFFFFu
                                                 : ((1u << width) - 1u));
#pragma unroll
      for (int w = 0; w < (WT > 0 ? WT : kMaxWords); ++w) {
        if (WT == 0 && w >= nw) break;
        if (w == word) key[w] |= field << off;
      }
    }
  }
  const int32_t best = match_rows<WT>(key, rv, rm, pa, s_v, s_m, s_pa, N, W,
                                      tile_n);
  if (active) out[b] = best >= 0 ? (best & 255) : default_action;
}

int row_tile(int N, int W, int budget) {
  const int per_row = 8 * W + 4;
  int tile = budget / per_row;
  if (tile > N) tile = N;
  return tile < 1 ? 1 : tile;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int eb_bucketize(const int32_t* values, const int32_t* thr, int32_t* out,
                 int B, int F, int T, void* stream) {
  const long long total = (long long)B * F;
  if (total == 0) return (int)cudaGetLastError();
  int tile = kSmemBytes / 4;
  if (tile > F * T) tile = F * T;
  bucketize_kernel<<<blocks_for(total), kThreads, tile * 4,
                     (cudaStream_t)stream>>>(values, thr, out, total, F, T,
                                             tile);
  return (int)cudaGetLastError();
}

int eb_ternary_match(const uint32_t* keys, const uint32_t* rv,
                     const uint32_t* rm, const int32_t* pa, int32_t* out,
                     int B, int N, int W, int default_action, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (W < 1 || W > kMaxWords || N < 1) return (int)cudaErrorInvalidValue;
  const int tile_n = row_tile(N, W, kSmemBytes);
  const size_t smem = (size_t)tile_n * (8 * W + 4);
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(B);
  switch (W) {
#define EB_TM(WC)                                                        \
  case WC:                                                               \
    ternary_match_kernel<WC><<<grid, kThreads, smem, s>>>(               \
        keys, rv, rm, pa, out, B, N, W, tile_n, default_action);         \
    break;
    EB_TM(1) EB_TM(2) EB_TM(3) EB_TM(4)
#undef EB_TM
    default:
      ternary_match_kernel<0><<<grid, kThreads, smem, s>>>(
          keys, rv, rm, pa, out, B, N, W, tile_n, default_action);
  }
  return (int)cudaGetLastError();
}

int eb_fused(const int32_t* values, const int32_t* thr, const uint32_t* rv,
             const uint32_t* rm, const int32_t* pa, const int32_t* layout,
             int32_t* out, int B, int F, int T, int N, int W, int identity,
             int default_action, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  if (W < 1 || W > kMaxWords || N < 1) return (int)cudaErrorInvalidValue;
  const int thr_bytes = F * T * 4;
  const int thr_in_smem = (!identity && thr_bytes <= kThrSmemBytes) ? 1 : 0;
  const int fixed = 3 * F * 4 + (thr_in_smem ? thr_bytes : 0);
  const int tile_n = row_tile(N, W, kSmemBytes - fixed);
  const size_t smem = (size_t)fixed + (size_t)tile_n * (8 * W + 4);
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = blocks_for(B);
  switch (W) {
#define EB_FU(WC)                                                         \
  case WC:                                                                \
    fused_eb_kernel<WC><<<grid, kThreads, smem, s>>>(                     \
        values, thr, rv, rm, pa, layout, out, B, F, T, N, W, identity,    \
        thr_in_smem, tile_n, default_action);                             \
    break;
    EB_FU(1) EB_FU(2) EB_FU(3) EB_FU(4)
#undef EB_FU
    default:
      fused_eb_kernel<0><<<grid, kThreads, smem, s>>>(
          values, thr, rv, rm, pa, layout, out, B, F, T, N, W, identity,
          thr_in_smem, tile_n, default_action);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
