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
//                 INT32_MAX padding included (so v == INT32_MAX counts it),
//                 for any row.  bucketize binary-searches the rows that are
//                 non-decreasing (every row the EB mappers make) and
//                 compare-counts the others, which each block finds while
//                 it stages the rows; fused_eb counts every column;
//   match: best = max over rows n with (key & m[n]) == v[n] in every word
//          of pa[n] = prio * 256 + action, starting at -1; the result is
//          best & 255 when best >= 0, else the default action.
// Priorities are unique, so the max does not depend on the row order.
//
// bucketize is bound on this card by device-memory bytes (B*F int32 in and
// out) once its work is log2(T) compares an element: a persistent grid
// stages the [F, T] rows once per block in shared memory (opting in past
// 48 KB, read through L1 past kThrSmemMaxBytes) and, in one pass over the
// staged F x T, marks each row that decreases somewhere in a bit of shared
// memory.  Each thread takes 4 consecutive flat elements with one 16-byte
// load and store, and runs four interleaved branchless upper_bound
// searches, its feature index advanced by the grid stride rather than
// taken modulo F; an element of a marked row is compare-counted over all T
// columns instead, and a block that marked none skips that check.  No host
// check, no sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory kept at or under the 48 KB that needs no opt-in.
constexpr int kSmemBytes = 48 * 1024;
// fused_eb stages the thresholds in shared memory when they fit this share.
constexpr int kThrSmemBytes = 16 * 1024;
// bucketize stages its rows in shared memory up to this size (two blocks an
// SM); larger rows are read through L1.
constexpr int kThrSmemMaxBytes = 96 * 1024;
// Widest key the kernels take, in 32-bit words (1024-bit keys).
constexpr int kMaxWords = 32;

// ------------------------------------------------------------- bucketize
// A grid that covers ``items`` threads' work, capped at what stays resident
// on every SM at once (persistent blocks; the kernel grid-strides).  The
// cap is asked of the occupancy calculator once per kernel, device and
// shared-memory size, not at every launch.
template <auto Kernel>
int persistent_grid(long long items, size_t smem) {
  static int cached_dev = -1, cap = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached_dev = dev;
    cached_smem = smem;
    cap = sms * per_sm;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// One thread per 4 consecutive flat elements of values [B*F] (VEC: one
// 16-byte load and store, the last partial quad element by element).
// Element e belongs to feature e % F, tracked incrementally.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    bucketize_kernel(const int32_t* __restrict__ values,
                     const int32_t* __restrict__ thr, int32_t* __restrict__ out,
                     long long total, int F, int T, int thr_in_smem) {
  extern __shared__ __align__(16) int32_t bk_smem[];
  // [ceil(F/32)] bit f: row f decreases somewhere; then the staged rows
  uint32_t* s_unsorted = reinterpret_cast<uint32_t*>(bk_smem);
  const int n_flag = (F + 31) / 32;
  int32_t* s_thr = bk_smem + ((n_flag + 3) & ~3);  // 16-byte aligned
  __shared__ int s_any;  // some row decreases somewhere
  const int n_thr = F * T;
  if (threadIdx.x == 0) s_any = 0;
  for (int i = threadIdx.x; i < n_flag; i += blockDim.x) s_unsorted[i] = 0u;
  if (thr_in_smem)
    for (int i = threadIdx.x; i < n_thr; i += blockDim.x) s_thr[i] = thr[i];
  __syncthreads();
  const int32_t* rows = thr_in_smem ? s_thr : thr;
  // one pass over F x T: a column below its left neighbour marks its row
  for (int i = threadIdx.x; i < n_thr; i += blockDim.x) {
    const int t = i % T;
    if (t > 0 && rows[i] < rows[i - 1]) {
      atomicOr(&s_unsorted[i / T / 32], 1u << (i / T % 32));
      s_any = 1;
    }
  }
  __syncthreads();
  const bool any_unsorted = s_any != 0;  // uniform: sorted rows skip marks
  const long long n_quads = (total + 3) / 4;
  const long long q0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int f = (int)((4 * q0) % F);             // feature of element 4 * q
  const int df = (int)((4 * stride) % F);  // its advance per step
  for (long long q = q0; q < n_quads; q += stride) {
    const long long e0 = 4 * q;
    const bool full = e0 + 4 <= total;
    int v[4];
    if (VEC && full) {
      const int4 t = *reinterpret_cast<const int4*>(values + e0);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = e0 + k < total ? values[e0 + k] : 0;
    }
    int row[4], base[4], feat[4];
#pragma unroll
    for (int k = 0, fk = f; k < 4; ++k) {
      feat[k] = fk;
      row[k] = base[k] = fk * T;
      if (++fk == F) fk = 0;
    }
    // upper_bound: the answer lies in [base, base + n]; halve n each step
    for (int n = T; n > 1;) {
      const int half = n >> 1;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        base[k] += rows[base[k] + half] <= v[k] ? half : 0;
      n -= half;
    }
    int c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = base[k] - row[k] + (rows[base[k]] <= v[k] ? 1 : 0);
      if (any_unsorted && (s_unsorted[feat[k] / 32] >> (feat[k] % 32) & 1u)) {
        c[k] = 0;
        for (int t = 0; t < T; ++t) c[k] += rows[row[k] + t] <= v[k] ? 1 : 0;
      }
    }
    if (VEC && full) {
      *reinterpret_cast<int4*>(out + e0) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e0 + k < total) out[e0 + k] = c[k];
    }
    f += df;
    if (f >= F) f -= F;
  }
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

// The rows go to shared memory up to kThrSmemMaxBytes (opting in past
// 48 KB), else the kernel reads them through L1; the row marks (one bit a
// row, padded to 16 bytes) always sit in shared memory.
template <bool VEC>
int launch_bucketize(const int32_t* values, const int32_t* thr, int32_t* out,
                     long long total, int F, int T, cudaStream_t s) {
  constexpr auto kernel = bucketize_kernel<VEC>;
  const long long thr_bytes = (long long)F * T * 4;
  const long long flag_bytes = 16LL * ((F + 127) / 128);
  int dev = 0, optin = kSmemBytes;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (flag_bytes > optin || thr_bytes > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int thr_in_smem =
      thr_bytes <= kThrSmemMaxBytes && flag_bytes + thr_bytes <= optin ? 1 : 0;
  const size_t smem = (size_t)flag_bytes + (thr_in_smem ? (size_t)thr_bytes : 0);
  if (smem > (size_t)kSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<persistent_grid<kernel>((total + 3) / 4, smem), kThreads, smem,
           s>>>(values, thr, out, total, F, T, thr_in_smem);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (total == 0) return (int)cudaGetLastError();
  if (T == 0) return (int)cudaMemsetAsync(out, 0, (size_t)total * 4, s);
  if ((uintptr_t)values % 16 == 0 && (uintptr_t)out % 16 == 0)
    return launch_bucketize<true>(values, thr, out, total, F, T, s);
  return launch_bucketize<false>(values, thr, out, total, F, T, s);
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
