// Hand-written Hopper (sm_90a) kernels for the lookup-based (LB) and
// direct-map BNN (DM) Planter pipelines: lb_lookup (per-feature LUT gather
// + addition tree) and bnn_popcount_matmul (XNOR + popcount layer, paper
// Eq. 8).
//
// Plain C interface, loaded from Python with ctypes.  Every entry launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported by the caller.
//
// Integer contract (bitwise with the plain versions in ../ref.py):
//   lb_lookup:  out[b, k] = sum_f luts[f, codes[b, f], k], summed in 32 bits
//               with two's-complement wrap (the plain version sums in int64
//               and casts back to int32, which wraps the same way).  A
//               code outside [0, V) adds 0, as in the Pallas kernel's
//               one-hot product: a predicate on the load, never a read
//               outside the LUT (the LB predictor clips its codes first).
//   bnn:        counts[b, n] = sum_w popcount(~(x[b, w] ^ w[n, w])) over
//               every word as it is: pad bits (zero in x and in w) count as
//               matches.  Two modes of the same kernel fuse the layer's
//               neighbours in:
//               * input prologue: x is the int32 features [B, F] and the
//                 row's words are built in registers, bit f*in_bits + j =
//                 bit j of x[b, f], LSB-first, pad bits zero;
//               * epilogue: dot = 2*(counts - (32*W - n_in)) - n_in; a hidden
//                 layer packs its N signs (dot >= 0) LSB-first into
//                 [B, ceil(N/32)] words, pad bits zero, the last layer writes
//                 dot [B, N] int32; neither writes the counts.
//
// lb_lookup walks tiles of R consecutive batch rows (grid-stride, so a small
// LUT staged in shared memory is loaded once per block); it stages the
// tile's codes with coalesced loads, then its threads take the tile's R * K
// outputs with the output column fastest.
//
// bnn_popcount_matmul is bound on this card by device-memory bytes in the
// counts mode (the [B, N] int32 counts are most of them) and, in the fused
// modes, by the integer pipes (B*N*W popcounts) at a few bytes a row.  A
// persistent grid sized by the occupancy calculator stages the [N, W]
// weights once per block in shared memory (read through the cache past
// 48 KB), which a warp reads as broadcasts or 8/16-byte vectors.  A thread
// holds its row's W words in registers (one vector load, W <= 8 compiled
// per W; wider rows go in chunks of 8 words, rebuilt per output group) and
// makes 4 consecutive outputs of it per step with no division or modulo:
// in the counts mode one thread per 4-output piece, consecutive threads on
// consecutive 16-byte stores; in the fused modes one thread per row, so that
// it owns the row's sign bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory kept at or under the 48 KB that needs no opt-in.
constexpr int kSmemBytes = 48 * 1024;
// lb_lookup: share of it for the staged input rows of one tile.
constexpr int kRowSmemBytes = 16 * 1024;
// lb_lookup: outputs one tile aims at (about four per thread).
constexpr int kTileOutputs = 4 * kThreads;
// lb_lookup: resident blocks per SM the grid is sized for.
constexpr int kBlocksPerSm = 4;
// bnn: words of a row a thread holds in registers at once (256 bits).
constexpr int kRowWords = 8;
// bnn: what one launch computes.
constexpr int kCounts = 0, kSigns = 1, kScores = 2;

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 132;
  return sms;
}

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
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    cached_dev = dev;
    cached_smem = smem;
    cap = sm_count() * per_sm;
  }
  const long long need = (items + kThreads - 1) / kThreads;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// ------------------------------------------------------------- lb_lookup
// The [F, V, K] LUT sits in shared memory when it fits beside the codes
// tile; past that budget it is read through the cache.
__global__ void lb_lookup_kernel(const int32_t* __restrict__ codes,
                                 const int32_t* __restrict__ luts,
                                 int32_t* __restrict__ out, int B, int F, int V,
                                 int K, int R, int lut_in_smem) {
  extern __shared__ int32_t smem[];
  int32_t* s_codes = smem;
  int32_t* s_lut = smem + R * F;
  if (lut_in_smem) {
    const int n = F * V * K;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_lut[i] = luts[i];
  }
  const int32_t* lut = lut_in_smem ? s_lut : luts;
  const int n_tiles = (B + R - 1) / R;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * R;
    const int rows = (int)min((long long)R, (long long)B - r0);
    __syncthreads();  // the LUT is staged; the last tile's readers are done
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x)
      s_codes[i] = codes[r0 * F + i];
    __syncthreads();
    for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
      const int r = i / K, k = i - r * K;
      uint32_t acc = 0u;  // unsigned: the wrap is defined
      for (int f = 0; f < F; ++f) {
        const int code = s_codes[r * F + f];
        if ((unsigned)code < (unsigned)V)  // else the code adds 0
          acc += (uint32_t)lut[(f * V + code) * K + k];
      }
      out[r0 * K + i] = (int32_t)acc;
    }
  }
}

// --------------------------------------------------- bnn_popcount_matmul
struct BnnArgs {
  const int32_t* x;   // packed rows [B, W], or features [B, F]
  const uint32_t* w;  // packed weights [N, W]
  int32_t* out;       // counts or scores [B, N], or sign words [B, ceil(N/32)]
  int B, N, W, F, in_bits, n_in, w_in_smem;
};

// ``n`` words from ``p`` into ``dst``: 16- or 8-byte vectors when the word
// count, known at compile time, allows them (the caller keeps ``p``
// aligned to them), else one word at a time.
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* p,
                                           uint32_t (&dst)[kRowWords]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NW; j += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + j);
      dst[j] = v.x, dst[j + 1] = v.y, dst[j + 2] = v.z, dst[j + 3] = v.w;
    }
  } else if constexpr (NW % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + j);
      dst[j] = v.x, dst[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) dst[j] = p[j];
  }
}

// Words [c0, c0 + nw) of row r's input into xr[0, nw), the rest of xr zero.
// WT > 0: the whole row is W = WT words (c0 = 0).  WT = 0: a chunk of up to
// kRowWords words of a wider row.
template <bool FEATURES, int WT>
__device__ __forceinline__ void load_row(const BnnArgs& a, long long r, int c0,
                                         int nw, uint32_t (&xr)[kRowWords]) {
  constexpr int NW = WT > 0 ? WT : kRowWords;
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) xr[j] = 0u;
  if constexpr (!FEATURES) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(a.x) + r * a.W + c0;
    if constexpr (WT > 0) {
      load_words<WT>(p, xr);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (j < nw) xr[j] = p[j];
    }
  } else {
    // the in_bits-wide fields of the row's features, concatenated: the
    // field of feature f sits at bit ``off`` of the chunk (negative when it
    // starts in the chunk before); each word takes its part by a shift
    const int in_bits = a.in_bits, span = 32 * nw;
    const uint32_t mask = in_bits >= 32 ? 0xFFFFFFFFu : (1u << in_bits) - 1u;
    int f = WT > 0 ? 0 : (32 * c0) / in_bits;  // one division per chunk
    int off = f * in_bits - 32 * c0;
    const int32_t* p = a.x + r * a.F;
    for (; f < a.F && off < span; ++f, off += in_bits) {
      const uint32_t v = (uint32_t)p[f] & mask;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int s = off - 32 * j;
        if (s >= 0 && s < 32)
          xr[j] |= v << s;
        else if (s < 0 && s > -32)
          xr[j] |= v >> -s;
      }
    }
  }
}

// Matching bits of the row chunk against words [c0, c0 + nw) of weight row
// ``wr`` (which points at word c0).
template <int WT>
__device__ __forceinline__ int matches(const uint32_t (&xr)[kRowWords],
                                       const uint32_t* wr, int nw) {
  constexpr int NW = WT > 0 ? WT : kRowWords;
  uint32_t wv[kRowWords];
  if constexpr (WT > 0) {
    load_words<WT>(wr, wv);
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) wv[j] = j < nw ? wr[j] : 0u;
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (WT > 0 || j < nw) c += __popc(~(xr[j] ^ wv[j]));
  return c;
}

// Counts of outputs n0 .. n0 + nk - 1 (nk <= 4) of row r, all W words.
template <bool FEATURES, int WT>
__device__ __forceinline__ void group_counts(const BnnArgs& a,
                                             const uint32_t* wt, long long r,
                                             int n0, int nk,
                                             uint32_t (&xr)[kRowWords],
                                             bool row_loaded, int (&cnt)[4]) {
  const int W = WT > 0 ? WT : a.W;
#pragma unroll
  for (int k = 0; k < 4; ++k) cnt[k] = 0;
  for (int c0 = 0; c0 < W; c0 += kRowWords) {  // one chunk when WT > 0
    const int nw = WT > 0 ? WT : min(kRowWords, W - c0);
    if (!row_loaded) load_row<FEATURES, WT>(a, r, c0, nw, xr);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nk) cnt[k] += matches<WT>(xr, wt + (long long)(n0 + k) * W + c0, nw);
  }
}

// The [N, W] weights in shared memory once per block, or the global copy.
__device__ __forceinline__ const uint32_t* stage_weights(const BnnArgs& a,
                                                         uint32_t* s_w) {
  if (!a.w_in_smem) return a.w;
  const int n = a.N * a.W;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_w[i] = a.w[i];
  __syncthreads();
  return s_w;
}

// Counts mode: one thread per piece (row r, outputs 4g .. 4g + 3), pieces
// in row-major order, so consecutive threads store consecutive 16 bytes.
template <bool FEATURES, int WT>
__global__ void __launch_bounds__(kThreads)
    bnn_counts_kernel(const BnnArgs a) {
  extern __shared__ __align__(16) uint32_t usmem[];
  const uint32_t* wt = stage_weights(a, usmem);
  const int G = (a.N + 3) / 4;
  const long long pieces = (long long)a.B * G;
  const long long p0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // (r, g) of the piece, advanced by the stride: no division per piece
  long long r = p0 / G;
  int g = (int)(p0 - r * G);
  const long long dr = stride / G;
  const int dg = (int)(stride - dr * G);
  const bool vec = (a.N & 3) == 0;
  uint32_t xr[kRowWords];
  int cnt[4];
  for (long long p = p0; p < pieces; p += stride) {
    const int n0 = 4 * g, nk = min(4, a.N - n0);
    group_counts<FEATURES, WT>(a, wt, r, n0, nk, xr, false, cnt);
    int32_t* o = a.out + r * a.N + n0;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nk) o[k] = cnt[k];
    }
    g += dg;
    r += dr;
    if (g >= G) g -= G, ++r;
  }
}

// Fused modes: one thread per row, all N outputs in groups of 4; the signs
// are packed as they come, a word stored each 32 outputs.
template <bool FEATURES, int WT, int OUT>
__global__ void __launch_bounds__(kThreads) bnn_rows_kernel(const BnnArgs a) {
  extern __shared__ __align__(16) uint32_t usmem[];
  const uint32_t* wt = stage_weights(a, usmem);
  const int W = WT > 0 ? WT : a.W;
  const int pad = 32 * W - a.n_in;
  // dot = 2*(count - pad) - n_in >= 0  <=>  count >= pad + ceil(n_in / 2)
  const int sign_at = pad + ((a.n_in + 1) >> 1);
  const int n_words = (a.N + 31) / 32;
  const bool vec = (a.N & 3) == 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  uint32_t xr[kRowWords];
  int cnt[4];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a.B;
       r += stride) {
    if constexpr (WT > 0) load_row<FEATURES, WT>(a, r, 0, W, xr);
    uint32_t word = 0u;
    for (int n0 = 0; n0 < a.N; n0 += 4) {
      const int nk = min(4, a.N - n0);
      group_counts<FEATURES, WT>(a, wt, r, n0, nk, xr, WT > 0, cnt);
      if constexpr (OUT == kScores) {
        int dot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) dot[k] = 2 * (cnt[k] - pad) - a.n_in;
        int32_t* o = a.out + r * a.N + n0;
        if (vec) {
          *reinterpret_cast<int4*>(o) = make_int4(dot[0], dot[1], dot[2], dot[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < nk) o[k] = dot[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k < nk) word |= (uint32_t)(cnt[k] >= sign_at) << ((n0 + k) & 31);
        if (((n0 + 4) & 31) == 0 || n0 + 4 >= a.N) {
          a.out[r * n_words + (n0 >> 5)] = (int32_t)word;
          word = 0u;
        }
      }
    }
  }
}

template <bool FEATURES, int WT, int OUT>
int launch_bnn(const BnnArgs& a, size_t smem, cudaStream_t stream) {
  if constexpr (OUT == kCounts) {
    constexpr auto kernel = bnn_counts_kernel<FEATURES, WT>;
    const long long pieces = (long long)a.B * ((a.N + 3) / 4);
    kernel<<<persistent_grid<kernel>(pieces, smem), kThreads, smem, stream>>>(
        a);
  } else {
    constexpr auto kernel = bnn_rows_kernel<FEATURES, WT, OUT>;
    kernel<<<persistent_grid<kernel>(a.B, smem), kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool FEATURES, int OUT>
int launch_bnn_w(const BnnArgs& a, size_t smem, cudaStream_t s) {
  switch (a.W) {
    case 1: return launch_bnn<FEATURES, 1, OUT>(a, smem, s);
    case 2: return launch_bnn<FEATURES, 2, OUT>(a, smem, s);
    case 3: return launch_bnn<FEATURES, 3, OUT>(a, smem, s);
    case 4: return launch_bnn<FEATURES, 4, OUT>(a, smem, s);
    case 5: return launch_bnn<FEATURES, 5, OUT>(a, smem, s);
    case 6: return launch_bnn<FEATURES, 6, OUT>(a, smem, s);
    case 7: return launch_bnn<FEATURES, 7, OUT>(a, smem, s);
    case 8: return launch_bnn<FEATURES, 8, OUT>(a, smem, s);
    default: return launch_bnn<FEATURES, 0, OUT>(a, smem, s);
  }
}

template <bool FEATURES>
int launch_bnn_mode(const BnnArgs& a, int mode, size_t smem, cudaStream_t s) {
  switch (mode) {
    case kCounts: return launch_bnn_w<FEATURES, kCounts>(a, smem, s);
    case kSigns: return launch_bnn_w<FEATURES, kSigns>(a, smem, s);
    case kScores: return launch_bnn_w<FEATURES, kScores>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Rows per tile: about kTileOutputs outputs, inputs within kRowSmemBytes.
int tile_rows(int B, int in_cols, int out_cols) {
  int R = kTileOutputs / (out_cols > 0 ? out_cols : 1);
  const int cap = kRowSmemBytes / (4 * (in_cols > 0 ? in_cols : 1));
  if (R > cap) R = cap;
  if (R > B) R = B;
  return R < 1 ? 1 : R;
}

int grid_for(int B, int R) {
  static int sms = 0;
  if (sms == 0) sms = sm_count();
  const long long tiles = ((long long)B + R - 1) / R;
  const long long cap = (long long)sms * kBlocksPerSm;
  return (int)(tiles < cap ? tiles : cap);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int lb_lookup(const int32_t* codes, const int32_t* luts, int32_t* out, int B,
              int F, int V, int K, void* stream) {
  if (B == 0 || K == 0) return (int)cudaGetLastError();
  if (F < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int R = tile_rows(B, F, K);
  const long long row_bytes = (long long)R * F * 4;
  const long long lut_bytes = (long long)F * V * K * 4;
  const int lut_in_smem = row_bytes + lut_bytes <= kSmemBytes ? 1 : 0;
  const size_t smem = (size_t)(row_bytes + (lut_in_smem ? lut_bytes : 0));
  lb_lookup_kernel<<<grid_for(B, R), kThreads, smem, (cudaStream_t)stream>>>(
      codes, luts, out, B, F, V, K, R, lut_in_smem);
  return (int)cudaGetLastError();
}

// x: packed rows [B, W] (in_bits == 0) or int32 features [B, F] with W ==
// ceil(F * in_bits / 32) (1 <= in_bits <= 32); mode 0 writes the counts
// [B, N], 1 the sign words [B, ceil(N / 32)], 2 the scores [B, N].
int bnn_popcount_matmul(const int32_t* x, const uint32_t* w, int32_t* out,
                        int B, int N, int W, int F, int in_bits, int n_in,
                        int mode, void* stream) {
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  if (W < 1 || in_bits < 0 || in_bits > 32 ||
      (in_bits > 0 && (F < 1 || (long long)F * in_bits > 32LL * W)))
    return (int)cudaErrorInvalidValue;
  const long long w_bytes = (long long)N * W * 4;
  const int w_in_smem = w_bytes <= kSmemBytes ? 1 : 0;
  const BnnArgs a{x, w, out, B, N, W, F, in_bits, n_in, w_in_smem};
  const size_t smem = w_in_smem ? (size_t)w_bytes : 0;
  cudaStream_t s = (cudaStream_t)stream;
  return in_bits > 0 ? launch_bnn_mode<true>(a, mode, smem, s)
                     : launch_bnn_mode<false>(a, mode, smem, s);
}

}  // extern "C"
