// Hand-written Hopper (sm_90a) kernels for the lookup-based (LB) and
// direct-map BNN (DM) Planter pipelines: lb_lookup (per-feature LUT gather
// + addition tree, with the LB predict's decision fused in) and
// bnn_popcount_matmul (XNOR + popcount layer, paper Eq. 8).
//
// Plain C interface, loaded from Python with ctypes.  Every entry launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported by the caller.
//
// Integer contract (bitwise with the plain versions in ../ref.py):
//   lb_lookup, one kernel with five epilogues:
//     sums:     out[b, k] = sum_f luts[f, codes[b, f], k], summed in 32 bits
//               with two's-complement wrap.  A code outside [0, V) adds 0,
//               as in the Pallas kernel's one-hot product: a predicate on
//               the load, never a read outside the LUT.
//     argmax, argmin, ovo_vote, raw (the LB predict, core/lookup_based.py):
//               x is the raw int32 features; each is clamped to [0, V-1]
//               in registers, s[k] = bias[k] + sum_f luts[f, x_f, k] with
//               wrap, compared signed.  argmax / argmin write the label
//               [B] (first index on ties); ovo_vote votes a_m when
//               s[m] > 0, else c_m, and writes the first class with the
//               most votes; raw writes (float)s[k] / scale [B, K] float32
//               (IEEE division, __fdiv_rn).
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
// lb_lookup is bound by device-memory bytes: the [B, F] int32 input is read
// once and 4 bytes (a label) or K words are written a row, while the LUT is
// small and read from shared memory.  Design, and why:
// * A thread owns a row, not a (row, k) output: it holds the row's K sums
//   in registers (compiled for KC = 1, 2, 4 or 8 of them; wider K goes in
//   chunks of 8, argmax / argmin carrying a running best, raw and sums
//   storing each chunk, ovo_vote recounting each class's pairs), makes the
//   decision there and writes one label.  No division, no re-read of the
//   codes by K threads; consecutive threads store consecutive rows.
// * Each block takes a contiguous run of rows, in tiles of one row a
//   thread.  A tile's codes ([R, F] int32, 20 bytes a row at F = 5, which
//   per-thread loads would not coalesce) are copied to shared memory with
//   16-byte cp.async, in a ring of kLbStages tiles: while one tile is
//   gathered the next two are in flight, and one barrier a tile both
//   publishes the landed tile and frees the spent one.
// * The LUT is staged once per block in shared memory, opted in up to the
//   card's 227 KB, each (f, code) row padded to KS = 1, 2 or a multiple of 4
//   words so that its K entries are one 4-, 8- or 16-byte load; its copy
//   rides in the ring's first cp.async group.  Past that it is read through
//   the cache with __ldg.
// * The grid is the occupancy calculator's (at most kLbMaxBlocksPerSm
//   blocks an SM, since each stages the LUT), each block given an equal
//   number of tiles.  __launch_bounds__(kThreads, 2) keeps at least two
//   blocks an SM from registers.
// * The bias and the ovo pairs (a_m, c_m) are loaded once per thread into
//   registers (one broadcast load each) when K fits the register chunk;
//   wider K reads them through the cache.
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

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory kept at or under the 48 KB that needs no opt-in.
constexpr int kSmemBytes = 48 * 1024;
// lb_lookup: what one launch writes (the Python wrapper's epilogue index).
constexpr int kSums = 0, kArgmax = 1, kArgmin = 2, kOvo = 3, kRaw = 4;
// lb_lookup: sums a thread holds in registers at once (the widest KC).
constexpr int kLbChunk = 8;
// lb_lookup: tiles in the codes ring (one gathered, the rest in flight).
constexpr int kLbStages = 3;
// lb_lookup: shared memory the codes ring may take.
constexpr int kLbRingBytes = 64 * 1024;
// lb_lookup: resident blocks an SM at most (each stages the whole LUT).
constexpr int kLbMaxBlocksPerSm = 4;
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
// on every SM at once (persistent blocks; the kernel grid-strides), and at
// ``max_per_sm`` blocks an SM when that is given.  The cap is asked of the
// occupancy calculator once per kernel, device and shared-memory size, not
// at every launch.
template <auto Kernel>
int persistent_grid(long long items, size_t smem, int max_per_sm = 0) {
  static int cached_dev = -1, per_sm = 0, sms = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || smem != cached_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kThreads, smem) !=
            cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    sms = sm_count();
    cached_dev = dev;
    cached_smem = smem;
  }
  const int blocks = max_per_sm > 0 && per_sm > max_per_sm ? max_per_sm
                                                           : per_sm;
  const long long cap = (long long)sms * blocks;
  const long long need = (items + kThreads - 1) / kThreads;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// Blocks of ``Kernel`` resident on an SM at ``smem`` bytes (the occupancy
// calculator), 0 when it cannot say.
template <auto Kernel>
int blocks_per_sm(size_t smem) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kThreads,
                                                       smem) == cudaSuccess
             ? n
             : 0;
}

// Let ``Kernel`` take ``smem`` bytes of dynamic shared memory: the opt-in
// past 48 KB, asked once per kernel for the largest size seen so far.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = kSmemBytes;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so later launches do not report it
    return err;
  }
  allowed = smem;
  return cudaSuccess;
}

int smem_optin() {
  static int dev_seen = -1, optin = kSmemBytes;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != dev_seen) {
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      optin = kSmemBytes;
    dev_seen = dev;
  }
  return optin;
}

// ------------------------------------------------------------- lb_lookup
struct LbArgs {
  const int32_t* x;      // codes (sums) or raw features (predict modes) [B, F]
  const int32_t* luts;   // [F, V, K]
  const int32_t* bias;   // [K], or null for zeros
  const int32_t* pairs;  // ovo_vote: [K, 2] (a_m, c_m)
  void* out;             // sums [B, K] int32, label [B] int32, raw [B, K] f32
  int B, F, V, K, n_classes;
  float scale;           // raw: the divisor
  int R;                 // rows of a tile (one a thread)
  int tile_words;        // a tile's ring slot, R * F rounded up to 4 words
  int tiles_per_block;   // consecutive tiles of one block
  int KS;                // shared-memory LUT words per (f, code) row
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ``n`` words from ``src`` to the 16-byte aligned ``dst``, by the whole
// block: 16-byte copies while ``src`` is 16-byte aligned, 4-byte ones for
// the tail (and for a source that is not).
__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src,
                                           int n) {
  int done = 0;
  if (((uintptr_t)src & 15) == 0) {
    const int n16 = n >> 2;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = n16 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// Add entries [c0, c0 + KC) of LUT row ``e`` = f * V + code to ``acc``:
// from shared memory one 4/8/16-byte load per 1/2/4 entries (rows padded
// to KS words), from the global LUT one cached load per entry below K.
template <int KC, bool SMEM_LUT>
__device__ __forceinline__ void add_lut_row(uint32_t (&acc)[KC],
                                            const int32_t* lut,
                                            const LbArgs& a, int e, int c0) {
  if constexpr (SMEM_LUT) {
    const int32_t* p = lut + e * a.KS + c0;
    if constexpr (KC == 1) {
      acc[0] += (uint32_t)p[0];
    } else if constexpr (KC == 2) {
      const int2 v = *reinterpret_cast<const int2*>(p);
      acc[0] += (uint32_t)v.x, acc[1] += (uint32_t)v.y;
    } else {
#pragma unroll
      for (int j = 0; j < KC; j += 4) {
        if (j == 0 || c0 + j < a.KS) {
          const int4 v = *reinterpret_cast<const int4*>(p + j);
          acc[j] += (uint32_t)v.x, acc[j + 1] += (uint32_t)v.y;
          acc[j + 2] += (uint32_t)v.z, acc[j + 3] += (uint32_t)v.w;
        }
      }
    }
  } else {
    const int32_t* p = lut + (long long)e * a.K + c0;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (c0 + k < a.K) acc[k] += (uint32_t)__ldg(p + k);
  }
}

// ``acc`` = the row's bias (``b0``: chunk 0, held in registers) plus its
// entries [c0, c0 + KC) over every feature.  Predict modes clamp a code to
// [0, V-1]; sums mode skips one outside [0, V).
template <int MODE, int KC, bool SMEM_LUT>
__device__ __forceinline__ void row_sums(uint32_t (&acc)[KC],
                                         const uint32_t (&b0)[KC],
                                         const int32_t* lut, const LbArgs& a,
                                         const int32_t* codes, int c0) {
#pragma unroll
  for (int k = 0; k < KC; ++k)
    acc[k] = c0 == 0 ? b0[k]
             : a.bias != nullptr && c0 + k < a.K
                 ? (uint32_t)__ldg(a.bias + c0 + k)
                 : 0u;
  for (int f = 0; f < a.F; ++f) {
    int code = codes[f];
    if constexpr (MODE == kSums) {
      if ((unsigned)code >= (unsigned)a.V) continue;  // adds 0
    } else {
      code = min(max(code, 0), a.V - 1);
    }
    add_lut_row<KC, SMEM_LUT>(acc, lut, a, f * a.V + code, c0);
  }
}

// Entries [c0, c0 + KC) of row r's output, below K: one 4/8/16-byte store
// (two for KC = 8) when the row is exactly KC wide, else one a word.
template <int KC, typename T>
__device__ __forceinline__ void store_row(T* out, long long r, int K, int c0,
                                          const T (&v)[KC]) {
  T* o = out + r * K + c0;
  if (K == KC) {
    if constexpr (KC == 1) {
      o[0] = v[0];
    } else if constexpr (KC == 2) {
      using V2 = std::conditional_t<std::is_same_v<T, float>, float2, int2>;
      *reinterpret_cast<V2*>(o) = V2{v[0], v[1]};
    } else {
      using V4 = std::conditional_t<std::is_same_v<T, float>, float4, int4>;
#pragma unroll
      for (int j = 0; j < KC; j += 4)
        *reinterpret_cast<V4*>(o + j) = V4{v[j], v[j + 1], v[j + 2], v[j + 3]};
    }
  } else {
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (c0 + k < K) o[k] = v[k];
  }
}

// ovo_vote past the register chunk (K > KC): each class's votes counted
// over the pairs that name it, each such pair's sum recomputed from the
// row's codes (every pair twice in all, a class at a time, no per-class
// array); the first class with the most votes.
template <bool SMEM_LUT>
__device__ __forceinline__ int ovo_wide(const int32_t* lut, const LbArgs& a,
                                        const int32_t* codes) {
  int best = -1, arg = 0;
  for (int j = 0; j < a.n_classes; ++j) {
    int votes = 0;
    for (int m = 0; m < a.K; ++m) {
      const int pa = __ldg(a.pairs + 2 * m), pc = __ldg(a.pairs + 2 * m + 1);
      if (pa != j && pc != j) continue;
      uint32_t s = a.bias != nullptr ? (uint32_t)__ldg(a.bias + m) : 0u;
      for (int f = 0; f < a.F; ++f) {
        const int e = f * a.V + min(max(codes[f], 0), a.V - 1);
        s += SMEM_LUT ? (uint32_t)lut[e * a.KS + m]
                      : (uint32_t)__ldg(lut + (long long)e * a.K + m);
      }
      votes += ((int)s > 0 ? pa : pc) == j;
    }
    if (votes > best) best = votes, arg = j;
  }
  return arg;
}

// One row: its sums, chunk by chunk, and the mode's output.
template <int MODE, int KC, bool SMEM_LUT>
__device__ __forceinline__ void lb_row(const LbArgs& a, const int32_t* lut,
                                       const int32_t* codes, long long r,
                                       const uint32_t (&b0)[KC],
                                       const int (&pa)[KC],
                                       const int (&pc)[KC]) {
  if constexpr (MODE == kOvo) {
    if (KC == kLbChunk && a.K > KC) {
      reinterpret_cast<int32_t*>(a.out)[r] = ovo_wide<SMEM_LUT>(lut, a, codes);
      return;
    }
  }
  int best = MODE == kArgmin ? INT_MAX : INT_MIN, arg = 0;
  for (int c0 = 0; c0 < a.K; c0 += KC) {  // one chunk when K <= KC
    uint32_t acc[KC];
    row_sums<MODE, KC, SMEM_LUT>(acc, b0, lut, a, codes, c0);
    if constexpr (MODE == kSums) {
      int32_t v[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) v[k] = (int32_t)acc[k];
      store_row<KC>(reinterpret_cast<int32_t*>(a.out), r, a.K, c0, v);
    } else if constexpr (MODE == kRaw) {
      float v[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k)
        v[k] = __fdiv_rn(__int2float_rn((int)acc[k]), a.scale);
      store_row<KC>(reinterpret_cast<float*>(a.out), r, a.K, c0, v);
    } else if constexpr (MODE == kArgmax || MODE == kArgmin) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {  // strict: the first index wins ties
        const int v = (int)acc[k];
        if (c0 + k < a.K && (MODE == kArgmax ? v > best : v < best))
          best = v, arg = c0 + k;
      }
    } else {  // kOvo, K <= KC: pair m votes for its winner
      int win[KC];
#pragma unroll
      for (int m = 0; m < KC; ++m) win[m] = (int)acc[m] > 0 ? pa[m] : pc[m];
      // only a winner can hold a vote: count each, keep the first class
      // with the most (class 0 with none when no pair names a class)
      int top = 0;
#pragma unroll
      for (int m = 0; m < KC; ++m) {
        const int j = win[m];
        if (m >= a.K || j < 0 || j >= a.n_classes) continue;
        int votes = 0;
#pragma unroll
        for (int q = 0; q < KC; ++q) votes += q < a.K && win[q] == j;
        if (votes > top || (votes == top && j < arg)) top = votes, arg = j;
      }
    }
    if constexpr (KC < kLbChunk) break;
  }
  if constexpr (MODE != kSums && MODE != kRaw)
    reinterpret_cast<int32_t*>(a.out)[r] = arg;
}

// A block takes tiles_per_block consecutive tiles of R rows, a thread a row.
// Ring: tiles t + 1 and t + 2 are in flight while tile t is gathered; the
// LUT's copy rides in the first group.  One barrier a tile publishes tile t
// to every thread and tells them that tile t - 1's slot, which the copy of
// tile t + 2 then takes, has been read.
template <int MODE, int KC, bool SMEM_LUT>
__global__ void __launch_bounds__(kThreads, 2) lb_lookup_kernel(const LbArgs a) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_lut = smem + kLbStages * a.tile_words;
  const long long row0 = (long long)blockIdx.x * a.tiles_per_block * a.R;
  const long long row_end =
      min((long long)a.B, row0 + (long long)a.tiles_per_block * a.R);
  const int n_tiles = (int)((row_end - row0 + a.R - 1) / a.R);
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const long long r0 = row0 + (long long)t * a.R;
      const int rows = (int)min((long long)a.R, row_end - r0);
      copy_words(smem + (t % kLbStages) * a.tile_words, a.x + r0 * a.F,
                 rows * a.F);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  if constexpr (SMEM_LUT) {
    if (a.KS == a.K) {
      copy_words(s_lut, a.luts, a.F * a.V * a.K);
    } else {  // pad each (f, code) row to KS words
      const int n = a.F * a.V * a.K;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int e = i / a.K;
        cp_async4(s_lut + e * a.KS + (i - e * a.K), a.luts + i);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kLbStages - 1; ++t) load_tile(t);
  const int32_t* lut = SMEM_LUT ? s_lut : a.luts;
  // chunk 0 of the bias, and the ovo pairs, in registers for every row
  uint32_t b0[KC];
  int pa[KC], pc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const bool in = k < a.K;
    b0[k] = a.bias != nullptr && in ? (uint32_t)__ldg(a.bias + k) : 0u;
    pa[k] = MODE == kOvo && in ? __ldg(a.pairs + 2 * k) : -1;
    pc[k] = MODE == kOvo && in ? __ldg(a.pairs + 2 * k + 1) : -1;
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kLbStages - 2>();  // tile t (and the LUT) has landed
    __syncthreads();
    load_tile(t + kLbStages - 1);
    const long long r = row0 + (long long)t * a.R + threadIdx.x;
    if ((int)threadIdx.x < a.R && r < row_end)
      lb_row<MODE, KC, SMEM_LUT>(
          a, lut, smem + (t % kLbStages) * a.tile_words + threadIdx.x * a.F,
          r, b0, pa, pc);
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The launch plan of one lb_lookup call: what the entry point launches and
// what lb_lookup_plan reports.
struct LbPlan {
  LbArgs a;
  int kc, lut_in_smem;
  size_t smem;
};

int plan_lb(LbPlan& p) {
  LbArgs& a = p.a;
  const int optin = smem_optin();
  // rows a tile: one a thread, fewer when the ring would pass its share
  long long R = kLbRingBytes / (4LL * kLbStages * a.F);
  if (R > kThreads) R = kThreads;
  if (R >= 4) R &= ~3LL;  // 16-byte aligned tiles
  if (R < 1) R = 1;
  a.R = (int)R;
  a.tile_words = (int)(((long long)a.R * a.F + 3) & ~3LL);
  const long long ring = 4LL * kLbStages * a.tile_words;
  if (ring > optin) return (int)cudaErrorInvalidValue;  // F past the card
  p.kc = a.K <= 1 ? 1 : a.K == 2 ? 2 : a.K <= 4 ? 4 : kLbChunk;
  a.KS = a.K <= 2 ? a.K : (a.K + 3) & ~3;
  const long long lut_bytes = 4LL * a.F * a.V * a.KS;
  p.lut_in_smem = ring + lut_bytes <= optin ? 1 : 0;
  p.smem = (size_t)(ring + (p.lut_in_smem ? lut_bytes : 0));
  return 0;
}

template <int MODE, int KC, bool SMEM_LUT>
int launch_lb(LbPlan& p, cudaStream_t stream, int* report) {
  constexpr auto kernel = lb_lookup_kernel<MODE, KC, SMEM_LUT>;
  const cudaError_t err = allow_smem<kernel>(p.smem);
  if (err != cudaSuccess) return (int)err;
  LbArgs& a = p.a;
  const long long tiles = ((long long)a.B + a.R - 1) / a.R;
  const int cap =
      persistent_grid<kernel>(tiles * kThreads, p.smem, kLbMaxBlocksPerSm);
  a.tiles_per_block = (int)((tiles + cap - 1) / cap);
  const int grid = (int)((tiles + a.tiles_per_block - 1) / a.tiles_per_block);
  if (report != nullptr) {  // lb_lookup_plan: describe, do not launch
    report[0] = grid;
    report[1] = blocks_per_sm<kernel>(p.smem);
    report[2] = (int)p.smem;
    report[3] = p.lut_in_smem;
    report[4] = a.R;
    report[5] = a.tiles_per_block;
    report[6] = KC;
    return (int)cudaGetLastError();
  }
  kernel<<<grid, kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, int KC>
int launch_lb_lut(LbPlan& p, cudaStream_t s, int* report) {
  return p.lut_in_smem ? launch_lb<MODE, KC, true>(p, s, report)
                       : launch_lb<MODE, KC, false>(p, s, report);
}

template <int MODE>
int launch_lb_kc(LbPlan& p, cudaStream_t s, int* report) {
  switch (p.kc) {
    case 1: return launch_lb_lut<MODE, 1>(p, s, report);
    case 2: return launch_lb_lut<MODE, 2>(p, s, report);
    case 4: return launch_lb_lut<MODE, 4>(p, s, report);
    default: return launch_lb_lut<MODE, kLbChunk>(p, s, report);
  }
}

int lb_dispatch(const int32_t* x, const int32_t* luts, const int32_t* bias,
                const int32_t* pairs, void* out, int B, int F, int V, int K,
                int n_classes, int mode, float scale, void* stream,
                int* report) {
  if (F < 1 || V < 1 || K < 0 || mode < kSums || mode > kRaw ||
      (mode == kOvo && (pairs == nullptr || n_classes < 1)) ||
      ((mode == kArgmax || mode == kArgmin) && K < 1))
    return (int)cudaErrorInvalidValue;
  if (report != nullptr && B < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || (K == 0 && (mode == kSums || mode == kRaw)))
    return (int)cudaGetLastError();  // nothing to write
  LbPlan p{};
  p.a = LbArgs{x, luts, bias, pairs, out, B, F, V, K, n_classes, scale};
  if (const int err = plan_lb(p)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kSums: return launch_lb_kc<kSums>(p, s, report);
    case kArgmax: return launch_lb_kc<kArgmax>(p, s, report);
    case kArgmin: return launch_lb_kc<kArgmin>(p, s, report);
    case kOvo: return launch_lb_kc<kOvo>(p, s, report);
    default: return launch_lb_kc<kRaw>(p, s, report);
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

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: codes (mode 0, sums [B, K] int32) or raw features (1 argmax, 2 argmin,
// 3 ovo_vote: label [B] int32; 4 raw: [B, K] float32) [B, F]; luts
// [F, V, K]; bias [K] or null; pairs [K, 2] for ovo_vote.
int lb_lookup(const int32_t* x, const int32_t* luts, const int32_t* bias,
              const int32_t* pairs, void* out, int B, int F, int V, int K,
              int n_classes, int mode, float scale, void* stream) {
  return lb_dispatch(x, luts, bias, pairs, out, B, F, V, K, n_classes, mode,
                     scale, stream, nullptr);
}

// The launch lb_lookup would make for these sizes, without launching:
// report[0..6] = grid, resident blocks an SM (occupancy calculator),
// dynamic shared memory bytes, LUT in shared memory (1/0), rows a tile,
// tiles a block, sums held in registers (KC).
int lb_lookup_plan(int B, int F, int V, int K, int mode, int* report) {
  static const int32_t dummy[2] = {0, 0};
  return lb_dispatch(dummy, dummy, nullptr, dummy, nullptr, B, F, V, K, 1,
                     mode, 1.0f, nullptr, report);
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
