// Hand-written Hopper (sm_90a) kernel: paged attention over a block-table
// KV cache, for decode (C = 1) and prefill chunks (C > 1).
//
// Replaces the Pallas kernel `paged_attention`
// (src/repro/kernels/paged_attention.py:107), which walked each slot's block
// table with scalar-prefetched BlockSpec index maps, staged the whole
// batch's logical [B, S, KV, hd] K/V view in VMEM and attended once, at the
// last grid step, with the jnp oracle's own op sequence
// (src/repro/nn/attn_backend.py:232 `_attend_jnp`).  That design does not
// carry over: at the serve shape (B = 16, S = 1024, KV = 2, hd = 128, bf16)
// the staged view is 8 MB, far past a block's shared memory, and Hopper's
// blocks run in no order, so there is no "last grid step".
//
// What bounds it on the H100: bytes.  A decode launch reads each K and V
// row a query can see once and does about 4 flops a byte, far below the
// card's ~295 flop/byte ridge; at the serve shape with every position
// visible that is 16.8 MB, about 5 us at the 3.35 TB/s of the data sheet
// (NVIDIA H100 80GB HBM3, 700.00 W).  What the design does about it:
//   * enough blocks to keep the loads in flight: a thread-block cluster of
//     R = 8 blocks per (b, kv_head), 256 blocks at the serve shape, three
//     resident on an SM (at most 80 registers a thread); rank r owns the
//     logical positions [r*S/R, (r+1)*S/R), a cut fixed by S;
//   * only what some row can see: a block loads the positions in
//     [min over its rows of max(0, pos - window + 1), max over its rows of
//     pos], so a rank past every row's position loads nothing (a row that
//     sees no position, pos < 0, walks the whole axis, as the oracle's
//     full-axis softmax does);
//   * every K/V byte once: a block takes all C query rows and all G query
//     heads of its slot, so one load serves C*G rows, each element
//     converted once for every four of them; K and V rows are copied with
//     16-byte cp.async, a warp a row, K first and then V, which loads while
//     the scores are taken;
//   * shared memory without conflicts: tile rows are padded by 16 bytes;
//     for the scores each lane takes one position and reads its own K row
//     16 bytes at a time (8 neighbouring rows fall in distinct banks) and
//     the q rows as broadcasts, summing over d in order, four rows at a
//     time with no branch between them; for P.V a warp takes every 8th
//     position and its lanes 4 consecutive d each.
//
// The roundings are the oracle's: q.k accumulated in float32 and rounded to
// q's type, divided by sqrt(hd) in float32, the additive mask (0 or -2^30,
// causal + window on absolute positions) added; a full-axis softmax in
// float32 (no online rescaling, which would drop the next rounding); the
// probabilities rounded to q's type; P.V accumulated in float32 and rounded
// to q's type.  The softmax crosses the ranks through distributed shared
// memory, each cross-rank sum read in rank order:
//   1. each rank publishes its row maxima, every rank takes the max M;
//   2. each rank sums exp(s - M) over its positions (lane l takes the
//      positions j = l mod 32 of the rank, then an xor tree); every rank
//      adds the R partial sums in rank order;
//   3. each rank writes round(e / L) and its P.V partial [C*G, hd] (warp w
//      sums the positions j = w mod 8 in order, then the 8 warps' sums are
//      added in warp order);
//   4. rank r adds the R partials of its slice of hd in rank order, rounds
//      once and writes.
// Every sum's order depends only on S, R and hd, so a row's result is
// bitwise the same whatever B, C or the physical page order.  Skipping is
// exact too: where a row can see a position, a masked one contributes
// exp(-2^30 + x - M) = +0.0, and adding +0.0 changes no sum.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRanks = 8;  // blocks in a cluster (the portable maximum)
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr int kRowsS = 8;  // query rows a lane scores in one pass
constexpr int kRowsPV = 6;  // query rows a warp takes P.V of in one pass
constexpr int kTileBytes = 32 * 1024;  // K (and V) bytes a block stages
constexpr float kNegInf = -1073741824.0f;  // -2^30, attn_backend.NEG_INF

// A value of the pool's type, in q's type, as a float: the oracle's
// `astype(q.dtype)` of the gathered pool, and for int8 pools its
// `k.astype(dt) * scale.astype(dt)` product rounded to q's type.
template <typename QT>
__device__ __forceinline__ float to_q(float x);
template <>
__device__ __forceinline__ float to_q<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_q<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A pool value (as a float) in q's type: int8 pools are quantized, the
// product with the scale rounded; a bf16 value is exact in either type.
template <typename QT, typename PT>
__device__ __forceinline__ float dequant(float x, float scale_q) {
  if constexpr (std::is_same<PT, int8_t>::value)
    return to_q<QT>(x * scale_q);
  else if constexpr (std::is_same<PT, __nv_bfloat16>::value)
    return x;
  else
    return to_q<QT>(x);
}

// N = 4 or 8 consecutive elements from `p` as floats, with vector loads
// (p aligned to N elements: rows start on 16 bytes and hd % 8 == 0).
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + e);
    x[e] = u.x, x[e + 1] = u.y, x[e + 2] = u.z, x[e + 3] = u.w;
  }
}
// bf16 is the top half of a float; int8 is sign-extended from its byte.
// Values are taken from the loaded words by shifts, never through a local
// array (which would live in local memory).
__device__ __forceinline__ void bf16x2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float int8_at(uint32_t w, int byte) {
  return (float)((int32_t)(w << (24 - 8 * byte)) >> 24);
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bf16x2(u.x, x[0], x[1]), bf16x2(u.y, x[2], x[3]);
    bf16x2(u.z, x[4], x[5]), bf16x2(u.w, x[6], x[7]);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2(u.x, x[0], x[1]), bf16x2(u.y, x[2], x[3]);
  }
}
template <int N>
__device__ __forceinline__ void load_n(const int8_t* p, float (&x)[N]) {
  if constexpr (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = int8_at(u.x, e), x[4 + e] = int8_at(u.y, e);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = int8_at(u, e);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// xor butterfly: every lane ends with the same bits (addition commutes)
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

// One launch's arguments and the byte offsets of its shared-memory parts
// (computed on the host, every part 16-byte aligned).
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;  // null for float pools
  const float* vs;
  const int32_t* tbl;
  const int32_t* pos;
  void* out;
  int C, H, KV, hd, N, page, n_ps, window;
  float sqrt_hd;
  int S, RS, TP, KST;  // score row stride; positions a tile; tile row stride
  int vec;  // rows copied 16 bytes a thread
  int o_kbuf, o_vbuf, o_sc, o_q, o_ks, o_vs, o_pos, o_rmax, o_lsum,
      o_range, o_prow;
};

// Rank-local positions [j0, j0 + n) of `pool` (pool rows `prow[j]`) into
// `buf`, rows KST elements apart (16 bytes past the row, so that lanes
// reading 16 bytes of eight neighbouring rows hit distinct banks), with
// cp.async, 16 bytes a lane when rows allow it, a warp a row; their
// scales, in q's type, into `sbuf`; commits one cp.async group.
template <typename QT, typename PT>
__device__ __forceinline__ void stage(const Args& a, const uint32_t* prow,
                                      const PT* __restrict__ pool,
                                      const float* __restrict__ scale,
                                      PT* buf, float* sbuf, int j0, int n) {
  const int hd = a.hd, t = threadIdx.x, warp = t / 32, lane = t % 32;
  if (a.vec) {
    const int cpr = hd * (int)sizeof(PT) / 16;  // 16-byte chunks a row
    for (int j = warp; j < n; j += kWarps) {
      const char* src = reinterpret_cast<const char*>(
          pool + (size_t)prow[j0 + j] * hd);
      char* dst = reinterpret_cast<char*>(buf + (size_t)j * a.KST);
      for (int ch = lane; ch < cpr; ch += 32)
        cp_async16(dst + ch * 16, src + ch * 16);
    }
  } else {
    for (int j = warp; j < n; j += kWarps)
      for (int d = lane; d < hd; d += 32)
        buf[(size_t)j * a.KST + d] = pool[(size_t)prow[j0 + j] * hd + d];
  }
  if (scale != nullptr)
    for (int j = t; j < n; j += kThreads) sbuf[j] = to_q<QT>(scale[prow[j0 + j]]);
  cp_async_commit();
}

template <typename QT, typename PT>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 3)
    paged_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  PT* kbuf = reinterpret_cast<PT*>(smem + a.o_kbuf);    // [TP, KST]
  PT* vbuf = reinterpret_cast<PT*>(smem + a.o_vbuf);    // [TP, KST]
  // [8 warps, kRowsPV, 128]: P.V partials, over the K tile (free by then)
  float* red = reinterpret_cast<float*>(smem + a.o_kbuf);
  float* sc = reinterpret_cast<float*>(smem + a.o_sc);  // [C*G, RS]
  QT* q_s = reinterpret_cast<QT*>(smem + a.o_q);        // [C*G, hd]
  float* ks_s = reinterpret_cast<float*>(smem + a.o_ks);  // [TP]
  float* vs_s = reinterpret_cast<float*>(smem + a.o_vs);  // [TP]
  int* qpos_s = reinterpret_cast<int*>(smem + a.o_pos);     // [C*G]
  uint32_t* prow_s = reinterpret_cast<uint32_t*>(smem + a.o_prow);  // [SR]
  float* rmax = reinterpret_cast<float*>(smem + a.o_rmax);  // [C*G]
  float* lsum = reinterpret_cast<float*>(smem + a.o_lsum);  // [C*G]
  int* range_s = reinterpret_cast<int*>(smem + a.o_range);  // [2]

  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int slot = blockIdx.x / kRanks;  // b * KV + kv_head
  const int b = slot / a.KV, kvh = slot % a.KV;
  const int G = a.H / a.KV, CG = a.C * G, hd = a.hd, S = a.S, RS = a.RS;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const bool quantized = a.ks != nullptr;
  const int p0 = (int)((long long)r * S / kRanks);
  const int p1 = (int)((long long)(r + 1) * S / kRanks);

  // 1. the slot's query rows, its positions and the pool row of each of
  //    the rank's positions (its table entry clipped to [0, N-1], as the
  //    oracle's gather clips); warp 0 finds the positions some row can see
  const QT* qg = static_cast<const QT*>(a.q);
  for (int i = t; i < CG * hd; i += kThreads) {
    const int row = i / hd, d = i - row * hd;
    const int c = row / G, g = row - c * G;
    q_s[i] = qg[(((size_t)b * a.C + c) * a.H + (size_t)kvh * G + g) * hd + d];
  }
  for (int row = t; row < CG; row += kThreads)
    qpos_s[row] = a.pos[(size_t)b * a.C + row / G];
  for (int j = t; j < p1 - p0; j += kThreads) {  // each position's pool row
    const int s = p0 + j;
    int p = a.tbl[(size_t)b * a.n_ps + s / a.page];
    p = p < 0 ? 0 : (p > a.N - 1 ? a.N - 1 : p);
    prow_s[j] = ((uint32_t)p * a.page + s % a.page) * a.KV + kvh;
  }
  if (warp == 0) {
    int lo = S, hi = -1;
    for (int c = lane; c < a.C; c += 32) {
      const long long p = a.pos[(size_t)b * a.C + c];
      long long vlo = a.window > 0 ? p - a.window + 1 : 0;
      if (vlo < 0) vlo = 0;
      long long vhi = p < S - 1 ? p : S - 1;
      if (vlo > vhi) vlo = 0, vhi = S - 1;  // sees nothing: the full axis
      lo = min(lo, (int)vlo);
      hi = max(hi, (int)vhi);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) range_s[0] = lo, range_s[1] = hi;
  }
  __syncthreads();
  const int ja = max(range_s[0], p0) - p0;  // rank-local [ja, jb)
  const int jb = min(range_s[1] + 1, p1) - p0;
  const bool busy = ja < jb;  // uniform over the block
  const int TP = a.TP;
  const PT* kp = static_cast<const PT*>(a.kp);
  const PT* vp = static_cast<const PT*>(a.vp);

  // 2. scores of the visible positions, tile by tile (K first, so that it
  //    has the bandwidth to itself; the first V tile follows it)
  if (busy) {
    stage<QT, PT>(a, prow_s, kp, a.ks, kbuf, ks_s, ja, min(TP, jb - ja));
    for (int jt = ja; jt < jb; jt += TP) {
      const int n = min(TP, jb - jt);
      cp_async_wait<0>();
      __syncthreads();
      if (jt == ja)  // the first V tile loads while the scores are taken
        stage<QT, PT>(a, prow_s, vp, a.vs, vbuf, vs_s, ja, min(TP, jb - ja));
      // lane = position: a warp takes 32 positions of the tile and the row
      // set {rh, rh + RH, ...} (RH sets, so that the 8 warps have work);
      // each lane sums its q.k over d in order, reading its K row 16 bytes
      // at a time and the q rows as broadcasts
      const int ng = (n + 31) / 32;
      const int RH = max((CG + kRowsS - 1) / kRowsS,
                         min(CG, (kWarps + ng - 1) / ng));
      for (int item = warp; item < ng * RH; item += kWarps) {
        const int g = item / RH, rh = item - g * RH;
        const int j = g * 32 + lane;  // tile-local
        const bool on = j < n;
        const PT* krow = kbuf + (size_t)(on ? j : 0) * a.KST;
        const float sq = quantized ? ks_s[on ? j : 0] : 1.0f;
        const int n_rows = (CG - rh + RH - 1) / RH;  // rows rh + RH * i
        // four rows at a time, with no branch between them, so that their
        // loads and sums interleave
        for (int i0 = 0; i0 < n_rows; i0 += 4) {
          int row[4];
          float acc[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            row[k] = rh + RH * min(i0 + k, n_rows - 1);
            acc[k] = 0.0f;
          }
#pragma unroll 4
          for (int d0 = 0; d0 < hd; d0 += 8) {
            float kv[8];
            load_n<8>(krow + d0, kv);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              kv[e] = dequant<QT, PT>(kv[e], sq);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float qv[8];
              load_n<8>(q_s + (size_t)row[k] * hd + d0, qv);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[k] += qv[e] * kv[e];
            }
          }
          if (on) {
            const int jr = jt + j;  // rank-local
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (i0 + k < n_rows) {
                const long long diff =
                    (long long)qpos_s[row[k]] - (p0 + jr);
                const bool ok =
                    diff >= 0 && (a.window <= 0 || diff < a.window);
                sc[(size_t)row[k] * RS + jr] =
                    to_q<QT>(acc[k]) / a.sqrt_hd + (ok ? 0.0f : kNegInf);
              }
            }
          }
        }
      }
      if (jt + TP < jb) {
        __syncthreads();  // every reader of this K tile is done
        stage<QT, PT>(a, prow_s, kp, a.ks, kbuf, ks_s, jt + TP,
                      min(TP, jb - jt - TP));
      }
    }
  }
  __syncthreads();

  // 3. softmax across the cluster, one warp a row
  for (int row = warp; row < CG; row += kWarps) {
    float m = -INFINITY;
    if (busy)
      for (int j = ja + lane; j < jb; j += 32) m = fmaxf(m, sc[(size_t)row * RS + j]);
    m = warp_max(m);
    if (lane == 0) rmax[row] = m;
  }
  cluster.sync();
  for (int row = warp; row < CG; row += kWarps) {
    float m = lane < kRanks ? cluster.map_shared_rank(rmax, lane)[row]
                            : -INFINITY;
    m = warp_max(m);
    float sum = 0.0f;
    if (busy)  // lane l: the rank's positions j = l mod 32, in order
      for (int j = ja + ((lane - ja) & 31); j < jb; j += 32) {
        float* x = sc + (size_t)row * RS + j;
        const float e = expf(*x - m);
        *x = e;
        sum += e;
      }
    sum = warp_sum(sum);
    if (lane == 0) lsum[row] = sum;
  }
  cluster.sync();
  for (int row = warp; row < CG; row += kWarps) {
    const float part = lane < kRanks
                           ? cluster.map_shared_rank(lsum, lane)[row]
                           : 0.0f;
    float l = 0.0f;
    for (int q = 0; q < kRanks; ++q)  // in rank order
      l += __shfl_sync(0xffffffffu, part, q);
    if (busy)
      for (int j = ja + lane; j < jb; j += 32) {
        float* x = sc + (size_t)row * RS + j;
        *x = to_q<QT>(*x / l);
      }
  }
  cp_async_wait<0>();  // the first V tile
  __syncthreads();

  // 4. P.V over the rank's positions: warp w takes the rank-local
  //    positions j = w mod 8 in order, each lane 4 consecutive d of a
  //    128-wide slice of hd, for a pass of kRowsPV rows; the warps' partials
  //    are then added in warp order, and each pass's sums replace its
  //    rows' probabilities in sc (RS >= hd)
  int v_tile = 0;  // the tile vbuf holds
  constexpr int kSums = kRowsPV * 128 / kThreads;  // a thread's, a slice
  static_assert(kSums * kThreads == kRowsPV * 128, "whole sums a thread");
  for (int r0 = 0; r0 < CG; r0 += kRowsPV) {
    float o_lo[kSums], o_hi[kSums];  // this thread's, slices 0 and 1
    for (int h = 0; h < hd; h += 128) {
      const int d = h + 4 * lane;
      const bool lane_on = d < hd;
      float acc[kRowsPV][4];
#pragma unroll
      for (int i = 0; i < kRowsPV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      if (busy) {
        for (int jt = ja; jt < jb; jt += TP) {
          const int n = min(TP, jb - jt), tile = (jt - ja) / TP;
          if (tile != v_tile) {
            __syncthreads();  // every reader of the last tile is done
            stage<QT, PT>(a, prow_s, vp, a.vs, vbuf, vs_s, jt, n);
            cp_async_wait<0>();
            __syncthreads();
            v_tile = tile;
          }
#pragma unroll 1
          for (int jr = jt + ((warp - jt) & (kWarps - 1)); jr < jt + n;
               jr += kWarps) {
            const int j = jr - jt;
            const float sv = quantized ? vs_s[j] : 1.0f;
            float vv[4];
            load_n<4>(vbuf + (size_t)j * a.KST + (lane_on ? d : 0), vv);
#pragma unroll
            for (int e = 0; e < 4; ++e) vv[e] = dequant<QT, PT>(vv[e], sv);
#pragma unroll
            for (int i = 0; i < kRowsPV; ++i) {
              const float pr =
                  r0 + i < CG ? sc[(size_t)(r0 + i) * RS + jr] : 0.0f;
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][e] += pr * vv[e];
            }
          }
        }
      }
      if (h > 0) __syncthreads();  // the last slice's partials are read
      if (lane_on)
#pragma unroll
        for (int i = 0; i < kRowsPV; ++i)
          *reinterpret_cast<float4*>(
              red + ((size_t)warp * kRowsPV + i) * 128 + 4 * lane) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();  // the partials are in
#pragma unroll
      for (int k = 0; k < kSums; ++k) {  // (row i, column dd) = t + 256 k
        const int i = (t >> 7) + 2 * k, dd = t & 127;
        float o = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          o += red[((size_t)w * kRowsPV + i) * 128 + dd];
        if (h == 0)
          o_lo[k] = o;
        else
          o_hi[k] = o;
      }
    }
    __syncthreads();  // every reader of red and of these rows' sc is done
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const int i = (t >> 7) + 2 * k, dd = t & 127;
      if (r0 + i < CG) {
        float* orow = sc + (size_t)(r0 + i) * RS;
        if (dd < hd) orow[dd] = o_lo[k];
        if (128 + dd < hd) orow[128 + dd] = o_hi[k];
      }
    }
  }
  cluster.sync();

  // 5. rank r adds the R partials of its slice of hd in rank order
  const int d0 = r * hd / kRanks, w = (r + 1) * hd / kRanks - d0;
  QT* out = static_cast<QT*>(a.out);
  for (int i = t; i < CG * w; i += kThreads) {
    const int row = i / w, dd = d0 + (i - row * w);
    float o = 0.0f;
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      o += cluster.map_shared_rank(sc, q)[(size_t)row * RS + dd];
    const int c = row / G, g = row - c * G;
    store(out + (((size_t)b * a.C + c) * a.H + (size_t)kvh * G + g) * hd + dd,
          o);
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Lay out a block's shared memory for positions tiles of at most
// kTileBytes, fewer where the fixed parts leave less of `optin`; 0 when
// not even one position fits.
template <typename QT, typename PT>
size_t plan(Args& a, int optin) {
  const int G = a.H / a.KV, CG = a.C * G;
  const int SR = (a.S + kRanks - 1) / kRanks;  // most positions a rank owns
  a.RS = SR > a.hd ? SR : a.hd;
  const size_t row_bytes = (size_t)a.hd * sizeof(PT);
  const size_t kst_bytes = align16(row_bytes) + 16;  // a tile row, padded
  a.KST = (int)(kst_bytes / sizeof(PT));
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += align16(bytes);
    return (int)at;
  };
  a.o_sc = take((size_t)CG * a.RS * 4);
  a.o_q = take((size_t)CG * a.hd * sizeof(QT));
  a.o_pos = take((size_t)CG * 4);
  a.o_prow = take((size_t)SR * 4);
  a.o_rmax = take((size_t)CG * 4);
  a.o_lsum = take((size_t)CG * 4);
  a.o_range = take(8);
  // per position of a tile: a K and a V row, a K and a V scale
  const size_t per_pos = 2 * (kst_bytes + 4);
  if (off + 64 + per_pos > (size_t)optin) return 0;
  size_t tp = ((size_t)optin - off - 64) / per_pos;
  if (tp > kTileBytes / row_bytes) tp = kTileBytes / row_bytes;
  if (tp > (size_t)SR) tp = SR;
  if (tp < 1) return 0;
  a.TP = (int)tp;
  // the K tile, which the P.V partials [8 warps, kRowsPV rows, 128] reuse
  const size_t red_bytes = (size_t)kWarps * kRowsPV * 128 * 4;
  a.o_kbuf = take(tp * kst_bytes > red_bytes ? tp * kst_bytes : red_bytes);
  a.o_vbuf = take(tp * kst_bytes);
  a.o_ks = take(tp * 4);
  a.o_vs = take(tp * 4);
  return off;
}

template <typename QT, typename PT>
int launch(Args a, int B, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, PT>;
  int dev = 0, optin = 48 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = plan<QT, PT>(a, optin);
  if (smem == 0) return (int)cudaErrorInvalidValue;  // past shared memory
  a.vec = (a.hd * sizeof(PT)) % 16 == 0 && (uintptr_t)a.kp % 16 == 0 &&
          (uintptr_t)a.vp % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so later launches do not report it
      return (int)err;
    }
  }
  const long long blocks = (long long)B * a.KV * kRanks;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q_dtype: 0 float32, 1 bfloat16.  pool_dtype: 0 float32, 1 bfloat16,
// 2 int8 (then k_scale / v_scale are the [N, page, KV, 1] float32 planes;
// otherwise they are null).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const float* k_scale, const float* v_scale,
                    const int32_t* block_tbl, const int32_t* positions,
                    void* out, int B, int C, int H, int KV, int hd, int N,
                    int page, int n_ps, int window, float sqrt_hd,
                    int q_dtype, int pool_dtype, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  if (KV < 1 || H % KV || H / KV > kMaxGroup || hd < 8 || hd % 8 ||
      hd > kThreads ||
      N < 1 || page < 1 || n_ps < 1 || (long long)n_ps * page > INT32_MAX ||
      (long long)N * page * KV > UINT32_MAX ||
      (pool_dtype == 2) != (k_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q, a.kp = k_pages, a.vp = v_pages, a.ks = k_scale, a.vs = v_scale;
  a.tbl = block_tbl, a.pos = positions, a.out = out;
  a.C = C, a.H = H, a.KV = KV, a.hd = hd, a.N = N, a.page = page;
  a.n_ps = n_ps, a.window = window, a.sqrt_hd = sqrt_hd, a.S = n_ps * page;
  cudaStream_t st = (cudaStream_t)stream;
#define PA_LAUNCH(QT, PT) return launch<QT, PT>(a, B, st)
  if (q_dtype == 0) {
    if (pool_dtype == 0) PA_LAUNCH(float, float);
    if (pool_dtype == 1) PA_LAUNCH(float, __nv_bfloat16);
    if (pool_dtype == 2) PA_LAUNCH(float, int8_t);
  } else if (q_dtype == 1) {
    if (pool_dtype == 0) PA_LAUNCH(__nv_bfloat16, float);
    if (pool_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    if (pool_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
