// Hand-written Hopper (sm_90a) kernel: the MoE block's expert down product
// and its combine in one launch,
//
//   out[m, :] = bf16( sum over e, ascending, with c[m, e] != 0, of
//                     bf16( h[m, e, :] @ W_down[e] ) * c[m, e] )
//
// with h [M, E, F], W_down [E, F, D], c [M, E] and out [M, D] bf16, every
// sum in float32 (with out_f32, out is the float32 sum before its rounding:
// a rank's partial over its experts under tensor parallelism).  It is JAX's "bsef,efd->bsed" rounded to bf16 followed by
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
// Each output element's F chain runs in one thread, and its expert chain
// in one thread, so neither order depends on M, on the other rows or on
// the schedule: a row's bits are a function of that row alone (chunked
// prefill stays bitwise token-by-token).  The one difference from the
// plain version: an expert whose c[m, e] is 0 adds nothing here, where the
// plain version adds 0 * y, which is the same bits for every finite y
// (acc + (+-0) == acc, and +0 + -0 == +0) but NaN for y = +-inf or NaN
// (ROADMAP C.10).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA.
// The port needs its own because its invariants need row-invariant
// products, which cuBLAS (bmm / einsum) does not promise.
//
// What bounds it on the H100: bytes.  A qwen2-moe step (M = 128 rows, top-4
// of 60 experts) reads the picked experts' W_down, about 348 MB a layer
// (0.104 ms at 3.35 TB/s); the routed work is M * top_k rows of 2 F D
// flops, 2.95 GFLOP, 0.044 ms on the float32 lanes (128 an SM x 132 SMs x
// 1.98 GHz x 2).  So the CUDA cores can keep up with the bytes at the
// serve path's M <= 256, and they keep the plain version's IEEE chain.  A
// tensor core (wgmma) adds its products in an order of its own, so the
// kernel would be held to a tolerance and not bitwise, and the serve
// path's logits would move, for work that is not the bound here.
//
// The design:
//   * a work item is (expert e, a chunk of up to 128 of the rows that
//     picked e in ascending order, a column tile); the item streams the
//     tile's [F, width] slice of W_down once, so an expert picked by up to
//     128 rows reads its W_down from device memory once.  The tile is 128
//     columns wide for up to 32 rows, 64 up to 64 and 32 up to 128
//     (item_width), so no item holds more than 32 x 128 (row, column)
//     pairs: a heavy expert (the device batcher's padded rows route alike,
//     27-108 rows on one expert a layer) spreads over more blocks;
//   * a persistent grid of 3 blocks an SM; each block pulls items from a
//     counter in device memory.  Every block builds the same list on the
//     card at its start, from c alone: the experts ranked by the cost of
//     their items (item_cost: rows a thread, then width; ties to the lower
//     expert), each expert's chunks, each chunk's tiles.  So the costliest
//     items go first and the tail is made of the cheapest.  After the last
//     item of the down product come the combine items: (column tile of
//     128, 8 rows); each waits until its tile's columns are covered by all
//     down items (a per-tile counter of columns), then adds each element's
//     experts in ascending order, so the combine is spread over the whole
//     card.  A block's items come in increasing order from the counter and
//     every down item comes before every combine item, so a block that
//     waits holds no down item and the wait always ends;
//   * block = 4 consumer warps + 1 producer warp (160 threads).  The
//     producer takes the next item, lists its rows (a ballot over c[:, e])
//     into one of two descriptors in shared memory, and streams W_down
//     with TMA (cp.async.bulk.tensor; W_down viewed as [E * F, D], one
//     CUtensorMap an item width, boxes of 32 F rows x the width) into a
//     ring of 4 stages of up to 8 KB, each stage with a full and an empty
//     mbarrier.  It moves on to the next item's stages while the consumers
//     finish one;
//   * a consumer thread owns 2 columns (one bf16 pair of W a row) and R
//     rows of one of 256 / width row groups, R the least of 1-8, 10, 12,
//     14, 16 that holds the item's rows (one template instance each):
//     every W pair it loads from shared memory feeds 2R fmaf, and the R h
//     values of an F row are broadcast float4 loads (a warp's threads
//     share one or a few row groups).  W is unpacked from bf16 in
//     registers (a shift and a mask); the item's h rows are gathered from
//     device memory one stage ahead into registers and stored to shared
//     memory as float32 ([F row][group][row], double-buffered, one named
//     barrier a stage);
//   * each y is rounded to bf16 and written to the scratch ys[M, E, D]
//     (routed pairs only); the combine reads it from L2 (ld.cg).
// Budget: shared memory a block 32 KB ring + 32 KB h stages + 5 KB lists
// and barriers, three blocks an SM (the kernel asks for the largest
// shared-memory carveout); registers at most 136 a thread for three blocks
// (R = 16 holds 32 accumulators; ptxas's counts are printed by
// chip_smoke.py phase 1).  What holds it back on the H100 (PERF.md, PR 24)
// is the consumer warps' fmaf loop, issue-bound: at qwen2-moe's step the
// routed work runs at about a quarter of the float32 lanes' peak, and the
// W stream seldom keeps a consumer waiting.
//
// Nothing depends on routing on the host: the grid (3 x the SMs), the
// scratch and the launch depend on (M, E, F, D) only, and the counters
// are zeroed by the caller in the same stream, so a CUDA graph replays
// the launch with any routing.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().  The
// tensor maps are encoded with cuTensorMapEncodeTiled, reached through
// the runtime (no link against libcuda), once a W_down by the caller
// (`moe_weight_map`), and passed back on every launch as a kernel
// parameter (__grid_constant__).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 128;  // 4 consumer warps
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBlocksPerSM = 3;
constexpr int kTD = 128;  // columns of a combine tile and the widest item
constexpr int kFC = 32;  // F rows a stage
constexpr int kStages = 4;
constexpr int kStageBytes = kFC * kTD * 2;
constexpr int kMaxRows = 128;  // rows of an item
constexpr int kMaxR = 16;  // rows of an item a consumer thread holds
constexpr int kWidths = 3;  // item widths 128, 64, 32 (one map each)
constexpr int kMaxE = 256;
constexpr int kCombineRows = 8;  // rows of a combine item
constexpr int kMapBytes = 128;  // sizeof(CUtensorMap)
// rows a consumer thread holds (R): an item of n rows in G row groups
// takes the least R >= ceil(n / G)
constexpr int kRBuckets[] = {1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16};
constexpr int kNBuckets = sizeof(kRBuckets) / sizeof(kRBuckets[0]);
static_assert(kRBuckets[kNBuckets - 1] == kMaxR, "the buckets end at kMaxR");

// The width of an item of n rows: 128 columns up to 32 rows, 64 up to 64,
// else 32, so that no item holds more than 32 x 128 (row, column) pairs
// and a heavy expert spreads over more blocks.  Its row groups: 256 / w.
__host__ __device__ constexpr int item_width(int n) {
  return n <= 32 ? 128 : n <= 64 ? 64 : 32;
}

// The rank of an expert of n rows in the list: its first item's rows a
// thread (its fmaf an F row), then its width (its bytes), so that the
// costliest items go first; 0 for an expert no row picked.
__host__ __device__ constexpr int item_cost(int n) {
  return n == 0 ? 0
                : ((n < kMaxRows ? n : kMaxRows) * item_width(n) + 255) /
                          256 * 1024 + item_width(n);
}

enum { kDown = 0, kCombine = 1, kEnd = 2 };

struct Desc {
  int kind, e, n;  // n: the item's rows
  int c0, width;  // a down item's first column and width
  int tile, r0;  // a combine item's column tile (128) and first row
  int rows[kMaxRows];  // a down item's rows, ascending
};

struct Smem {
  unsigned char ring[kStages][kStageBytes];  // first: 1024-byte aligned
  float hbuf[2][kFC * kMaxRows];  // h stages as float32 [f][group][row]
  Desc desc[2];
  int cnt[kMaxE];  // rows that picked each expert
  int cost[kMaxE];  // item_cost of each expert
  int order[kMaxE];  // the experts, costliest items first
  int start[kMaxE + 1];  // the first down item of each rank
  uint64_t full[kStages], empty[kStages], dfull[2], dempty[2];
  int chunks;  // row chunks of all experts: a column's down items
  int n_down, n_items;
};

struct __align__(64) Params {
  CUtensorMap w[kWidths];  // W_down as [E * F, D]: boxes of 32 rows x 128,
                           // 64 and 32 columns
  const __nv_bfloat16* h;  // [M, E, F]
  const __nv_bfloat16* c;  // [M, E]
  __nv_bfloat16* ys;  // [M, E, D] scratch
  void* out;  // [M, D] bf16, or float32 with out_f32
  int* counters;  // [0] the next item; [1 + j] columns of down items done
                  // in column tile j (of 128)
  int M, E, F, D, tiles;  // tiles: column tiles of 128
  int out_f32;
};

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ bool bf_nonzero(uint16_t b) {
  return (b & 0x7fffu) != 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// the map's box at (c0 columns, c1 rows) into shared memory, its bytes
// counted on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the 128 consumer threads only (the producer never waits on it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Every block, at its start: the rows of each expert, the experts ranked
// (costliest items first, item_cost; ties to the lower expert), the first
// down item of each rank.  All blocks read the same c, so all build the
// same list.
__device__ void build_list(const Params& p, Smem& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int E = p.E;
  for (int e = t; e < E; e += kThreads) s.cnt[e] = 0;
  __syncthreads();
  const uint4* c4 = reinterpret_cast<const uint4*>(p.c);
  const int vecs = p.M * E / 8;
#pragma unroll 4
  for (int v = t; v < vecs; v += kThreads) {
    const uint4 q = __ldg(c4 + v);
    const uint16_t* b = reinterpret_cast<const uint16_t*>(&q);
    const int e0 = (v * 8) % E;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (bf_nonzero(b[j])) atomicAdd(&s.cnt[e0 + j], 1);
  }
  __syncthreads();
  for (int e = t; e < E; e += kThreads) s.cost[e] = item_cost(s.cnt[e]);
  __syncthreads();
  for (int e = t; e < E; e += kThreads) {
    const int ce = s.cost[e];
    int r = 0;
#pragma unroll 8
    for (int e2 = 0; e2 < E; ++e2) {
      const int c2 = s.cost[e2];
      r += c2 > ce || (c2 == ce && e2 < e);
    }
    s.order[r] = e;
  }
  __syncthreads();
  if (warp == 0) {
    // an expert's items: its full chunks of 128 rows at width 32, then its
    // last chunk at the width of its rows
    const int D = p.D, wf = item_width(kMaxRows), tilesf = (D + wf - 1) / wf;
    int run = 0, chunks = 0;  // items and chunks of the ranks before
    for (int base = 0; base < E; base += 32) {
      const int r = base + lane;
      const int n = r < E ? s.cnt[s.order[r]] : 0;
      const int full = n / kMaxRows, last = n % kMaxRows;
      const int w = item_width(last);
      const int items = full * tilesf + (last ? (D + w - 1) / w : 0);
      const int ch = full + (last != 0);
      int x = items, y = ch;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int xo = __shfl_up_sync(0xffffffffu, x, o);
        const int yo = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) {
          x += xo;
          y += yo;
        }
      }
      if (r < E) s.start[r] = run + x - items;
      run += __shfl_sync(0xffffffffu, x, 31);
      chunks += __shfl_sync(0xffffffffu, y, 31);
    }
    if (lane == 0) {
      s.start[E] = run;
      s.chunks = chunks;
      s.n_down = run;
      s.n_items = run + p.tiles * ((p.M + kCombineRows - 1) / kCombineRows);
    }
  }
}

// The producer warp: hands out items in the order of the counter, lists a
// down item's rows, streams its W_down slice.
__device__ void producer(const Params& p, Smem& s) {
  const int lane = threadIdx.x & 31;
  const int E = p.E, F = p.F, M = p.M;
  const uint16_t* cb = reinterpret_cast<const uint16_t*>(p.c);
  const int rblocks = (M + kCombineRows - 1) / kCombineRows;
  int stage = 0;  // W stages issued (lane 0)
  for (int seq = 0;; ++seq) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&p.counters[0], 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    const int slot = seq & 1;
    mbar_wait(&s.dempty[slot], ((seq >> 1) & 1) ^ 1);
    Desc& d = s.desc[slot];
    const int kind = item < s.n_down ? kDown
                     : item < s.n_items ? kCombine
                                        : kEnd;
    int e = 0, n = 0, c0 = 0, width = 0, tile = 0, r0 = 0;
    if (kind == kDown) {
      int lo = 0, hi = E - 1;  // the last rank starting at or before item
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s.start[mid] <= item)
          lo = mid;
        else
          hi = mid - 1;
      }
      const int local = item - s.start[lo];
      e = s.order[lo];
      const int full = s.cnt[e] / kMaxRows, wf = item_width(kMaxRows);
      const int tilesf = (p.D + wf - 1) / wf;
      int chunk;
      if (local < full * tilesf) {
        chunk = local / tilesf;
        width = wf;
        c0 = (local % tilesf) * wf;
      } else {
        chunk = full;
        width = item_width(s.cnt[e] % kMaxRows);
        c0 = (local - full * tilesf) * width;
      }
      const int first = chunk * kMaxRows;
      int seen = 0;
      for (int m0 = 0; m0 < M && seen < first + kMaxRows; m0 += 32) {
        const int m = m0 + lane;
        const bool use = m < M && bf_nonzero(cb[(size_t)m * E + e]);
        const unsigned ball = __ballot_sync(0xffffffffu, use);
        const int rank = seen + __popc(ball & ((1u << lane) - 1));
        if (use && rank >= first && rank < first + kMaxRows)
          d.rows[rank - first] = m;
        seen += __popc(ball);
      }
      n = min(seen, first + kMaxRows) - first;
    } else if (kind == kCombine) {
      const int q = item - s.n_down;
      tile = q / rblocks;
      r0 = (q % rblocks) * kCombineRows;
      n = min(kCombineRows, M - r0);
    }
    if (lane == 0) {
      d.kind = kind;
      d.e = e;
      d.n = n;
      d.c0 = c0;
      d.width = width;
      d.tile = tile;
      d.r0 = r0;
    }
    __syncwarp();
    mbar_arrive(&s.dfull[slot]);  // each lane releases its own writes
    if (kind == kEnd) return;
    if (kind == kDown && lane == 0) {
      const CUtensorMap* map = &p.w[__ffs(kTD / width) - 1];
      for (int k = 0; k < F / kFC; ++k, ++stage) {
        const int st = stage % kStages;
        mbar_wait(&s.empty[st], ((stage / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], kFC * width * 2);
        tma_load(s.ring[st], map, &s.full[st], c0, e * F + k * kFC);
      }
    }
    __syncwarp();
  }
}

// One down item on the consumers: y for the item's n rows and `width`
// columns, in G = 256 / width row groups of R rows a thread; a thread owns
// one column pair.  `stage0`: the W stages the block consumed before.
template <int R>
__device__ __forceinline__ void down_item(const Params& p, Smem& s,
                                          const Desc& d, int stage0) {
  constexpr int kRP = (R + 3) & ~3;  // a row group's floats in an h row
  constexpr int kLoads = (R + 3) / 4;  // h vectors a thread a stage: 4GR
  const int t = threadIdx.x, half = d.width / 2, G = kConsumers / half;
  const int g = t / half, cg = t % half, GR = G * R, hrow = G * kRP;
  const int n = d.n, e = d.e, E = p.E, F = p.F, D = p.D;
  const int nst = F / kFC;
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;

  // stage k's h: vector v = t + 128 q is row v % GR, F part v / GR (of 4
  // parts of 8), so a warp's stores to shared memory fall in other banks
  using HRegs = uint4[kLoads];
  HRegs ha;
  auto load_h = [&](HRegs& hv, int k) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int v = t + q * kConsumers, i = v % GR, part = v / GR;
      hv[q] = make_uint4(0, 0, 0, 0);
      if (part < 4 && i < n)
        hv[q] = __ldg(reinterpret_cast<const uint4*>(
            p.h + ((size_t)d.rows[i] * E + e) * F + k * kFC + part * 8));
    }
  };
  auto store_h = [&](const HRegs& hv, float* hb) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int v = t + q * kConsumers, i = v % GR, part = v / GR;
      if (part < 4 && i < n) {
        const int at = (i / R) * kRP + i % R + part * 8 * hrow;
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&hv[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hb[at + (2 * j) * hrow] = bf_lo(u[j]);
          hb[at + (2 * j + 1) * hrow] = bf_hi(u[j]);
        }
      }
    }
  };
  // W stage k on the h in hbuf[k & 1]; the W stage released after
  auto compute = [&](int k) {
    const int use = stage0 + k, st = use % kStages;
    mbar_wait(&s.full[st], (use / kStages) & 1);
    // the stage is [32 F rows][width columns] of bf16
    const uint32_t* wrow =
        reinterpret_cast<const uint32_t*>(s.ring[st]) + cg;
    const float* hb = s.hbuf[k & 1] + g * kRP;
#pragma unroll 8
    for (int f = 0; f < kFC; ++f) {
      const uint32_t wv = wrow[f * half];
      const float w0 = bf_lo(wv), w1 = bf_hi(wv);
      const float* hf = hb + f * hrow;
      auto fma_row = [&](int r, float x) {
        acc[r][0] = fmaf(x, w0, acc[r][0]);
        acc[r][1] = fmaf(x, w1, acc[r][1]);
      };
#pragma unroll
      for (int r = 0; r + 4 <= R; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(hf + r);
        fma_row(r, v.x);
        fma_row(r + 1, v.y);
        fma_row(r + 2, v.z);
        fma_row(r + 3, v.w);
      }
      if constexpr (R % 4 >= 2) {
        const float2 v = *reinterpret_cast<const float2*>(hf + (R & ~3));
        fma_row(R & ~3, v.x);
        fma_row((R & ~3) + 1, v.y);
      }
      if constexpr (R % 2) fma_row(R - 1, hf[R - 1]);
    }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&s.empty[st]);
  };

  load_h(ha, 0);
  store_h(ha, s.hbuf[0]);
  consumer_sync();
  for (int k = 0; k < nst; ++k) {
    if (k + 1 < nst) load_h(ha, k + 1);
    compute(k);
    if (k + 1 < nst) store_h(ha, s.hbuf[(k + 1) & 1]);
    consumer_sync();
  }
  const int col = d.c0 + 2 * cg;
  if (col < D) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g * R + r;
      if (i < n)
        *reinterpret_cast<uint32_t*>(
            p.ys + ((size_t)d.rows[i] * E + e) * D + col) =
            pack_bf16(acc[r][0], acc[r][1]);
    }
  }
}

template <int I>
__device__ __forceinline__ void dispatch(int R, const Params& p, Smem& s,
                                         const Desc& d, int stage0) {
  if constexpr (I < kNBuckets) {
    constexpr int kR = kRBuckets[I];
    if (R <= kR)
      down_item<kR>(p, s, d, stage0);
    else
      dispatch<I + 1>(R, p, s, d, stage0);
  }
}

// One combine item on the consumers: rows r0 .. r0 + n - 1 of a column
// tile, once the tile's down items are all done; a thread a (row, 8
// columns), each element's chain over its row's experts in ascending order.
__device__ void combine_item(const Params& p, Smem& s, const Desc& d) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int E = p.E, D = p.D, n = d.n, r0 = d.r0;
  const int col0 = d.tile * kTD;
  if (t == 0) {  // every chunk's down items have covered the tile
    const int want = s.chunks * min(kTD, D - col0);
    while (ld_acquire(&p.counters[1 + d.tile]) < want) __nanosleep(100);
  }
  // the rows' weights and, a warp a row, the experts they picked in
  // ascending order (the h stages are free: every down item came before)
  uint16_t* cs = reinterpret_cast<uint16_t*>(s.hbuf[0]);
  int* picks = reinterpret_cast<int*>(s.hbuf[1]);
  int* npick = picks + kCombineRows * kMaxE;
  for (int v = t; v < n * E / 8; v += kConsumers)
    reinterpret_cast<uint4*>(cs)[v] =
        __ldg(reinterpret_cast<const uint4*>(p.c + (size_t)r0 * E) + v);
  consumer_sync();
  for (int rr = warp; rr < n; rr += kConsumers / 32) {
    int base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const bool use = e0 + lane < E && bf_nonzero(cs[rr * E + e0 + lane]);
      const unsigned ball = __ballot_sync(0xffffffffu, use);
      if (use) picks[rr * kMaxE + base + __popc(ball & ((1u << lane) - 1))] =
          e0 + lane;
      base += __popc(ball);
    }
    if (lane == 0) npick[rr] = base;
  }
  consumer_sync();
  __threadfence();
  const int rr = t >> 4, col = col0 + (t & 15) * 8;
  if (rr >= n || col >= D) return;
  const int m = r0 + rr, np = npick[rr];
  const __nv_bfloat16* yrow = p.ys + (size_t)m * E * D + col;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < np; k0 += 4) {
    uint4 y[4];
    float cw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the loads of four experts together
      y[q] = make_uint4(0, 0, 0, 0);
      cw[q] = 0.0f;
      if (k0 + q < np) {
        const int e = picks[rr * kMaxE + k0 + q];
        cw[q] = __uint_as_float((uint32_t)cs[rr * E + e] << 16);
        y[q] = __ldcg(reinterpret_cast<const uint4*>(yrow + (size_t)e * D));
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k0 + q >= np) break;
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&y[q]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] = fmaf(bf_lo(u[j]), cw[q], acc[2 * j]);
        acc[2 * j + 1] = fmaf(bf_hi(u[j]), cw[q], acc[2 * j + 1]);
      }
    }
  }
  if (p.out_f32) {
    float4* o = reinterpret_cast<float4*>(static_cast<float*>(p.out) +
                                          (size_t)m * D + col);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    return;
  }
  uint4 o;
  o.x = pack_bf16(acc[0], acc[1]);
  o.y = pack_bf16(acc[2], acc[3]);
  o.z = pack_bf16(acc[4], acc[5]);
  o.w = pack_bf16(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) +
                            (size_t)m * D + col) = o;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    moe_down_combine_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int t = threadIdx.x;
  build_list(p, s);
  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.dfull[i], 32);
      mbar_init(&s.dempty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t >= kConsumers) {
    producer(p, s);
    return;
  }
  int stage = 0;  // W stages consumed
  for (int seq = 0;; ++seq) {
    const int slot = seq & 1;
    mbar_wait(&s.dfull[slot], (seq >> 1) & 1);
    const Desc& d = s.desc[slot];
    const int kind = d.kind;
    if (kind == kEnd) return;
    if (kind == kDown) {
      const int G = 256 / d.width;
      dispatch<0>((d.n + G - 1) / G, p, s, d, stage);
      stage += p.F / kFC;
      __threadfence();  // this item's ys before its count
      consumer_sync();
      if (t == 0)
        atomicAdd(&p.counters[1 + d.c0 / kTD], min(d.width, p.D - d.c0));
    } else {
      combine_item(p, s, d);
      consumer_sync();
    }
    if (t == 0) mbar_arrive(&s.dempty[slot]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // and the alignment
static_assert(sizeof(CUtensorMap) == kMapBytes, "a map is 128 bytes");
static_assert(kBlocksPerSM * (kSmemBytes + 1024) <= 228 * 1024,
              "kBlocksPerSM blocks an SM");

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// the tensor maps of W_down [E, F, D] (bf16, contiguous, 16-byte aligned,
// D % 8 == 0) as [E * F, D] in boxes of 32 rows x 128, 64 and 32 columns
// (zeros past D) into map_out (3 x 128 bytes); the caller keeps them for
// every launch
int moe_weight_map(const void* W, int E, int F, int D, void* map_out) {
  if (E < 1 || F < kFC || F % kFC || D < 8 || D % 8 ||
      reinterpret_cast<uintptr_t>(W) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap m[kWidths];
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)E * F};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t elem[2] = {1, 1};
  for (int i = 0; i < kWidths; ++i) {
    const cuuint32_t box[2] = {(cuuint32_t)(kTD >> i), (cuuint32_t)kFC};
    CUresult r = fn(&m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    const_cast<void*>(W), dims, strides, box, elem,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  memcpy(map_out, m, sizeof(m));
  return (int)cudaSuccess;
}

// The persistent grid: the blocks that fit the card at once (2 an SM: the
// kernel asks for the largest shared-memory carveout), or minus a
// cudaError_t.  Set up once a process (one card).
int moe_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_down_combine_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_down_combine_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, moe_down_combine_kernel, kThreads, kSmemBytes);
    if (e != cudaSuccess) return -(int)e;
    grid = min(per_sm, kBlocksPerSM) * sms;
  }
  return grid;
}

// h [M, E, F], c [M, E] bf16, out [M, D] bf16 (float32 with out_f32),
// contiguous, 16-byte aligned;
// wmaps from `moe_weight_map` for W_down [E, F, D]; ys an [M, E, D] bf16
// scratch; counters 1 + ceil(D / 128) int32 zeros.  F a multiple of 32, D
// of 8, E of 8 up to 256 (checked by the caller).
int moe_down_combine(const void* h, const void* wmaps, const void* c, void* ys,
                     void* counters, void* out, int M, int E, int F, int D,
                     int out_f32, void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  if (M < 0 || E < 8 || E % 8 || E > kMaxE || F < kFC || F % kFC || D < 8 ||
      D % 8)
    return (int)cudaErrorInvalidValue;
  const int grid = moe_grid();
  if (grid <= 0) return grid < 0 ? -grid : (int)cudaErrorInvalidConfiguration;
  Params p;
  memset(&p, 0, sizeof(p));
  memcpy(p.w, wmaps, sizeof(p.w));
  p.h = (const __nv_bfloat16*)h;
  p.c = (const __nv_bfloat16*)c;
  p.ys = (__nv_bfloat16*)ys;
  p.out = out;
  p.counters = (int*)counters;
  p.M = M;
  p.E = E;
  p.F = F;
  p.D = D;
  p.tiles = (D + kTD - 1) / kTD;
  p.out_f32 = out_f32;
  moe_down_combine_kernel<<<grid, kThreads, kSmemBytes,
                            (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
