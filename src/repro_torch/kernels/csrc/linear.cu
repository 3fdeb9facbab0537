// Hand-written Hopper (sm_90a) kernel: the serve step's products,
// y[M, N] = x[M, K] @ W[K, N], bf16 operands, float32 accumulation, bf16
// out (or float32 for the LM head), with every row's bits a function of
// that row of x and of W alone.  One launch computes a group of products
// that share x (q/k/v, gate/up): each member keeps its own K slices, so
// its output is bitwise what that weight gives when launched alone.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (`jnp` dots in src/repro/nn/attention.py and src/repro/nn/mlp.py, the
// head's bf16 x bf16 einsum with float32 accumulation at
// src/repro/arch/model.py:330).  The port needs its own because nothing in
// cuBLAS promises that a row's result does not depend on M: its heuristics
// pick kernels and split-K by shape, so a chunked prefill step ([B*C, K])
// and a token-by-token one ([B, K]) gave a row other bits, and chunked
// prefill, prefix sharing and speculative verify could not stay bitwise.
//
// The rule this kernel keeps: an output element is the float32 sum, in the
// order s = 0, 1, ..., S-1, of S partial sums, slice s covering K rows
// [s*KS, min(K, (s+1)*KS)); each partial is a chain of
// wgmma.m64n128k16 products over 16 K rows at a time, in K order, starting
// from zero.  KS and S come from (K, N) alone (`kernels/linear.py` `plan`),
// never from M, and the instruction shape is the same for every M.  A
// row's place in its 64-row tile, the other rows, the tiles a block holds
// and the zero rows TMA fills past M change none of the operations on that
// row.
//
// What bounds it on the H100: bytes.  At the serve shapes (M <= 256 rows,
// K in {1536, 8960}) a weight element is used M times, far below the card's
// ~295 flop/byte ridge: a qwen2-1.5b step's weights are 2.62 GB of layers
// plus the 0.47 GB bf16 head, 0.92 ms at 3.35 TB/s.  The design:
//   * a block owns 128 columns of one member, one K slice and up to 128
//     rows (one or two 64-row tiles; more rows take another row group,
//     grid.y, which reads the slice again, from L2 when it is still there);
//   * one producer warp streams the slice through a 96 KB ring in shared
//     memory with TMA (cp.async.bulk.tensor, swizzled, mbarrier
//     completion), so two blocks share an SM: 4 stages of 64 K rows with
//     one row tile, 6 of 32 with two; a stage is those K rows of W (two
//     64-column boxes, 128-byte swizzle) and of x (one box a row tile;
//     TMA zero-fills rows past M and K past the end, so the tail tiles
//     need no code of their own);
//   * one consumer warpgroup a row tile runs wgmma.mma_async (A = x,
//     K-major; B = W, MN-major) into 64 float32 registers a thread;
//   * the S slices of a column tile are one thread-block cluster (S <= 8):
//     each block leaves its partial in its shared memory and, after a
//     cluster barrier, adds a share of the tile's elements over the
//     cluster's shared memory in slice order, so there is no workspace in
//     device memory, no second pass and no atomic;
//   * S gives each product at least 48 blocks and each slice at most 1600
//     K rows: wq and wo split 4 ways, wk, wv and w_down 8, and the wide
//     w_gate, w_up and the head not at all.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream it
// is given, allocates nothing and returns cudaGetLastError().  The tensor
// maps are encoded with cuTensorMapEncodeTiled, reached through the runtime
// (no link against libcuda); a weight's map is encoded once by the caller
// (`linear_weight_map`) and passed back on every launch, x's is encoded at
// each launch.  Maps are kernel parameters (__grid_constant__), so a CUDA
// graph captures them by value with the addresses of its own buffers.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 128;  // columns a block: one wgmma's N
constexpr int kBM = 64;  // rows a consumer warpgroup (wgmma's M)
constexpr int kRingBytes = 96 * 1024;  // the ring: two blocks an SM
constexpr int kMaxGroup = 3;  // products one launch computes
constexpr int kMaxSlices = 8;  // the portable cluster size
constexpr int kMapBytes = 128;  // sizeof(CUtensorMap)
constexpr int kPitch = kBN + 4;  // floats a row of a block's partial

// MT 64-row tiles a block.  A stage is BK K rows: 64 with one row tile
// (x rows of 128 bytes, 128-byte swizzle; 4 stages), 32 with two (x rows
// of 64 bytes, 64-byte swizzle; 6 stages), so the ring stays 96 KB and two
// blocks fit an SM.  BK sets only how far a load reaches, not the sums.
template <int MT>
struct Cfg {
  static constexpr int kThreads = 128 * MT + 32;  // consumers + producer
  static constexpr int kBK = MT == 1 ? 64 : 32;
  static constexpr int kXRow = 2 * kBK;  // bytes of an x row in a stage
  static constexpr int kWBox = kBK * 64 * 2;  // a W box: BK x 64 columns
  static constexpr int kXBox = kBM * kXRow;  // an x box: 64 rows x BK
  static constexpr int kStage = 2 * kWBox + MT * kXBox;
  static constexpr int kStages = kRingBytes / kStage;  // 4 or 6
  static constexpr int kPart = MT * kBM * kPitch * 4;
  static constexpr int kSmem = 1024 + (kRingBytes > kPart ? kRingBytes
                                                          : kPart);
  static_assert(kStages >= 4, "at least 4 stages in flight");
  static_assert(sizeof(CUtensorMap) == kMapBytes, "a map is 128 bytes");
};

struct __align__(64) Params {
  CUtensorMap x;  // [M, K], box BK x 64 rows, BK*2-byte swizzle
  CUtensorMap w[kMaxGroup];  // [K, N_g], box 64 x BK rows, 128-byte swizzle
  void* out[kMaxGroup];  // [M, N_g]
  int N[kMaxGroup], KS[kMaxGroup], S[kMaxGroup], tiles[kMaxGroup];
  int start[kMaxGroup + 1];  // member g's first block, a multiple of the
                             // cluster size
  int M, K, G, out_f32;
};

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

// the map's box at (c0 inner, c1 outer) into shared memory, its bytes
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

// shared-memory matrix descriptor; offsets in bytes, layout 1 for the
// 128-byte swizzle and 2 for the 64-byte one
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 128] += a[64 x 16] . b[16 x 128]: a K-major, b MN-major (the
// row-major [K, N] weight), bf16 in, float32 accumulate
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// four float32 values of row `at` (a multiple of 4 elements) to out
__device__ __forceinline__ void store4(void* out, size_t at, float4 v,
                                       int out_f32) {
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + at) = v;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) = u;
  }
}

// One block: columns [n0, n0 + 128) of member g, K slice s, rows
// [r0, r0 + 64*MT).  Warps 0 .. 4*MT-1 are the consumers (warpgroup t owns
// row tile t), warp 4*MT the producer.
template <int MT>
__global__ void __launch_bounds__(Cfg<MT>::kThreads)
    linear_wgmma_kernel(const __grid_constant__ Params p) {
  using C = Cfg<MT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages], empty[C::kStages];
  // swizzled boxes sit on 1024-byte boundaries
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int b = blockIdx.x;
  int g = 0;
  while (g + 1 < p.G && b >= p.start[g + 1]) ++g;
  const int S = p.S[g], N = p.N[g];
  const int local = b - p.start[g];
  const int s = local % S, tile = local / S;
  const bool real = tile < p.tiles[g];  // else a cluster's padding block
  const int n0 = tile * kBN, r0 = blockIdx.y * MT * kBM;
  const int k0 = s * p.KS[g], k1 = min(p.K, k0 + p.KS[g]);
  const int chunks = real ? (k1 - k0 + C::kBK - 1) / C::kBK : 0;

  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * MT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (warp == 4 * MT) {
    // producer: one lane keeps up to kStages chunks in flight
    if (lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int st = c % C::kStages;
        mbar_wait(&empty[st], ((c / C::kStages) & 1) ^ 1);
        unsigned char* buf = smem + st * C::kStage;
        mbar_expect_tx(&full[st], C::kStage);
        const int k = k0 + c * C::kBK;
        tma_load(buf, &p.w[g], &full[st], n0, k);
        tma_load(buf + C::kWBox, &p.w[g], &full[st], n0 + 64, k);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          tma_load(buf + 2 * C::kWBox + m * C::kXBox, &p.x, &full[st], k,
                   r0 + m * kBM);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp >> 2;
    for (int c = 0; c < chunks; ++c) {
      const int st = c % C::kStages;
      mbar_wait(&full[st], (c / C::kStages) & 1);
      const uint32_t wa = smem_u32(smem + st * C::kStage);
      const uint32_t xa = wa + 2 * C::kWBox + wg * C::kXBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk)
        // A (x, K-major, swizzled over its BK*2-byte rows): 16 K columns =
        // 32 bytes along the rows, 8-row groups 8 rows apart (SBO).  B (W,
        // MN-major, 128-byte swizzle): 16 K rows of 128 bytes, 8-row
        // groups 1024 bytes apart (SBO), the second 64-column box next
        // (LBO).
        wgmma_m64n128k16(
            acc, smem_desc(xa + kk * 32, 16, 8 * C::kXRow, MT == 1 ? 1 : 2),
            smem_desc(wa + kk * 2048, C::kWBox, 1024, 1));
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // accumulator layout (per warp: 16 rows, as mma.sync's m16n8 repeated
  // over the 16 column groups j): acc[4j + 2h + e] is row
  // 16*(warp%4) + lane/4 + 8h of the warpgroup's tile, column
  // 8j + 2*(lane%4) + e
  const int rows = min(MT * kBM, p.M - r0);
  const int cols = min(kBN, N - n0);
  if (S == 1) {
    if (!real || warp >= 4 * MT) return;
    const int wg = warp >> 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * kBM + (warp & 3) * 16 + (lane >> 2) + 8 * h;
        const int c = 8 * j + 2 * (lane & 3);
        if (r >= rows || c >= cols) continue;  // N % 8 == 0: c + 1 < N too
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const size_t at = (size_t)(r0 + r) * N + n0 + c;
        if (p.out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out[g]) + at) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out[g]) + at) =
              __floats2bfloat162_rn(v0, v1);
      }
    return;
  }

  // S > 1: the partial goes to this block's shared memory (over the ring:
  // every load has landed and every wgmma has read its stage)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  if (warp < 4 * MT) {
    const int wg = warp >> 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * kBM + (warp & 3) * 16 + (lane >> 2) + 8 * h;
        if (r >= rows) continue;
        const int c = 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(part + r * kPitch + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every slice's partial is in its block's shared memory
  if (real) {
    // this block adds elements s, s + S, ... (in float4 groups) of the
    // tile, each as slice 0 + slice 1 + ... + slice S-1; the S loads of a
    // group are issued together
    const int base = (int)cluster.block_rank() - s;
    const float4* src[kMaxSlices];
#pragma unroll
    for (int q = 0; q < kMaxSlices; ++q)
      src[q] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, base + (q < S ? q : 0)));
    const int groups = rows * (kBN / 4);
    for (int i = s * blockDim.x + tid; i < groups; i += S * blockDim.x) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      if (c >= cols) continue;  // N % 8 == 0: whole groups of 4
      const int at = (r * kPitch + c) / 4;
      float4 u[kMaxSlices];
#pragma unroll
      for (int q = 0; q < kMaxSlices; ++q)
        if (q < S) u[q] = src[q][at];
      float4 v = u[0];
#pragma unroll
      for (int q = 1; q < kMaxSlices; ++q)
        if (q < S) {
          v.x += u[q].x;
          v.y += u[q].y;
          v.z += u[q].z;
          v.w += u[q].w;
        }
      store4(p.out[g], (size_t)(r0 + r) * N + n0 + c, v, p.out_f32);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
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

// the map of a row-major bf16 [rows, cols] matrix: boxes of box_rows x
// (swizzle bytes / 2) columns, zeros past its edges
cudaError_t encode(CUtensorMap* map, const void* ptr, long long rows,
                   long long cols, int box_rows, int swizzle) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)swizzle / 2, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MT>
cudaError_t launch(const Params& p, int blocks, int cluster,
                   cudaStream_t st) {
  static bool opted_in = false;  // shared memory past 48 KB, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        linear_wgmma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<MT>::kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, (p.M + MT * kBM - 1) / (MT * kBM), 1);
  cfg.blockDim = dim3(Cfg<MT>::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Cfg<MT>::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, linear_wgmma_kernel<MT>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// the tensor maps of a weight w [K, N] (bf16, contiguous, 16-byte aligned,
// N % 8 == 0) into map_out (2 x 128 bytes: boxes of 64 and of 32 K rows,
// for one and two row tiles); the caller keeps them for every launch with
// that weight
int linear_weight_map(const void* w, int K, int N, void* map_out) {
  if (K < 1 || N < 8 || N % 8 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[2];
  cudaError_t e = encode(&m[0], w, K, N, Cfg<1>::kBK, 128);
  if (e == cudaSuccess) e = encode(&m[1], w, K, N, Cfg<2>::kBK, 128);
  if (e == cudaSuccess) memcpy(map_out, m, sizeof(m));
  return (int)e;
}

// y_g = x @ w_g for the G members (G <= 3) in one launch.  x [M, K] bf16,
// contiguous, 16-byte aligned, K % 8 == 0; wmaps[g] from
// `linear_weight_map`; outs[g] [M, N_g] bf16, or float32 with out_f32;
// (KS_g, S_g) from `plan(K, N_g)`: KS a multiple of 64, S = ceil(K / KS)
// in {1, 2, 4, 8}; MT the 64-row tiles a block holds (1 or 2).
int linear(const void* x, int M, int K, int G, const void* const* wmaps,
           void* const* outs, const int* Ns, const int* KSs, const int* Ss,
           int MT, int out_f32, void* stream) {
  if (M == 0) return (int)cudaGetLastError();
  if (M < 0 || K < 1 || K % 8 || G < 1 || G > kMaxGroup ||
      reinterpret_cast<uintptr_t>(x) % 16 || (MT != 1 && MT != 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  int cluster = 1;
  for (int g = 0; g < G; ++g) {
    const int S = Ss[g], KS = KSs[g], N = Ns[g];
    if (N < 8 || N % 8 || KS < 64 || KS % 64 || S != (K + KS - 1) / KS ||
        (S & (S - 1)) || S > kMaxSlices ||
        reinterpret_cast<uintptr_t>(outs[g]) % 16)
      return (int)cudaErrorInvalidValue;
    cluster = S > cluster ? S : cluster;
    memcpy(&p.w[g], static_cast<const char*>(wmaps[g]) + (MT - 1) * kMapBytes,
           sizeof(CUtensorMap));
    p.out[g] = outs[g];
    p.N[g] = N;
    p.KS[g] = KS;
    p.S[g] = S;
    p.tiles[g] = (N + kBN - 1) / kBN;
  }
  long long blocks = 0;
  for (int g = 0; g < G; ++g) {
    p.start[g] = (int)blocks;
    const long long n = (long long)p.tiles[g] * p.S[g];
    blocks += (n + cluster - 1) / cluster * cluster;
  }
  p.start[G] = (int)blocks;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  p.M = M;
  p.K = K;
  p.G = G;
  p.out_f32 = out_f32;
  cudaError_t e = MT == 1 ? encode(&p.x, x, M, K, kBM, 2 * Cfg<1>::kBK)
                          : encode(&p.x, x, M, K, kBM, 2 * Cfg<2>::kBK);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(MT == 1 ? launch<1>(p, (int)blocks, cluster, st)
                       : launch<2>(p, (int)blocks, cluster, st));
}

}  // extern "C"
