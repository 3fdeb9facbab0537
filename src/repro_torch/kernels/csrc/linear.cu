// Hand-written Hopper (sm_90a) kernel: the serve step's products,
// y[M, N] = x[M, K] @ W[K, N], bf16 operands, float32 accumulation, bf16
// out (or float32 for the LM head), with every row's bits a function of
// that row of x and of W alone.
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
// The rule this kernel keeps: an output element is the float32 sum, in a
// fixed order, of S partial sums, slice s covering K rows
// [s*KS, min(K, (s+1)*KS)); each partial is a chain of m16n8k16 tensor-core
// products over 16 K rows at a time, in K order, starting from zero.  KS and
// S are chosen by the caller from (K, N) alone (`kernels/linear.py` `plan`),
// never from M; the slices' partials meet in a second pass that adds them in
// the order s = 0, 1, ..., S-1 (no atomics, whose order is not fixed).  A
// row's place in its 16-row tile, the other rows, the number of row tiles a
// block holds (MT) and the tail tile's zero rows change none of the
// operations on that row.
//
// What bounds it on the H100: bytes.  At the serve shapes (M <= 256 rows,
// K in {1536, 8960}) a weight element is used M times, far below the card's
// ~295 flop/byte ridge: a qwen2-1.5b step's weights are 2.62 GB of layers
// plus the 0.47 GB bf16 head, 0.92 ms at 3.35 TB/s.  What the design does:
//   * W read once from device memory whatever M is: a block owns 128
//     columns and one K slice, streams the slice through a 3-stage ring of
//     64-row tiles in shared memory (16-byte cp.async, rows padded by 16
//     bytes so ldmatrix is conflict-free) and, for each tile, runs it
//     against all its rows (up to 8 tiles of 16 rows, accumulators in
//     registers); M past 128 rows takes another row group (grid.z), which
//     reads the slice again (from L2 when it is still there);
//   * enough blocks for 132 SMs: S is about 132 / (N / 128), so the small
//     products (wq, wk, wv, wo, w_down) split K and the wide ones (w_gate,
//     w_up, the head) do not or barely;
//   * tensor cores through mma.sync.m16n8k16 (bf16, float32 accumulate),
//     A and B fragments by ldmatrix (B transposed from the row-major [K, N]
//     tile).  wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream it
// is given, allocates nothing (the split-K workspace [S, M, N] float32 comes
// from the caller) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;  // columns a block: 16 a warp, two n8 fragments
constexpr int kKC = 64;  // K rows a pipeline stage
constexpr int kStages = 3;
constexpr int kWPitch = kBN + 8;  // bf16 a shared W row (16-byte pad)
constexpr int kXPitch = kKC + 8;  // bf16 a shared x row (16-byte pad)
static_assert(kWarps * 16 == kBN, "a warp owns 16 columns");

template <int MT>
struct Smem {
  static constexpr int kW = kKC * kWPitch;  // bf16 elements a stage
  static constexpr int kX = MT * 16 * kXPitch;
  static constexpr int kBytes = kStages * (kW + kX) * 2;
};

struct Args {
  const __nv_bfloat16* x;  // [M, K]
  const __nv_bfloat16* w;  // [K, N]
  float* ws;  // [S, M, N] when S > 1
  void* out;  // [M, N] bf16, or float32 when out_f32
  int M, K, N, KS, S, out_f32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the destination is zero-filled
// and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: columns [n0, n0 + 128) of K slice blockIdx.y, rows
// [r0, r0 + 16*MT).  Warp w owns columns n0 + 16w .. + 16.
template <int MT>
__global__ void __launch_bounds__(kThreads)
    linear_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sx = sw + kStages * Smem<MT>::kW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int s = blockIdx.y;
  const int r0 = blockIdx.z * MT * 16;
  const int k_begin = s * a.KS;
  const int k_end = min(a.K, k_begin + a.KS);
  const int n_chunks = (k_end - k_begin + kKC - 1) / kKC;

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // K rows past the slice and columns past N load as zeros; rows past M
  // load as zeros and are never stored
  auto load = [&](int chunk, int stage) {
    const int kc = k_begin + chunk * kKC;
    __nv_bfloat16* dw = sw + stage * Smem<MT>::kW;
#pragma unroll
    for (int i = 0; i < kKC * kBN / 8 / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int row = p / (kBN / 8), col = (p % (kBN / 8)) * 8;
      const int k = kc + row, n = n0 + col;
      const bool ok = k < k_end && n < a.N;
      cp_async16(dw + row * kWPitch + col,
                 ok ? a.w + (size_t)k * a.N + n : a.w, ok);
    }
    __nv_bfloat16* dx = sx + stage * Smem<MT>::kX;
#pragma unroll
    for (int i = 0; i < (MT * 16 * kKC / 8 + kThreads - 1) / kThreads; ++i) {
      const int p = tid + i * kThreads;
      if (p < MT * 16 * kKC / 8) {
        const int row = p / (kKC / 8), col = (p % (kKC / 8)) * 8;
        const int m = r0 + row, k = kc + col;
        const bool ok = m < a.M && k < k_end;
        cp_async16(dx + row * kXPitch + col,
                   ok ? a.x + (size_t)m * a.K + k : a.x, ok);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load(st, st);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c-1
    if (c + kStages - 1 < n_chunks)
      load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const __nv_bfloat16* cw = sw + (c % kStages) * Smem<MT>::kW;
    const __nv_bfloat16* cx = sx + (c % kStages) * Smem<MT>::kX;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      // B: the warp's two n8 fragments, k rows kk..kk+15 (transposed)
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, cw + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWPitch +
                 warp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, cx + (mt * 16 + (lane & 15)) * kXPitch + kk +
                            (lane >> 4) * 8);
        mma_bf16(acc[mt][0], af, b[0], b[1]);
        mma_bf16(acc[mt][1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1: row lane/4, columns 2*(lane%4) + {0, 1}; c2, c3: row + 8
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r0 + mt * 16 + g + h * 8;
        const int n = n0 + warp * 16 + j * 8 + t2;
        if (m >= a.M || n >= a.N) continue;  // N % 8 == 0: n + 1 < N too
        const float v0 = acc[mt][j][2 * h], v1 = acc[mt][j][2 * h + 1];
        const size_t at = (size_t)m * a.N + n;
        if (a.S > 1) {
          *reinterpret_cast<float2*>(a.ws + (size_t)s * a.M * a.N + at) =
              make_float2(v0, v1);
        } else if (a.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + at) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
}

// out = ws[0] + ws[1] + ... + ws[S-1], added in that order; four elements
// a thread
__global__ void linear_splitk_sum_kernel(const float* __restrict__ ws,
                                         void* out, int S, long long MN,
                                         int out_f32) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= MN) return;
  float4 acc = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < S; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + s * MN + i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = acc;
  } else {
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i);
    o[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

template <int MT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static bool opted_in = false;  // shared memory past 48 KB, once
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        linear_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<MT>::kBytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  dim3 grid((a.N + kBN - 1) / kBN, a.S, (a.M + MT * 16 - 1) / (MT * 16));
  linear_mma_kernel<MT><<<grid, kThreads, Smem<MT>::kBytes, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.S == 1) return e;
  const long long MN = (long long)a.M * a.N;
  const long long blocks = (MN / 4 + 255) / 256;
  linear_splitk_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      a.ws, a.out, a.S, MN, a.out_f32);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x [M, K] and w [K, N] bf16, contiguous, 16-byte aligned, K % 8 == 0,
// N % 8 == 0; KS a multiple of 64 and S = ceil(K / KS) (from `plan`, a
// function of K and N); ws [S, M, N] float32 when S > 1 (else null); MT the
// 16-row tiles a block holds (1, 2, 4 or 8); out [M, N] bf16, or float32
// with out_f32.
int linear(const void* x, const void* w, float* ws, void* out, int M, int K,
           int N, int KS, int S, int MT, int out_f32, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if (K < 1 || K % 8 || N % 8 || KS < kKC || KS % kKC ||
      S != (K + KS - 1) / KS || S > 65535 || (S > 1) != (ws != nullptr) ||
      (long long)M * N * 4 > (1ll << 40))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(x),
         static_cast<const __nv_bfloat16*>(w), ws, out, M, K, N, KS, S,
         out_f32};
  cudaStream_t st = (cudaStream_t)stream;
  switch (MT) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 4: return (int)launch<4>(a, st);
    case 8: return (int)launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
