// Hand-written Hopper (sm_90a) kernel: paged attention over a block-table
// KV cache, for decode (C = 1) and prefill chunks (C > 1).
//
// Replaces the Pallas kernel `paged_attention`
// (src/repro/kernels/paged_attention.py:107), which walked each slot's block
// table with scalar-prefetched BlockSpec index maps, staged the whole
// batch's logical [B, S, KV, hd] K/V view in VMEM and attended once, at the
// last grid step, with the jnp oracle's own op sequence.  That design does
// not carry over: at the serve shape (B = 16, S = 1024, KV = 2, hd = 128,
// bf16) the staged view is 8 MB, far past a block's shared memory, and
// Hopper's blocks run in no order, so there is no "last grid step".
//
// What bounds it on the H100: bytes.  A decode launch reads every mapped
// K and V page once (16.8 MB at the serve shape) and does about 4 flops a
// byte, far below the card's ~295 flop/byte ridge.  What this first design
// does about it: each page is read from device memory once per KV head
// group (the GQA query heads of a group share the load, so K/V are never
// repeated H/KV times as the plain version's repeat_kv does), int8 pages
// are dequantized in registers, and nothing of size S is written back.
// Making it fast (cp.async/TMA page loads, one block per KV group over
// several C rows, skipping pages wholly past max(pos)) is later work.
//
// Design, one block per (b, c, kv_head) row group, i.e. the G = H/KV query
// heads of one GQA group for one query position:
//   1. load the group's G query rows and the slot's block-table row
//      (clipped to [0, N-1], as the oracle's gather clips) into shared
//      memory;
//   2. scores: thread t takes logical positions s = t, t + 256, ...; for
//      each it walks the K row of s (page tbl[s / page], row s % page) and
//      accumulates the G dot products in float32, d = 0 .. hd-1 in order.
//      Each score is rounded to q's type where the oracle rounds (after
//      the q.k einsum), divided by sqrt(hd) in float32, and the additive
//      mask (0 or -2^30: causal + window on absolute positions) added;
//   3. softmax over the full axis, one warp per head: max, then
//      exp(x - max) and its sum, then e / sum rounded to q's type;
//   4. P.V: thread (part, d) sums p[g, s] * v[s, d] over s = part,
//      part + n_parts, ... in float32; the parts are added in order and
//      the result written in q's type.
// No online softmax: every sum runs over logical positions in an order
// fixed by S and hd alone, so a row's result is bitwise the same whatever
// the batch size, the chunk width or the physical page order.  Masked
// positions get exp(-2^30 - max) = 0 exactly, which kills stale rows of
// recycled pages and table entries past the pool, as in the oracle.
//
// Plain C interface, loaded with ctypes; the entry launches on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // query heads per KV head
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

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float as_float(int8_t x) { return (float)x; }

template <typename QT, typename PT>
__device__ __forceinline__ float dequant(PT x, float scale_q, bool quantized) {
  return quantized ? to_q<QT>(as_float(x) * scale_q) : to_q<QT>(as_float(x));
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

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                       const PT* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ tbl,
                       const int32_t* __restrict__ pos, QT* __restrict__ out,
                       int C, int H, int KV, int hd, int N, int page,
                       int n_ps, int window, float sqrt_hd) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int S = n_ps * page;
  const int n_parts = kThreads / hd;
  float* q_s = smem;                      // [G, hd]
  float* sc = q_s + G * hd;               // [G, S] scores, then probs
  float* red = sc + (size_t)G * S;        // [n_parts, G, hd]
  int* tbl_s = (int*)(red + n_parts * G * hd);  // [n_ps]

  const int kvh = blockIdx.x % KV;
  const int bc = blockIdx.x / KV;  // b * C + c
  const int b = bc / C;
  const bool quantized = ks != nullptr;
  const int t = threadIdx.x;

  const QT* qrow = q + ((size_t)bc * H + (size_t)kvh * G) * hd;
  for (int i = t; i < G * hd; i += kThreads) q_s[i] = as_float(qrow[i]);
  for (int i = t; i < n_ps; i += kThreads) {
    int p = tbl[(size_t)b * n_ps + i];
    tbl_s[i] = p < 0 ? 0 : (p > N - 1 ? N - 1 : p);
  }
  const int qpos = pos[bc];
  __syncthreads();

  // 2. scores
  for (int s = t; s < S; s += kThreads) {
    const size_t row =
        ((size_t)tbl_s[s / page] * page + s % page) * KV + kvh;
    const PT* kr = kp + row * hd;
    const float scale_q = quantized ? to_q<QT>(ks[row]) : 1.0f;
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kv = dequant<QT, PT>(kr[d], scale_q, quantized);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += q_s[g * hd + d] * kv;
    }
    const int diff = qpos - s;
    const bool ok = diff >= 0 && (window <= 0 || diff < window);
    const float mask = ok ? 0.0f : kNegInf;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) sc[(size_t)g * S + s] = to_q<QT>(acc[g]) / sqrt_hd + mask;
  }
  __syncthreads();

  // 3. softmax over the full axis, one warp per head
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < G; g += kWarps) {
    float* row = sc + (size_t)g * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) row[s] = to_q<QT>(row[s] / sum);
  }
  __syncthreads();

  // 4. P.V
  const int part = t / hd, d = t % hd;
  if (part < n_parts) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.0f;
#pragma unroll 4
    for (int s = part; s < S; s += n_parts) {
      const size_t row =
          ((size_t)tbl_s[s / page] * page + s % page) * KV + kvh;
      const float scale_q = quantized ? to_q<QT>(vs[row]) : 1.0f;
      const float v = dequant<QT, PT>(vp[row * hd + d], scale_q, quantized);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += sc[(size_t)g * S + s] * v;
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) red[(part * G + g) * hd + d] = acc[g];
  }
  __syncthreads();
  QT* orow = out + ((size_t)bc * H + (size_t)kvh * G) * hd;
  for (int i = t; i < G * hd; i += kThreads) {
    const int g = i / hd, dd = i % hd;
    float o = 0.0f;
    for (int p = 0; p < n_parts; ++p) o += red[(p * G + g) * hd + dd];
    store(orow + i, o);
  }
}

// Shared-memory bytes one block needs: its group's query rows, the [G, S]
// scores, the P.V partial sums and the block-table row.
long long smem_bytes(int H, int KV, int hd, int n_ps, int page) {
  const long long G = H / KV, S = (long long)n_ps * page;
  const long long n_parts = kThreads / hd;
  return 4 * (G * hd + G * S + n_parts * G * hd + n_ps);
}

template <typename QT, typename PT>
int launch(const void* q, const void* kp, const void* vp, const float* ks,
           const float* vs, const int32_t* tbl, const int32_t* pos,
           void* out, int B, int C, int H, int KV, int hd, int N, int page,
           int n_ps, int window, float sqrt_hd, size_t smem,
           cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, PT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {  // past the card's opt-in shared memory
      cudaGetLastError();  // clear it, so later launches do not report it
      return (int)err;
    }
  }
  const long long blocks = (long long)B * C * KV;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const QT*)q, (const PT*)kp, (const PT*)vp, ks, vs, tbl, pos, (QT*)out,
      C, H, KV, hd, N, page, n_ps, window, sqrt_hd);
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
  if (KV < 1 || H % KV || H / KV > kMaxGroup || hd < 1 || hd > kThreads ||
      N < 1 || page < 1 || n_ps < 1 || (pool_dtype == 2) != (k_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long smem_ll = smem_bytes(H, KV, hd, n_ps, page);
  if (smem_ll > INT32_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_ll;
  cudaStream_t st = (cudaStream_t)stream;
#define PA_LAUNCH(QT, PT)                                                    \
  return launch<QT, PT>(q, k_pages, v_pages, k_scale, v_scale, block_tbl,    \
                        positions, out, B, C, H, KV, hd, N, page, n_ps,      \
                        window, sqrt_hd, smem, st)
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
