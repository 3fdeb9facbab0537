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
//               and casts back to int32, which wraps the same way); codes
//               lie in [0, V) (the LB predictor clips first).
//   bnn:        counts[b, n] = sum_w popcount(~(x[b, w] ^ w[n, w])) over
//               every word as it is: pad bits (zero in x and in w) count as
//               matches, and the caller subtracts them.
//
// Both kernels share one shape: a block walks tiles of R consecutive batch
// rows (grid-stride, so a small table staged in shared memory is loaded
// once per block, not once per tile); it stages the tile's input rows with
// coalesced loads, then its threads take the tile's R * C outputs with the
// output column fastest, so that consecutive threads store consecutive
// words of the [B, C] result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory kept at or under the 48 KB that needs no opt-in.
constexpr int kSmemBytes = 48 * 1024;
// Share of it for the staged input rows of one tile.
constexpr int kRowSmemBytes = 16 * 1024;
// Outputs one tile aims at (about four per thread).
constexpr int kTileOutputs = 4 * kThreads;
// Resident blocks per SM the grid is sized for.
constexpr int kBlocksPerSm = 4;

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
      for (int f = 0; f < F; ++f)
        acc += (uint32_t)lut[(f * V + s_codes[r * F + f]) * K + k];
      out[r0 * K + i] = (int32_t)acc;
    }
  }
}

// --------------------------------------------------- bnn_popcount_matmul
// The [N, W] packed weights sit in shared memory when they fit beside the
// x tile; past that budget they are read through the cache.
__global__ void bnn_popcount_kernel(const uint32_t* __restrict__ x,
                                    const uint32_t* __restrict__ w,
                                    int32_t* __restrict__ out, int B, int N,
                                    int W, int R, int w_in_smem) {
  extern __shared__ uint32_t usmem[];
  uint32_t* s_x = usmem;
  uint32_t* s_w = usmem + R * W;
  if (w_in_smem)
    for (int i = threadIdx.x; i < N * W; i += blockDim.x) s_w[i] = w[i];
  const uint32_t* wt = w_in_smem ? s_w : w;
  const int n_tiles = (B + R - 1) / R;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = (long long)tile * R;
    const int rows = (int)min((long long)R, (long long)B - r0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * W; i += blockDim.x)
      s_x[i] = x[r0 * W + i];
    __syncthreads();
    for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
      const int r = i / N, n = i - r * N;
      const uint32_t* xr = s_x + r * W;
      const uint32_t* wr = wt + (long long)n * W;
      int count = 0;
      for (int j = 0; j < W; ++j) count += __popc(~(xr[j] ^ wr[j]));
      out[r0 * N + i] = count;
    }
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
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
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

int bnn_popcount_matmul(const uint32_t* x, const uint32_t* w, int32_t* out,
                        int B, int N, int W, void* stream) {
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  if (W < 1) return (int)cudaErrorInvalidValue;
  const int R = tile_rows(B, W, N);
  const long long row_bytes = (long long)R * W * 4;
  const long long w_bytes = (long long)N * W * 4;
  const int w_in_smem = row_bytes + w_bytes <= kSmemBytes ? 1 : 0;
  const size_t smem = (size_t)(row_bytes + (w_in_smem ? w_bytes : 0));
  bnn_popcount_kernel<<<grid_for(B, R), kThreads, smem,
                        (cudaStream_t)stream>>>(x, w, out, B, N, W, R,
                                                w_in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
