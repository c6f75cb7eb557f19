// Per-channel row reductions: statistics (kernel K3) and abs-max (K7).
//
// Replaces the Pallas kernel in unitspeech_tpu/ops/pallas_stats.py:
// row_stats (_row_stats_pallas, body _stats_kernel): x (B, n, C) ->
// (B, 2, C) f32 with [:, 0] the sum over rows and [:, 1] the sum of squares.
// These feed the GroupNorm of the deep U-Net blocks (F = 20, 10).
//
// What bounds it on the H100: bytes. One pass reads the activation once
// (1.8-5.3 MB per call at the main-path shapes); the work per byte is two
// FMAs. The TPU kernel reduced one batch element's whole slab in one grid
// step; here a block takes 128 rows x 64 channels (neighbouring threads on
// neighbouring channels, so the loads coalesce) and writes a partial, and a
// second tiny kernel sums the partials in a fixed order. Enough blocks are
// in flight to cover the SMs, and the result is deterministic.
//
// K7 replaces the Pallas kernel in unitspeech_tpu/ops/pallas_stats.py:
// row_absmax (_row_absmax_pallas, body _absmax_kernel): x (B, n, C) -> (B, C)
// f32 max |x| over rows, whose overall max sets the per-tensor int8 scale of
// the deep-stage convs (ops/conv_matmul.py conv3x3_int8). Also bytes-bound
// (0.9-5.3 MB per call at the main-path shapes, one compare per element),
// so the same structure: 128-row chunks, each thread 8 channels through one
// 16-byte load, partials reduced by a second kernel. A max does not depend
// on the order, so the result equals the plain version bit for bit; a NaN
// propagates as torch.amax propagates it. The TPU kernel's VMEM gate
// (pallas_stats.supported) has no counterpart: any C % 8 == 0 is taken.
#include "common.cuh"

namespace {

constexpr int RPC = 128;  // rows per chunk
constexpr int CPB = 64;   // channels per block: 32 lanes x 2

template <typename TIn>
__device__ __forceinline__ float2 load2(const TIn* p);

template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename TIn>
__global__ void __launch_bounds__(256) row_stats_partial(const TIn* x, float* part, int n,
                                                         int C) {
  __shared__ float red[8][2][CPB];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int c = blockIdx.x * CPB + lane * 2;
  const int chunk = blockIdx.y, n_chunks = gridDim.y, b = blockIdx.z;
  const int r_end = min(n, (chunk + 1) * RPC);
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  if (c < C) {
    const TIn* xb = x + (size_t)b * n * C + c;
    for (int r = chunk * RPC + rg; r < r_end; r += 8) {
      float2 v = load2<TIn>(xb + (size_t)r * C);
      s0 += v.x;
      s1 += v.y;
      q0 += v.x * v.x;
      q1 += v.y * v.y;
    }
  }
  red[rg][0][lane * 2] = s0;
  red[rg][0][lane * 2 + 1] = s1;
  red[rg][1][lane * 2] = q0;
  red[rg][1][lane * 2 + 1] = q1;
  __syncthreads();
  if (threadIdx.x < 2 * CPB) {
    int st = threadIdx.x / CPB, cl = threadIdx.x % CPB;
    int cc = blockIdx.x * CPB + cl;
    if (cc < C) {
      float t = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) t += red[g][st][cl];
      part[(((size_t)b * n_chunks + chunk) * 2 + st) * C + cc] = t;
    }
  }
}

__global__ void __launch_bounds__(256) row_stats_reduce(const float* part, float* out,
                                                        int n_chunks, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // st * C + c
  const int b = blockIdx.y;
  if (i >= 2 * C) return;
  float t = 0.f;
  for (int j = 0; j < n_chunks; ++j) t += part[((size_t)b * n_chunks + j) * 2 * C + i];
  out[(size_t)b * 2 * C + i] = t;
}

constexpr int AM_RPC = 128;  // rows per chunk
constexpr int AM_CPB = 256;  // channels per block: 32 lanes x 8

US_DEV float nan_max(float m, float v) { return (v > m || v != v) ? v : m; }

template <typename TIn>
US_DEV void load8f(const TIn* p, float (&v)[8]);

template <>
US_DEV void load8f<bf16>(const bf16* p, float (&v)[8]) {
  load8(p, v);
}

template <>
US_DEV void load8f<float>(const float* p, float (&v)[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename TIn>
__global__ void __launch_bounds__(256) row_absmax_partial(const TIn* x, float* part, int n,
                                                          int C) {
  __shared__ float red[8][AM_CPB];
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int c = blockIdx.x * AM_CPB + lane * 8;
  const int chunk = blockIdx.y, n_chunks = gridDim.y, b = blockIdx.z;
  const int r_end = min(n, (chunk + 1) * AM_RPC);
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0.f;
  if (c < C) {
    const TIn* xb = x + (size_t)b * n * C + c;
    for (int r = chunk * AM_RPC + rg; r < r_end; r += 8) {
      float v[8];
      load8f<TIn>(xb + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = nan_max(m[i], fabsf(v[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rg][lane * 8 + i] = m[i];
  __syncthreads();
  const int cl = threadIdx.x, cc = blockIdx.x * AM_CPB + cl;
  if (cc < C) {
    float t = red[0][cl];
#pragma unroll
    for (int g = 1; g < 8; ++g) t = nan_max(t, red[g][cl]);
    part[((size_t)b * n_chunks + chunk) * C + cc] = t;
  }
}

__global__ void __launch_bounds__(256) row_absmax_reduce(const float* part, float* out,
                                                         int n_chunks, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const float* pb = part + (size_t)b * n_chunks * C + c;
  float t = pb[0];
  for (int j = 1; j < n_chunks; ++j) t = nan_max(t, pb[(size_t)j * C]);
  out[(size_t)b * C + c] = t;
}

}  // namespace

extern "C" {

const char* us_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int us_row_stats_chunks(int n) { return us_ceil_div(n, RPC); }

// x: (B, n, C), bf16 when is_bf16 else f32; C even. part: (B, chunks, 2, C)
// scratch; out: (B, 2, C) f32.
int us_row_stats(const void* x, int is_bf16, float* part, float* out, int B, int n, int C,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunks = us_ceil_div(n, RPC);
  dim3 grid(us_ceil_div(C, CPB), chunks, B);
  if (is_bf16)
    row_stats_partial<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x), part, n, C);
  else
    row_stats_partial<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), part, n, C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  row_stats_reduce<<<dim3(us_ceil_div(2 * C, 256), B), 256, 0, st>>>(part, out, chunks, C);
  return (int)cudaGetLastError();
}

int us_row_absmax_chunks(int n) { return us_ceil_div(n, AM_RPC); }

// x: (B, n, C), bf16 when is_bf16 else f32; C % 8 == 0, 16-byte aligned.
// part: (B, chunks, C) scratch; out: (B, C) f32.
int us_row_absmax(const void* x, int is_bf16, float* part, float* out, int B, int n, int C,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int chunks = us_ceil_div(n, AM_RPC);
  dim3 grid(us_ceil_div(C, AM_CPB), chunks, B);
  if (is_bf16)
    row_absmax_partial<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(x), part, n, C);
  else
    row_absmax_partial<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), part, n, C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  row_absmax_reduce<<<dim3(us_ceil_div(C, 256), B), 256, 0, st>>>(part, out, chunks, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
