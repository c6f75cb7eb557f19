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
// (1.3-10.6 MB per call at the main-path shapes, one compare per element:
// 1-3 us at 3.35 TB/s), so a call is latency: one launch. A cluster of
// AM_CL blocks owns 128 channels of one batch element and splits its rows
// into AM_CL slices; a block's 256 threads are 16 channel lanes (8 channels,
// one 16-byte load a row) x 16 row groups, eight loads in flight a thread.
// Each block reduces its slice in shared memory; the cluster then reduces
// the AM_CL partial maxima through distributed shared memory, each block
// for 128 / AM_CL of the channels, in a fixed order: no scratch, no second
// launch, deterministic. A max does not depend on the order, so the result
// equals the plain version bit for bit; a NaN propagates as torch.amax
// propagates it. The TPU kernel's VMEM gate (pallas_stats.supported) has no
// counterpart: any C % 8 == 0 and n >= 1 is taken.
#include <cooperative_groups.h>

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

constexpr int AM_CL = 8;     // blocks of a cluster: the row slices of 128 channels
constexpr int AM_CPB = 128;  // channels a block: 16 lanes x 8
constexpr int AM_RG = 16;    // row groups a block
constexpr int AM_UNROLL = 8; // loads in flight a thread

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

// Block (channel slice, rank, batch element); the cluster spans the ranks.
// Rank q reads rows [q rows, (q + 1) rows), rows = ceil(n / AM_CL); its row
// group g every AM_RG-th row from q rows + g.
template <typename TIn>
__global__ void __cluster_dims__(1, AM_CL, 1) __launch_bounds__(AM_CPB / 8 * AM_RG)
    row_absmax_kernel(const TIn* __restrict__ x, float* __restrict__ out, int n, int C) {
  namespace cg = cooperative_groups;
  __shared__ float red[AM_RG][AM_CPB];
  __shared__ float part[AM_CPB];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % (AM_CPB / 8), rg = threadIdx.x / (AM_CPB / 8);
  const int rank = (int)cluster.block_rank(), b = blockIdx.z;
  const int c = blockIdx.x * AM_CPB + lane * 8;
  const int rows = (n + AM_CL - 1) / AM_CL;
  const int r1 = min(n, (rank + 1) * rows);
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0.f;
  if (c < C) {
    const TIn* xb = x + (size_t)b * n * C + c;
    int r = rank * rows + rg;
    for (; r + (AM_UNROLL - 1) * AM_RG < r1; r += AM_UNROLL * AM_RG) {
      float v[AM_UNROLL][8];
#pragma unroll
      for (int u = 0; u < AM_UNROLL; ++u) load8f<TIn>(xb + (size_t)(r + u * AM_RG) * C, v[u]);
#pragma unroll
      for (int u = 0; u < AM_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) m[i] = nan_max(m[i], fabsf(v[u][i]));
    }
    for (; r < r1; r += AM_RG) {
      float v[8];
      load8f<TIn>(xb + (size_t)r * C, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = nan_max(m[i], fabsf(v[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[rg][lane * 8 + i] = m[i];
  __syncthreads();
  if (threadIdx.x < AM_CPB) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int g = 1; g < AM_RG; ++g) t = nan_max(t, red[g][threadIdx.x]);
    part[threadIdx.x] = t;
  }
  cluster.sync();  // every block's partial is in its shared memory
  constexpr int PER = AM_CPB / AM_CL;  // channels each block reduces across the cluster
  if (threadIdx.x < PER) {
    const int cc = rank * PER + threadIdx.x, ch = blockIdx.x * AM_CPB + cc;
    float t = 0.f;
    for (int q = 0; q < AM_CL; ++q) t = nan_max(t, cluster.map_shared_rank(&part[0], q)[cc]);
    if (ch < C) out[(size_t)b * C + ch] = t;
  }
  cluster.sync();  // no block leaves while another still reads its partial
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

// x: (B, n, C), bf16 when is_bf16 else f32; C % 8 == 0, 16-byte aligned,
// n >= 1. out: (B, C) f32.
int us_row_absmax(const void* x, int is_bf16, float* out, int B, int n, int C, void* stream) {
  if (C % 8 != 0 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(us_ceil_div(C, AM_CPB), AM_CL, B);
  const int threads = AM_CPB / 8 * AM_RG;
  if (is_bf16)
    row_absmax_kernel<bf16><<<grid, threads, 0, st>>>(static_cast<const bf16*>(x), out, n, C);
  else
    row_absmax_kernel<float><<<grid, threads, 0, st>>>(static_cast<const float*>(x), out, n, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
