// Per-channel row reductions: statistics (kernel K3) and abs-max (K7).
//
// K3 replaces the Pallas kernel in unitspeech_tpu/ops/pallas_stats.py:
// row_stats (_row_stats_pallas, body _stats_kernel): x (B, n, C) -> (B, 2,
// C) f32 with [:, 0] the sum over rows and [:, 1] the sum of squares, and
// the group fold that follows it there (group_mean_inv, pallas_stats.py:129;
// the fused final block folds the same way inside its kernel, _kernel_d):
// per-channel f32 mean and inverse std of each GroupNorm group, over every
// row, padding included. These feed the GroupNorm of the deep U-Net blocks
// (F = 20, 10).
//
// What bounds it on the H100: bytes. One pass reads the activation once
// (1.3-10.6 MB per call at the main-path shapes: 0.4-3.2 us at 3.35 TB/s);
// the work per element is two f32 operations. So a call is latency: one
// launch, and the fold in the same launch (it was a chain of small PyTorch
// launches after the kernel). K7's design: a cluster of RS_CL blocks owns
// RS_CPB channels of one batch element and splits its rows into RS_CL
// slices; a block's 256 threads are 16 channel lanes (8 channels, one
// 16-byte load or two float4 a row) x 16 row groups, RS_UNROLL loads in
// flight a thread, sums in f32. Each block sums its row groups in shared
// memory in order; the cluster then sums the RS_CL partials through
// distributed shared memory in rank order: no scratch, no second launch,
// deterministic. The sums form writes each rank's 16 channels of (B, 2, C);
// the fold form has every block sum all RS_CPB channels of the cluster (the
// same values, the same order), then each group's cg channels by a
// butterfly of shuffles over runs of up to 32 channels and the runs in
// order, and write mean = s / m, inv = rsqrt(ss / m - mean^2 + eps), m = n
// * cg, for its 16 channels. A group must lie in one cluster: the fold form takes cg
// dividing RS_CPB (cg = 32-128 at the served widths, 4-16 at decoder.dim 32
// and 64); ops/row_stats.py runs the sums form and the fold in PyTorch for
// other cg. Widths: any even C (C % 8 != 0 reads channel pairs) and n >= 1,
// ranks with no rows adding zeros.
//
// K7 replaces the Pallas kernel in unitspeech_tpu/ops/pallas_stats.py:
// row_absmax (_row_absmax_pallas, body _absmax_kernel): x (B, n, C) -> (B, C)
// f32 max |x| over rows, whose overall max sets the per-tensor int8 scale of
// the deep-stage convs (ops/conv_matmul.py conv3x3_int8). Also bytes-bound
// (one compare per element), and laid out as K3: a cluster of AM_CL blocks
// owns 128 channels of one batch element, the same lanes and row groups,
// eight loads in flight a thread; the cluster reduces the AM_CL partial
// maxima, each block for 128 / AM_CL of the channels, in a fixed order. A
// max does not depend on the order, so the result equals the plain version
// bit for bit; a NaN propagates as torch.amax propagates it. The TPU
// kernel's VMEM gate (pallas_stats.supported) has no counterpart: any C % 8
// == 0 and n >= 1 is taken.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

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
US_DEV float2 load2(const TIn* p);

template <>
US_DEV float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <>
US_DEV float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Channels c .. c + 7 of one row as f32: VEC (C % 8 == 0) in one 16-byte
// load (two float4 for f32), else in channel pairs, those at/after C (`left`
// channels remain from c, an even count) read as 0.
template <typename TIn, bool VEC>
US_DEV void load_row8(const TIn* p, int left, float (&v)[8]) {
  if constexpr (VEC) {
    load8f<TIn>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const float2 f = e < left ? load2<TIn>(p + e) : make_float2(0.f, 0.f);
      v[e] = f.x, v[e + 1] = f.y;
    }
  }
}

constexpr int RS_CL = 8;                      // blocks of a cluster: the row slices
constexpr int RS_CPB = 128;                   // channels of a cluster (and of each block)
constexpr int RS_LANES = RS_CPB / 8;          // channel lanes a block, 8 channels each
constexpr int RS_RG = 16;                     // row groups a block
constexpr int RS_UNROLL = 8;                  // loads in flight a thread
constexpr int RS_THREADS = RS_LANES * RS_RG;  // 256 = 2 x RS_CPB
constexpr int RS_PER = RS_CPB / RS_CL;        // channels each rank writes

// Block (channel slice, rank, batch element); the cluster spans the ranks.
// Rank q reads rows [q rows, (q + 1) rows), rows = ceil(n / RS_CL); its row
// group g every RS_RG-th row from q rows + g, RS_UNROLL rows at a time while
// that many remain, then one (loads of a ragged last round in flight together
// measured slower). FOLD: write mean / inv (B, C) of groups of cg
// channels; else stats (B, 2, C).
template <typename TIn, bool VEC, bool FOLD>
__global__ void __cluster_dims__(1, RS_CL, 1) __launch_bounds__(RS_THREADS)
    row_stats_kernel(const TIn* __restrict__ x, int n, int C, float* __restrict__ stats,
                     float* __restrict__ mean, float* __restrict__ inv, int cg, float eps) {
  namespace cgp = cooperative_groups;
  __shared__ float red[2][RS_RG][RS_CPB];
  __shared__ float part[2][RS_CPB];
  __shared__ float gsum[2][RS_CPB];  // FOLD: each channel's group sums
  __shared__ float wsum[RS_THREADS / 32];  // FOLD: a warp's run sum
  cgp::cluster_group cluster = cgp::this_cluster();
  const int tid = threadIdx.x, lane = tid % RS_LANES, rg = tid / RS_LANES;
  const int rank = (int)cluster.block_rank(), b = blockIdx.z;
  const int c0 = blockIdx.x * RS_CPB, c = c0 + lane * 8;
  const int rows = (n + RS_CL - 1) / RS_CL;
  const int r1 = min(n, (rank + 1) * rows);
  float s[8], q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;
  if (c < C) {
    const TIn* xb = x + (size_t)b * n * C + c;
    const int left = C - c;
    int r = rank * rows + rg;
    for (; r + (RS_UNROLL - 1) * RS_RG < r1; r += RS_UNROLL * RS_RG) {
      float v[RS_UNROLL][8];
#pragma unroll
      for (int u = 0; u < RS_UNROLL; ++u)
        load_row8<TIn, VEC>(xb + (size_t)(r + u * RS_RG) * C, left, v[u]);
#pragma unroll
      for (int u = 0; u < RS_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] += v[u][i], q[i] = fmaf(v[u][i], v[u][i], q[i]);
    }
    for (; r < r1; r += RS_RG) {
      float v[8];
      load_row8<TIn, VEC>(xb + (size_t)r * C, left, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += v[i], q[i] = fmaf(v[i], v[i], q[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) red[0][rg][lane * 8 + i] = s[i], red[1][rg][lane * 8 + i] = q[i];
  __syncthreads();
  const int k = tid / RS_CPB, cc = tid % RS_CPB;  // 256 threads: (sum or squares, channel)
  {
    float t = red[k][0][cc];
#pragma unroll
    for (int g = 1; g < RS_RG; ++g) t += red[k][g][cc];
    part[k][cc] = t;
  }
  cluster.sync();  // every block's partial is in its shared memory
  if (!FOLD) {
    if (tid < 2 * RS_PER) {
      const int kk = tid / RS_PER, ch = rank * RS_PER + tid % RS_PER;
      float t = 0.f;
      for (int r = 0; r < RS_CL; ++r)
        t += cluster.map_shared_rank(&part[0][0], r)[kk * RS_CPB + ch];
      if (c0 + ch < C) stats[((size_t)b * 2 + kk) * C + c0 + ch] = t;
    }
  } else {
    float t = 0.f;
    for (int r = 0; r < RS_CL; ++r)
      t += cluster.map_shared_rank(&part[0][0], r)[k * RS_CPB + cc];
    // the group sums: a warp holds 32 consecutive channels of one of the
    // two sums; a butterfly of shuffles sums each aligned run of min(cg,
    // 32) lanes (every lane of the run gets the same bits), then a group of
    // cg > 32 channels sums its cg / 32 warps' runs in order
    const int run = min(cg, 32);
    for (int off = 1; off < run; off <<= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (cg > 32) {
      if (tid % 32 == 0) wsum[tid / 32] = t;
      __syncthreads();
      const int w0 = (tid / cg) * (cg / 32);  // the group's first warp
      t = wsum[w0];
      for (int w = 1; w < cg / 32; ++w) t += wsum[w0 + w];
    }
    gsum[k][cc] = t;
    __syncthreads();
    const int ch = rank * RS_PER + tid, width = min(RS_CPB, C - c0);
    if (tid < RS_PER && ch < width) {
      const float m = (float)((long long)n * cg);
      const float mu = gsum[0][ch] / m;
      mean[(size_t)b * C + c0 + ch] = mu;
      inv[(size_t)b * C + c0 + ch] = rsqrtf(gsum[1][ch] / m - mu * mu + eps);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <typename TIn, bool FOLD>
int row_stats_launch(const TIn* x, float* stats, float* mean, float* inv, int B, int n, int C,
                     int cg, float eps, cudaStream_t st) {
  dim3 grid(us_ceil_div(C, RS_CPB), RS_CL, B);
  if (C % 8 == 0)
    row_stats_kernel<TIn, true, FOLD><<<grid, RS_THREADS, 0, st>>>(x, n, C, stats, mean, inv,
                                                                   cg, eps);
  else
    row_stats_kernel<TIn, false, FOLD><<<grid, RS_THREADS, 0, st>>>(x, n, C, stats, mean, inv,
                                                                    cg, eps);
  return (int)cudaGetLastError();
}

template <bool FOLD>
int row_stats_any(const void* x, int is_bf16, float* stats, float* mean, float* inv, int B,
                  int n, int C, int cg, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return row_stats_launch<bf16, FOLD>(static_cast<const bf16*>(x), stats, mean, inv, B, n, C,
                                        cg, eps, st);
  return row_stats_launch<float, FOLD>(static_cast<const float*>(x), stats, mean, inv, B, n, C,
                                       cg, eps, st);
}

constexpr int AM_CL = 8;     // blocks of a cluster: the row slices of 128 channels
constexpr int AM_CPB = 128;  // channels a block: 16 lanes x 8
constexpr int AM_RG = 16;    // row groups a block
constexpr int AM_UNROLL = 8; // loads in flight a thread

US_DEV float nan_max(float m, float v) { return (v > m || v != v) ? v : m; }

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

// K3, the sums form. x: (B, n, C), bf16 when is_bf16 else f32, 16-byte
// aligned; C even, n >= 1. out: (B, 2, C) f32.
int us_row_stats(const void* x, int is_bf16, float* out, int B, int n, int C, void* stream) {
  if (C % 2 || n < 1) return (int)cudaErrorInvalidValue;
  return row_stats_any<false>(x, is_bf16, out, nullptr, nullptr, B, n, C, 1, 0.f, stream);
}

// K3, the fold form: x as us_row_stats; mean, inv: (B, C) f32, each
// channel its group's (groups of C / groups channels, which must divide the
// cluster's RS_CPB).
int us_group_mean_inv(const void* x, int is_bf16, float* mean, float* inv, int B, int n, int C,
                      int groups, float eps, void* stream) {
  if (C % 2 || n < 1 || groups < 1 || C % groups || RS_CPB % (C / groups))
    return (int)cudaErrorInvalidValue;
  return row_stats_any<true>(x, is_bf16, nullptr, mean, inv, B, n, C, C / groups, eps, stream);
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
