// Anti-aliased snake activation, alone (kernel K6) and fused with the
// following dilated conv1d + bias (+ residual) (kernel K5).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_kernels.py:
// fused_aa_snake (_fused_aa_snake, body _aa_snake_kernel) and
// fused_aa_snake_conv (_fused_aa_snake_conv, bodies _aa_snake_conv_kernel*),
// both over the core _aa_core. Per channel, with a = alpha, ib = 1/(beta+1e-9):
//   y2[m]  = sum_k f_{m%2}[k] x[m/2 + off_{m%2} + k]     2x polyphase upsample
//   z[m]   = y2[m] + ib sin^2(a y2[m])                    snake / snakebeta
//   y[t]   = sum_i g[i] z[2t - 5 + i]                     2x downsample
//   out[t] = bias + sum_j W[j]^T y[t + (j - (k-1)/2) d] (+ residual)    (K5)
// with the edges of the plain path (ops/aa_snake.py, the XLA twin): x is
// replicate-padded before the upsample and z before the downsample (here
// every index is clamped to the signal), and the conv reads zeros outside
// [0, T). The Pallas kernel's extended-LTI edges are not copied.
//
// What bounds it on the H100. The AA part is 24 FMAs and two sines per input
// sample and channel, on the CUDA cores; the conv is 2 k C^2 flops per
// sample (about 0.2 TFLOP per 344-frame vocoder call over its 72 K5
// launches), on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). Bytes are few by comparison: one read of x (and of the
// residual) and one write per launch, where the plain path makes about six
// passes at the 2x rate.
//
// Design. Layout (B, C, T), the port's vocoder layout, so no transposes. A
// K5 block owns 64 output samples x NO (32 or 64) output channels and walks
// the input channels in chunks of 32 (the GEMM's K loop): load the x window
// (clamped, which is the replicate pad), compute z for the chunk in f32 in
// shared memory, downsample into a bf16 A tile over the 64 samples plus the
// conv's reach on each side, then k taps x two k16 steps of mma against the
// chunk's weights. Splitting the output channels over blocks recomputes the
// AA once per slice; it gives the small stage-0 grid (T = 2752) enough
// blocks for 132 SMs. All filter and snake math is f32; the AA output is
// rounded to bf16 once, as the tensor-core operand, and the output once,
// after the f32 bias and residual add. K6 is the AA part alone, 256 samples
// x 8 channels per block, stored directly.
#include "common.cuh"

namespace {

constexpr int NU = 6;        // taps per upsample phase
constexpr int ND = 12;       // downsample taps
constexpr int UP_OFF0 = -3;  // y2[2u]   reads x[u - 3 .. u + 2]
constexpr int UP_OFF1 = -2;  // y2[2u+1] reads x[u - 2 .. u + 3]
constexpr int DN_OFF = -5;   // y[t]     reads z[2t - 5 .. 2t + 6]
constexpr int N_TAPS = 2 * NU + ND;
constexpr int TAP_PAD = 32;  // floats reserved for the taps in shared memory

// For AA output rows [r_lo, r_lo + rows): the x window starts at r_lo - 6,
// the z window at 2 r_lo - 5.
__host__ __device__ constexpr int x_width(int rows) { return rows + 12; }
__host__ __device__ constexpr int z_width(int rows) { return 2 * rows + 10; }

// xs[c][i] = x[c][clamp(r_lo - 6 + i)] for c < nch; xb is channel 0 of the
// chunk, rows of length T.
US_DEV void load_x(const bf16* xb, int T, int nch, int r_lo, int rows, float* xs) {
  const int xw = x_width(rows);
  for (int idx = threadIdx.x; idx < nch * xw; idx += blockDim.x) {
    const int c = idx / xw, i = idx - c * xw;
    const int t = min(max(r_lo - 6 + i, 0), T - 1);
    xs[idx] = __bfloat162float(xb[(size_t)c * T + t]);
  }
}

// zs[c][j] = snake(y2[clamp(2 r_lo - 5 + j, 0, 2T - 1)]); a, ib point at the
// chunk's first channel.
US_DEV void fill_z(const float* xs, const float* tp, const float* a, const float* ib, int T,
                   int nch, int r_lo, int rows, float* zs) {
  const int xw = x_width(rows), zw = z_width(rows), xlo = r_lo - 6;
  for (int idx = threadIdx.x; idx < nch * zw; idx += blockDim.x) {
    const int c = idx / zw, j = idx - c * zw;
    const int m = min(max(2 * r_lo + DN_OFF + j, 0), 2 * T - 1);
    const int p = m & 1;
    const float* f = tp + p * NU;
    const float* xr = xs + c * xw + (m >> 1) + (p ? UP_OFF1 : UP_OFF0) - xlo;
    float y = 0.f;
#pragma unroll
    for (int k = 0; k < NU; ++k) y = fmaf(f[k], xr[k], y);
    const float s = sinf(y * a[c]);
    zs[idx] = y + ib[c] * (s * s);
  }
}

// y[t] from zr = zs[c] + 2 (t - r_lo)
US_DEV float down(const float* zr, const float* g) {
  float y = 0.f;
#pragma unroll
  for (int i = 0; i < ND; ++i) y = fmaf(g[i], zr[i], y);
  return y;
}

constexpr int K6_TT = 256, K6_KC = 8, K6_THREADS = 256;

__host__ __device__ constexpr int k6_smem_bytes() {
  return (TAP_PAD + K6_KC * (x_width(K6_TT) + z_width(K6_TT))) * 4;
}

__global__ void __launch_bounds__(K6_THREADS)
    aa_snake_kernel(const bf16* x, const float* alpha, const float* ib, const float* taps,
                    bf16* out, int C, int T) {
  extern __shared__ float sm[];
  float* tp = sm;
  float* xs = sm + TAP_PAD;
  float* zs = xs + K6_KC * x_width(K6_TT);
  const int t0 = blockIdx.x * K6_TT, c0 = blockIdx.y * K6_KC, b = blockIdx.z;
  const int nch = min(K6_KC, C - c0);
  const size_t base = ((size_t)b * C + c0) * T;
  if (threadIdx.x < N_TAPS) tp[threadIdx.x] = taps[threadIdx.x];
  load_x(x + base, T, nch, t0, K6_TT, xs);
  __syncthreads();
  fill_z(xs, tp, alpha + c0, ib + c0, T, nch, t0, K6_TT, zs);
  __syncthreads();
  const int zw = z_width(K6_TT);
  for (int idx = threadIdx.x; idx < nch * K6_TT; idx += K6_THREADS) {
    const int c = idx / K6_TT, r = idx - c * K6_TT, t = t0 + r;
    if (t < T) out[base + (size_t)c * T + t] = __float2bfloat16(down(zs + c * zw + 2 * r, tp + 2 * NU));
  }
}

constexpr int K5_TT = 64, K5_KC = 32, K5_THREADS = 128;  // 4 warps x 16 output rows
constexpr int LDA = K5_KC + 8;                             // bf16 A tile row, padded
constexpr int LDO = K5_TT + 4;                             // f32 output tile row

__host__ __device__ constexpr int ldb(int no) { return no + 8; }

__host__ __device__ constexpr int k5_smem_bytes(int no, int ksize, int dil) {
  return (ksize * K5_KC * ldb(no) + (K5_TT + (ksize - 1) * dil) * LDA) * 2 +
         (TAP_PAD + K5_KC * (x_width(K5_TT + (ksize - 1) * dil) +
                             z_width(K5_TT + (ksize - 1) * dil))) * 4;
}

template <int NO>
__global__ void __launch_bounds__(K5_THREADS)
    aa_snake_conv_kernel(const bf16* x, const float* alpha, const float* ib, const float* taps,
                         const bf16* w, const float* bias, const bf16* res, bf16* out, int C,
                         int T, int ksize, int dil) {
  constexpr int NT = NO / 8, LDB = ldb(NO), V = NO / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int R = (ksize - 1) / 2 * dil, rows = K5_TT + 2 * R;
  const int zw = z_width(rows);
  bf16* Ws = reinterpret_cast<bf16*>(smraw);  // [ksize * KC][LDB]
  bf16* As = Ws + ksize * K5_KC * LDB;        // [rows][LDA]
  float* tp = reinterpret_cast<float*>(As + rows * LDA);
  float* xs = tp + TAP_PAD;                   // [KC][x_width(rows)]
  float* zs = xs + K5_KC * x_width(rows);     // [KC][zw]; the output tile at the end
  const int t0 = blockIdx.x * K5_TT, n0 = blockIdx.y * NO, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_lo = t0 - R;
  if (threadIdx.x < N_TAPS) tp[threadIdx.x] = taps[threadIdx.x];
  float acc[1][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  const bf16* xb = x + (size_t)b * C * T;
  for (int c0 = 0; c0 < C; c0 += K5_KC) {
    // Ws[j * KC + kc][n] = w[j][c0 + kc][n0 + n], 16-byte vectors
    for (int idx = threadIdx.x; idx < ksize * K5_KC * V; idx += K5_THREADS) {
      const int row = idx / V, v = idx - row * V;
      const int j = row / K5_KC, kc = row - j * K5_KC;
      *reinterpret_cast<uint4*>(Ws + row * LDB + v * 8) =
          *reinterpret_cast<const uint4*>(w + (size_t)(j * C + c0 + kc) * C + n0 + v * 8);
    }
    load_x(xb + (size_t)c0 * T, T, K5_KC, r_lo, rows, xs);
    __syncthreads();
    fill_z(xs, tp, alpha + c0, ib + c0, T, K5_KC, r_lo, rows, zs);
    __syncthreads();
    for (int idx = threadIdx.x; idx < K5_KC * rows; idx += K5_THREADS) {
      const int c = idx / rows, r = idx - c * rows, t = r_lo + r;
      const float v = (t >= 0 && t < T) ? down(zs + c * zw + 2 * r, tp + 2 * NU) : 0.f;
      As[r * LDA + c] = __float2bfloat16(v);
    }
    __syncthreads();
    // output row o reads A row o + j * dil for tap j
    for (int j = 0; j < ksize; ++j) {
#pragma unroll
      for (int kk = 0; kk < K5_KC; kk += 16)
        warp_mma_k16<1, NT>(acc, As + (warp * 16 + j * dil) * LDA + kk, LDA,
                            Ws + (j * K5_KC + kk) * LDB, LDB, lane);
    }
    __syncthreads();
  }
  float* Os = zs;  // [NO][LDO]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
      const int col = j * 8 + (lane & 3) * 2 + (e & 1);
      Os[col * LDO + row] = acc[0][j][e];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NO * K5_TT; idx += K5_THREADS) {
    const int n = idx / K5_TT, o = idx - n * K5_TT, t = t0 + o;
    if (t >= T) continue;
    const size_t off = ((size_t)b * C + n0 + n) * T + t;
    float v = Os[n * LDO + o] + bias[n0 + n];
    if (res != nullptr) v += __bfloat162float(res[off]);
    out[off] = __float2bfloat16(v);
  }
}

template <int NO>
int launch_conv(const bf16* x, const float* alpha, const float* ib, const float* taps,
                const bf16* w, const float* bias, const bf16* res, bf16* out, int B, int C, int T,
                int ksize, int dil, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    int err = (int)cudaFuncSetAttribute(aa_snake_conv_kernel<NO>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != 0) return err;
    configured = true;
  }
  dim3 grid(us_ceil_div(T, K5_TT), C / NO, B);
  aa_snake_conv_kernel<NO><<<grid, K5_THREADS, k5_smem_bytes(NO, ksize, dil), st>>>(
      x, alpha, ib, taps, w, bias, res, out, C, T, ksize, dil);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The offsets the kernels are written for; ops/aa_snake.py checks them
// against the filters it derives.
int us_aa_offsets(int which) { return which == 0 ? UP_OFF0 : which == 1 ? UP_OFF1 : DN_OFF; }

// x, out: (B, C, T) bf16; alpha, ib: (C,) f32 snake coefficients (alpha
// already exponentiated where log-scale); taps: (24,) f32 = f0 | f1 | g.
int us_aa_snake(const void* x, const float* alpha, const float* ib, const float* taps, void* out,
                int B, int C, int T, void* stream) {
  dim3 grid(us_ceil_div(T, K6_TT), us_ceil_div(C, K6_KC), B);
  aa_snake_kernel<<<grid, K6_THREADS, k6_smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), alpha, ib, taps, static_cast<bf16*>(out), C, T);
  return (int)cudaGetLastError();
}

// As us_aa_snake, then the conv: w (ksize, C, C) bf16 flax layout (tap, in,
// out), bias (C,) f32, res (B, C, T) bf16 or NULL. C % 32 == 0; odd ksize.
int us_aa_snake_conv(const void* x, const float* alpha, const float* ib, const float* taps,
                     const void* w, const float* bias, const void* res, void* out, int B, int C,
                     int T, int ksize, int dil, void* stream) {
  if (C % K5_KC != 0 || ksize % 2 == 0 || dil < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const bf16*>(w);
  auto rb = static_cast<const bf16*>(res);
  auto ob = static_cast<bf16*>(out);
  if (C % 64 == 0)
    return launch_conv<64>(xb, alpha, ib, taps, wb, bias, rb, ob, B, C, T, ksize, dil, st);
  return launch_conv<32>(xb, alpha, ib, taps, wb, bias, rb, ob, B, C, T, ksize, dil, st);
}

}  // extern "C"
