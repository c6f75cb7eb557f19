// U-Net ResnetBlock and final block (kernels K1 and K2).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block (_fused_resnet: _kernel_a, _kernel_b, _kernel_c) and
// fused_final_block (_fused_final: _kernel_a, _kernel_d).
//
// Layout: rows n = t*F + f of one batch element, channels last, bf16.
// conv3x3 is an implicit GEMM: M = rows, N = Cout, K = 9*Cin with the
// weight read as w.reshape(9*Cin, Cout) (tap order (dt, df) row-major). A
// +-1 shift that leaves the (T, F) grid reads zero, so no tap wraps into the
// neighbouring frame.
//
// What bounds it on the H100: at the F=80/40 stages each conv is
// 12-24 GFLOP per estimator call against 7-21 MB of activations, so the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) carry the
// products and everything around them (bias, GroupNorm statistics,
// GN-apply + mish + FiLM + mask of the next conv's input, the residual) is
// fused into the GEMM's loaders and epilogues: the block reads its input
// once, writes c1 and c2 once each, and re-reads them once.
//
// No state is carried across blocks: every 128-row tile writes its column
// sum and sum of squares to a scratch buffer, and gn_finalize reduces the
// tiles in a fixed order, so the statistics are deterministic. Statistics
// pool over every row of the padded bucket, padding rows included
// (torch GroupNorm semantics, pallas_resnet.py:28-32).
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int AST = BK + 8;  // padded smem row strides: ldmatrix without
constexpr int BST = BN + 8;  // bank conflicts
constexpr int NTHREADS = 256;
constexpr int MAXC = 512;  // widest input a transformed (kernel B) load takes

struct ConvArgs {
  const bf16* x;       // (B, N, Cin)
  const bf16* w;       // (taps*Cin, Cout)
  const float* bias;   // (Cout)
  const int* lens;     // (B) valid rows; input rows at/after it read zero
  // kernel B input transform: h = mish(GN(x) * scale + shift) + film
  const float* in_mean;   // (B, Cin)
  const float* in_inv;    // (B, Cin)
  const float* in_scale;  // (Cin)
  const float* in_shift;  // (Cin)
  const bf16* film;       // (B, Cin)
  // kernel C epilogue: out = mish(GN(c2))*valid + (acc + bias)*valid
  const bf16* c2;         // (B, N, Cout)
  const float* o_mean;    // (B, Cout)
  const float* o_inv;
  const float* o_scale;   // (Cout)
  const float* o_shift;
  bf16* out;    // (B, N, Cout)
  float* part;  // (B, n_mtiles, 2, Cout)
  int N, F, Cin, Cout;
};

template <int TAPS>
__device__ __forceinline__ int source_row(int m, int tap, int T, int F) {
  if (TAPS == 1) return m;
  int dt = tap / 3 - 1, df = tap % 3 - 1;
  int t = m / F, f = m - t * F;
  int tt = t + dt, ff = f + df;
  if (tt < 0 || tt >= T || ff < 0 || ff >= F) return -1;
  return tt * F + ff;
}

// TAPS: 9 (conv3x3) or 1 (1x1 residual). XFORM: GN-apply the input on load
// (kernel B). EPI: 0 writes bias-added output + tile statistics (kernels A,
// B); 1 writes the ResnetBlock output with the 1x1 residual (kernel C).
// VEC: Cin % 8 == 0, 16-byte loads; otherwise element loads (Cin = 2).
template <int TAPS, bool XFORM, int EPI, bool VEC>
__global__ void __launch_bounds__(NTHREADS) conv_gemm(ConvArgs p) {
  __shared__ __align__(16) bf16 As[2][BM * AST];
  __shared__ __align__(16) bf16 Bs[2][BK * BST];
  __shared__ float xf[XFORM ? 5 * MAXC : 1];
  __shared__ float red[4][2][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int mt = blockIdx.x, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int m0 = mt * BM;
  const int N = p.N, F = p.F, Cin = p.Cin, Cout = p.Cout;
  const int T = N / F;
  const int len = p.lens[b];
  const int K = TAPS * Cin;
  const int nk = (K + BK - 1) / BK;
  const bf16* xb = p.x + (size_t)b * N * Cin;

  if (XFORM) {
    for (int c = tid; c < Cin; c += NTHREADS) {
      xf[c] = p.in_mean[b * Cin + c];
      xf[MAXC + c] = p.in_inv[b * Cin + c];
      xf[2 * MAXC + c] = p.in_scale[c];
      xf[3 * MAXC + c] = p.in_shift[c];
      xf[4 * MAXC + c] = __bfloat162float(p.film[b * Cin + c]);
    }
    __syncthreads();
  }

  // kernel B's conv input, one element: the JAX kernel rounds it to bf16
  // after GN-apply, mish, FiLM and the (already applied) row mask
  auto xform = [&](float v, int ci) -> float {
    float h = (v - xf[ci]) * xf[MAXC + ci];
    h = h * xf[2 * MAXC + ci] + xf[3 * MAXC + ci];
    return mish_f32(h) + xf[4 * MAXC + ci];
  };

  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * NTHREADS;
      int m = m0 + (v >> 2);
      int k = kb * BK + (v & 3) * 8;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= N) continue;
      if (VEC) {
        if (k >= K) continue;
        int tap = k / Cin, ci = k - tap * Cin;
        int src = source_row<TAPS>(m, tap, T, F);
        if (src < 0 || src >= len) continue;
        const bf16* ptr = xb + (size_t)src * Cin + ci;
        if (XFORM) {
          float vals[8];
          load8(ptr, vals);
#pragma unroll
          for (int e = 0; e < 8; ++e) vals[e] = xform(vals[e], ci + e);
          store8(reinterpret_cast<bf16*>(&reg[s]), vals);
        } else {
          reg[s] = *reinterpret_cast<const uint4*>(ptr);
        }
      } else {
        bf16* r = reinterpret_cast<bf16*>(&reg[s]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int ke = k + e;
          if (ke >= K) break;
          int tap = ke / Cin, ci = ke - tap * Cin;
          int src = source_row<TAPS>(m, tap, T, F);
          if (src < 0 || src >= len) continue;
          bf16 val = xb[(size_t)src * Cin + ci];
          if (XFORM) val = __float2bfloat16(xform(__bfloat162float(val), ci));
          r[e] = val;
        }
      }
    }
  };

  auto load_b = [&](int kb) -> uint4 {
    int k = kb * BK + (tid >> 3);
    if (k >= K) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(p.w + (size_t)k * Cout + n0 + (tid & 7) * 8);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 areg[2];
  uint4 breg;
  load_a(0, areg);
  breg = load_b(0);
  for (int kb = 0; kb < nk; ++kb) {
    const int buf = kb & 1;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * NTHREADS;
      *reinterpret_cast<uint4*>(&As[buf][(v >> 2) * AST + (v & 3) * 8]) = areg[s];
    }
    *reinterpret_cast<uint4*>(&Bs[buf][(tid >> 3) * BST + (tid & 7) * 8]) = breg;
    __syncthreads();
    if (kb + 1 < nk) {  // next tile's global loads overlap this tile's math
      load_a(kb + 1, areg);
      breg = load_b(kb + 1);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      warp_mma_k16<2, 4>(acc, &As[buf][(wm * 32) * AST + kk * 16], AST,
                         &Bs[buf][(kk * 16) * BST + wn * 32], BST, lane);
  }

  if (EPI == 0) {
    float cs[4][2], css[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[j][0] = cs[j][1] = css[j][0] = css[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = m0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
          int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
          if (m >= N) continue;
          float v0 = acc[i][j][2 * h] + p.bias[n];
          float v1 = acc[i][j][2 * h + 1] + p.bias[n + 1];
          *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)b * N + m) * Cout + n) =
              __floats2bfloat162_rn(v0, v1);
          cs[j][0] += v0;
          cs[j][1] += v1;
          css[j][0] += v0 * v0;
          css[j][1] += v1 * v1;
        }
    // sum the warp's 32 rows: lanes sharing lane%4 hold the same columns
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[j][h] += __shfl_xor_sync(0xffffffffu, cs[j][h], off);
          css[j][h] += __shfl_xor_sync(0xffffffffu, css[j][h], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int c = wn * 32 + j * 8 + lane * 2 + h;
          red[wm][0][c] = cs[j][h];
          red[wm][1][c] = css[j][h];
        }
    }
    __syncthreads();
    if (tid < 2 * BN) {
      int st = tid / BN, c = tid % BN;
      float s = red[0][st][c] + red[1][st][c] + red[2][st][c] + red[3][st][c];
      p.part[(((size_t)b * gridDim.x + mt) * 2 + st) * Cout + n0 + c] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int m = m0 + wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
          int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (m >= N) continue;
          float valid = m < len ? 1.f : 0.f;
          size_t o = ((size_t)b * N + m) * Cout + n;
          float h = (__bfloat162float(p.c2[o]) - p.o_mean[b * Cout + n]) * p.o_inv[b * Cout + n];
          h = mish_f32(h * p.o_scale[n] + p.o_shift[n]) * valid;
          float r = (acc[i][j][e] + p.bias[n]) * valid;
          p.out[o] = __float2bfloat16(h + r);
        }
  }
}

// Reduce the per-tile column statistics of one (batch, group) in a fixed
// order and write the per-channel GroupNorm mean and inverse std.
__global__ void __launch_bounds__(256) gn_finalize(const float* part, int n_tiles, int C,
                                                   int groups, int n_rows, float eps,
                                                   float* mean, float* inv) {
  __shared__ float scratch[256];
  const int g = blockIdx.x, b = blockIdx.y, cg = C / groups;
  float s = 0.f, ss = 0.f;
  for (int idx = threadIdx.x; idx < n_tiles * cg; idx += blockDim.x) {
    int j = idx / cg, c = g * cg + idx % cg;
    const float* pt = part + ((size_t)b * n_tiles + j) * 2 * C;
    s += pt[c];
    ss += pt[C + c];
  }
  s = block_sum(s, scratch);
  ss = block_sum(ss, scratch);
  float m = (float)n_rows * (float)cg;
  float mu = s / m;
  float iv = 1.0f / sqrtf(ss / m - mu * mu + eps);
  for (int c = threadIdx.x; c < cg; c += blockDim.x) {
    mean[b * C + g * cg + c] = mu;
    inv[b * C + g * cg + c] = iv;
  }
}

// Kernel C with the identity residual: mish(GN(c2))*valid + x*valid.
__global__ void __launch_bounds__(256) resnet_out_identity(
    const bf16* c2, const bf16* x, const float* mean, const float* inv,
    const float* scale, const float* shift, const int* lens, bf16* out, int B,
    int N, int C) {
  size_t nvec = (size_t)B * N * C / 8;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    size_t e0 = v * 8;
    int c0 = (int)(e0 % C);
    size_t row = e0 / C;
    int b = (int)(row / N), m = (int)(row % N);
    float valid = m < lens[b] ? 1.f : 0.f;
    float cv[8], xv[8], o[8];
    load8(c2 + e0, cv);
    load8(x + e0, xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int c = c0 + e;
      float h = (cv[e] - mean[b * C + c]) * inv[b * C + c];
      h = mish_f32(h * scale[c] + shift[c]) * valid;
      o[e] = h + xv[e] * valid;
    }
    store8(out + e0, o);
  }
}

// Kernel D: GN-apply + mish + mask, then the 1-channel 1x1 final_conv, one
// warp per row; f32 score out.
__global__ void __launch_bounds__(256) final_out(const bf16* c1, const float* mean,
                                                 const float* inv, const float* scale,
                                                 const float* shift, const bf16* wo, const float* bo,
                                                 const int* lens, float* out, int B, int N,
                                                 int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= B * N) return;
  const int b = row / N, m = row % N;
  const float valid = m < lens[b] ? 1.f : 0.f;
  const bf16* cr = c1 + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) {
    float h = (__bfloat162float(cr[c]) - mean[b * C + c]) * inv[b * C + c];
    h = mish_f32(h * scale[c] + shift[c]) * valid;
    s += bf16_round(h) * __bfloat162float(wo[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = (s + bo[0]) * valid;
}

ConvArgs base_args(const void* x, const void* w, const float* bias, const int* lens,
                   void* out, int N, int F, int Cin, int Cout) {
  ConvArgs p = {};
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.lens = lens;
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.F = F;
  p.Cin = Cin;
  p.Cout = Cout;
  return p;
}

}  // namespace

extern "C" {

int us_n_row_tiles(int N) { return us_ceil_div(N, BM); }

// conv3x3 + bias -> out (bf16) and per-tile statistics (kernels A and B).
// With in_mean != NULL the input is GN-applied on load (kernel B).
int us_resnet_conv3x3(const void* x, const void* w, const float* bias, const int* lens,
                      const float* in_mean, const float* in_inv, const float* in_scale,
                      const float* in_shift, const void* film, void* out, float* part,
                      int B, int N, int F, int Cin, int Cout, void* stream) {
  ConvArgs p = base_args(x, w, bias, lens, out, N, F, Cin, Cout);
  p.in_mean = in_mean;
  p.in_inv = in_inv;
  p.in_scale = in_scale;
  p.in_shift = in_shift;
  p.film = static_cast<const bf16*>(film);
  p.part = part;
  dim3 grid(us_ceil_div(N, BM), Cout / BN, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_mean != nullptr)
    conv_gemm<9, true, 0, true><<<grid, NTHREADS, 0, st>>>(p);
  else if (Cin % 8 == 0)
    conv_gemm<9, false, 0, true><<<grid, NTHREADS, 0, st>>>(p);
  else
    conv_gemm<9, false, 0, false><<<grid, NTHREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

int us_gn_finalize(const float* part, int B, int n_tiles, int C, int groups, int n_rows,
                   float eps, float* mean, float* inv, void* stream) {
  gn_finalize<<<dim3(groups, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, n_tiles, C, groups, n_rows, eps, mean, inv);
  return (int)cudaGetLastError();
}

// Kernel C: GN2-apply + mish + mask + residual (1x1 conv when wres != NULL).
int us_resnet_out(const void* c2, const void* x, const float* mean, const float* inv,
                  const float* scale, const float* shift, const void* wres,
                  const float* bres, const int* lens, void* out, int B, int N, int Cin,
                  int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wres == nullptr) {
    size_t nvec = (size_t)B * N * Cout / 8;
    int blocks = (int)((nvec + 255) / 256);
    if (blocks > 65535) blocks = 65535;
    resnet_out_identity<<<blocks, 256, 0, st>>>(
        static_cast<const bf16*>(c2), static_cast<const bf16*>(x), mean, inv, scale, shift,
        lens, static_cast<bf16*>(out), B, N, Cout);
    return (int)cudaGetLastError();
  }
  ConvArgs p = base_args(x, wres, bres, lens, out, N, 1, Cin, Cout);
  p.c2 = static_cast<const bf16*>(c2);
  p.o_mean = mean;
  p.o_inv = inv;
  p.o_scale = scale;
  p.o_shift = shift;
  dim3 grid(us_ceil_div(N, BM), Cout / BN, B);
  if (Cin % 8 == 0)
    conv_gemm<1, false, 1, true><<<grid, NTHREADS, 0, st>>>(p);
  else
    conv_gemm<1, false, 1, false><<<grid, NTHREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Kernel D: final block's GN + mish + mask fused with final_conv.
int us_final_out(const void* c1, const float* mean, const float* inv, const float* scale,
                 const float* shift, const void* wo, const float* bo, const int* lens, float* out,
                 int B, int N, int C, void* stream) {
  int rows = B * N;
  final_out<<<us_ceil_div(rows, 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(c1), mean, inv, scale, shift, static_cast<const bf16*>(wo), bo,
      lens, out, B, N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
