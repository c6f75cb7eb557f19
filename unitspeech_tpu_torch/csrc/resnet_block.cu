// U-Net ResnetBlock and final block (kernels K1, K2 and K8).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block (_fused_resnet: _kernel_a, _kernel_b, _kernel_c),
// fused_final_block (_fused_final: _kernel_a, _kernel_d) and
// fused_resnet_block_deep (_fused_resnet_deep: _kernel_a_deep,
// _kernel_b_deep, _kernel_c): us_resnet_block at the deep stages.
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
// K8, the deep stages (F = 20/10, C = 512-2048): the TPU kernel holds the
// whole layer in VMEM, pads rows to 8 and moves conv1 (for cin > cout) and
// the 1x1 residual out of the kernel, all to suit Mosaic. None of that
// carries over. On Hopper the same tiled implicit GEMM serves: the
// activation (< 4 MB) stays in the 50 MB L2 between tiles, the kernel-B
// transform table sits in dynamic shared memory (5 * Cin floats, 20 KB at
// C = 1024), and the numbers are K1's: statistics over exactly the T*F rows
// of the bucket, the residual an f32 sum of bf16 products rounded once with
// the rest. Each deep conv is 12-24 GFLOP (3 rows at the 344-frame bucket)
// against weights of 4.7-19 MB, so the tensor cores bound it; with 430 or
// 1720 rows a batch element the 128 x 64 tiles give 96-336 blocks, about a
// wave or two on 132 SMs (untuned).
//
// No state is carried across blocks: every 128-row tile writes its column
// sum and sum of squares to a scratch buffer, and gn_finalize reduces the
// tiles in a fixed order, so the statistics are deterministic. Statistics
// pool over every row of the padded bucket, padding rows included
// (torch GroupNorm semantics, pallas_resnet.py:28-32).
#include "common.cuh"

namespace {

constexpr int BM = IG_BM, BN = IG_BN, BK = IG_BK;
constexpr int NTHREADS = IG_THREADS;

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
// (kernel B); its per-channel table (mean, inv, scale, shift, film: 5 * Cin
// floats) lives in dynamic shared memory, so Cin is not capped. EPI: 0
// writes bias-added output + tile statistics (kernels A, B); 1 writes the
// ResnetBlock output with the 1x1 residual (kernel C). VEC: Cin % 8 == 0,
// 16-byte loads; otherwise element loads (Cin = 2).
template <int TAPS, bool XFORM, int EPI, bool VEC>
__global__ void __launch_bounds__(NTHREADS) conv_gemm(ConvArgs p) {
  __shared__ IgemmTiles tiles;
  __shared__ float red[4][2][BN];
  extern __shared__ float xf[];

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
      xf[Cin + c] = p.in_inv[b * Cin + c];
      xf[2 * Cin + c] = p.in_scale[c];
      xf[3 * Cin + c] = p.in_shift[c];
      xf[4 * Cin + c] = __bfloat162float(p.film[b * Cin + c]);
    }
    __syncthreads();
  }

  // kernel B's conv input, one element: the JAX kernel rounds it to bf16
  // after GN-apply, mish, FiLM and the (already applied) row mask
  auto xform = [&](float v, int ci) -> float {
    float h = (v - xf[ci]) * xf[Cin + ci];
    h = h * xf[2 * Cin + ci] + xf[3 * Cin + ci];
    return mish_f32(h) + xf[4 * Cin + ci];
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
  igemm_bf16(acc, tiles, nk, load_a, load_b);

  if (EPI == 0) {
    auto value = [&](float a, int n) -> float { return a + p.bias[n]; };
    store_tile_stats(acc, value, p.out, p.part, red, N, Cout, m0, n0, b);
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
  if (in_mean != nullptr) {
    // the transform table: above 48 KB of shared memory in all (Cin > 836)
    // only after an opt-in, which costs nothing to repeat
    int dyn = 5 * Cin * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(conv_gemm<9, true, 0, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    conv_gemm<9, true, 0, true><<<grid, NTHREADS, dyn, st>>>(p);
  } else if (Cin % 8 == 0)
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

// One ResnetBlock (K1, and K8 at the deep stages) in one call: kernel A
// (conv1 + statistics), its GroupNorm, kernel B (GN1 + mish + FiLM + mask
// on load, conv2 + statistics), its GroupNorm, kernel C (GN2 + mish + mask
// + residual; identity when wres == NULL). Scratch: c1, c2 (B, N, Cout)
// bf16; part (B, us_n_row_tiles(N), 2, Cout); mean/inv (B, Cout).
int us_resnet_block(const void* x, const void* w1, const float* b1, const float* s1,
                    const float* be1, const void* film, const void* w2, const float* b2,
                    const float* s2, const float* be2, const void* wres, const float* bres,
                    const int* lens, void* c1, void* c2, float* part, float* mean1, float* inv1,
                    float* mean2, float* inv2, void* out, int B, int N, int F, int Cin, int Cout,
                    int groups, float eps, void* stream) {
  const int nt = us_n_row_tiles(N);
  int err = us_resnet_conv3x3(x, w1, b1, lens, nullptr, nullptr, nullptr, nullptr, nullptr, c1,
                              part, B, N, F, Cin, Cout, stream);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean1, inv1, stream);
  if (err) return err;
  err = us_resnet_conv3x3(c1, w2, b2, lens, mean1, inv1, s1, be1, film, c2, part, B, N, F, Cout,
                          Cout, stream);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean2, inv2, stream);
  if (err) return err;
  return us_resnet_out(c2, x, mean2, inv2, s2, be2, wres, bres, lens, out, B, N, Cin, Cout,
                       stream);
}

}  // extern "C"
