// Deep ResnetBlock with int8 convs on pre-quantized activations (kernel K9).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block_deep_i8 (_fused_resnet_deep_i8pre: _kernel_a_deep_i8
// with _conv3x3_taps_i8pre, _kernel_glue_q_deep; kernel C is K8's, shared
// from resnet_block.cu). The block runs as
//
//   x8 = quantize(x)   per batch element, one scale 127 / max|x| over the
//                      masked rows (the row abs-max kernel K7, then
//                      us_i8_quantize_rows); for cin > cout conv1 runs in
//                      bf16 instead (K8's kernel A), as in JAX
//   c1 = conv3x3_i8(x8) * (1/sx)(1/sw) + b1        -> bf16 + statistics
//   h8 = quantize(mish(GN1(c1)) + FiLM, masked)    two passes, below
//   c2 = conv3x3_i8(h8) * (1/sx2)(1/sw2) + b2      -> bf16 + statistics
//   out = mish(GN2(c2)) * mask + residual          (K8's kernel C)
//
// Scales: weights per output channel, computed once when the weights load
// (ops/fused_resnet_deep.quant_w: reciprocals, as _quant_w); activations per
// batch element, not per tensor as the flat int8 path has it. The glue's
// scale needs the abs-max of the whole layer before any value can round, so
// the glue runs twice: pass 0 writes per-(batch, row chunk, channel) maxima,
// us_i8_scales reduces them, pass 1 recomputes h and rounds it. A max does
// not depend on the order of its operands, so the scale is exact.
//
// What bounds it on the H100: each int8 conv is 6-24 GOP (3 rows at the
// 344-frame bucket) against 0.6-2.4 MB of int8 weights; at the int8 rate of
// 1979 TOP/s that is 3-12 us, so the tensor cores (mma.sync m16n8k32, s8 in,
// s32 accumulate) bound it as they bound K8, at half K8's operation time.
// The dequantize, bias and GroupNorm statistics ride in the conv's
// epilogue; the glue passes are bytes-bound (c1 read twice, h8 written
// once). Rounding follows JAX: round half to even (rintf), clip to +-127,
// and the dequantize as one f32 multiply and one f32 add (no fused
// multiply-add).
#include "common.cuh"

namespace {

constexpr int GLUE_ROWS = 64;  // rows of one glue block (a chunk)

// One batch element per block: sx = 127 / max(max(amax[b]), 1e-8) and the
// effective dequantize scale swe[b, c] = (1 / sx) * rsw[c].
__global__ void __launch_bounds__(256) i8_scales(const float* amax, int n, const float* rsw,
                                                 int Cout, float* sx, float* swe) {
  __shared__ float scratch[256];
  const int b = blockIdx.x;
  const float* a = amax + (size_t)b * n;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max_nan(m, a[i]);
  m = block_max(m, scratch);
  float s = 127.f / (m != m ? m : fmaxf(m, 1e-8f));
  if (threadIdx.x == 0) sx[b] = s;
  float r = 1.f / s;
  for (int c = threadIdx.x; c < Cout; c += blockDim.x) swe[b * Cout + c] = __fmul_rn(r, rsw[c]);
}

// x8 = clip(rint(x * sx[b]), -127, 127) on rows < lens[b], 0 after; 8
// channels a thread.
__global__ void __launch_bounds__(256) i8_quantize(const bf16* x, const int* lens,
                                                   const float* sx, int8_t* x8, int B, int N,
                                                   int C) {
  size_t nvec = (size_t)B * N * C / 8;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    size_t e0 = v * 8;
    size_t row = e0 / C;
    int b = (int)(row / N), m = (int)(row % N);
    uint2 q = make_uint2(0, 0);
    if (m < lens[b]) {
      float vals[8];
      load8(x + e0, vals);
      int8_t* qe = reinterpret_cast<int8_t*>(&q);
      const float s = sx[b];
#pragma unroll
      for (int e = 0; e < 8; ++e) qe[e] = quant_i8(vals[e], s);
    }
    *reinterpret_cast<uint2*>(x8 + e0) = q;
  }
}

struct I8ConvArgs {
  const int8_t* x;    // (B, N, Cin), zero at rows >= lens
  const int8_t* w;    // (Cout, 9*Cin): the kernel transposed, n-major
  const float* swe;   // (B, Cout) effective dequantize scale
  const float* bias;  // (Cout)
  const int* lens;    // (B)
  bf16* out;          // (B, N, Cout)
  float* part;        // (B, n_mtiles, 2, Cout)
  int N, F, Cin, Cout;
};

// conv3x3 on int8 rows: out = bf16(f32(acc) * swe + bias), tile statistics
// of the f32 value. Cin % 16 == 0, Cout % 64 == 0.
__global__ void __launch_bounds__(IG_THREADS) conv3x3_i8(I8ConvArgs p) {
  __shared__ IgemmTilesS8 tiles;
  __shared__ float red[4][2][IG_BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN, b = blockIdx.z;
  const int N = p.N, F = p.F, Cin = p.Cin, Cout = p.Cout;
  const int T = N / F;
  const int len = p.lens[b];
  const int K = 9 * Cin, nk = (K + IG8_BK - 1) / IG8_BK;
  const int8_t* xb = p.x + (size_t)b * N * Cin;

  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * IG8_BK + (v & 3) * 16;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= N || k >= K) continue;
      int tap = k / Cin, ci = k - tap * Cin;
      int t = m / F, f = m - t * F;
      int tt = t + tap / 3 - 1, ff = f + tap % 3 - 1;
      if (tt < 0 || tt >= T || ff < 0 || ff >= F) continue;
      int src = tt * F + ff;
      if (src >= len) continue;
      reg[s] = *reinterpret_cast<const uint4*>(xb + (size_t)src * Cin + ci);
    }
  };
  auto load_b = [&](int kb) -> uint4 {
    int k = kb * IG8_BK + (tid & 3) * 16;
    if (k >= K) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + (tid >> 2)) * K + k);
  };

  int acc[2][4][4];
  igemm_s8(acc, tiles, nk, load_a, load_b);
  const float* swe = p.swe + (size_t)b * Cout;
  auto value = [&](int a, int, int n) -> float {
    return __fadd_rn(__fmul_rn(__int2float_rn(a), swe[n]), p.bias[n]);
  };
  store_tile_stats(acc, value, p.out, p.part, red, N, Cout, m0, n0, b);
}

struct GlueArgs {
  const bf16* c;        // (B, N, C) conv1 output
  const float* mean;    // (B, C) GroupNorm mean, per channel
  const float* inv;     // (B, C)
  const float* scale;   // (C)
  const float* shift;   // (C)
  const bf16* film;     // (B, C)
  const int* lens;      // (B)
  const float* sx;      // (B) pass 1: the scale
  float* amax;          // pass 0: (B, n_chunks, C) maxima of |h|
  int8_t* h8;           // pass 1: (B, N, C)
  int N, C;
};

// h = mish(GN1(c1) * scale + shift) + film, zero on rows >= lens (the JAX
// glue's arithmetic in f32, one rounding per operation). Block: 8 row lanes
// x 32 channel groups of 8; grid (channel blocks of 256, row chunks, B).
template <bool QUANT>
__global__ void __launch_bounds__(256) glue_i8(GlueArgs p) {
  __shared__ float red[8][256];
  const int tid = threadIdx.x, lane_r = tid >> 5;
  const int c0 = (blockIdx.x * 32 + (tid & 31)) * 8;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int N = p.N, C = p.C;
  const int len = p.lens[b];
  const bool active = c0 < C;
  float mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) mx[e] = 0.f;
  if (active) {
    float mean[8], inv[8], sc[8], sh[8], fi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mean[e] = p.mean[b * C + c0 + e];
      inv[e] = p.inv[b * C + c0 + e];
      sc[e] = p.scale[c0 + e];
      sh[e] = p.shift[c0 + e];
      fi[e] = __bfloat162float(p.film[b * C + c0 + e]);
    }
    const float s = QUANT ? p.sx[b] : 0.f;
    const int m_end = min(N, (chunk + 1) * GLUE_ROWS);
    for (int m = chunk * GLUE_ROWS + lane_r; m < m_end; m += 8) {
      size_t o = ((size_t)b * N + m) * C + c0;
      float h[8];
      load8(p.c + o, h);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = __fmul_rn(__fsub_rn(h[e], mean[e]), inv[e]);
        v = __fadd_rn(__fmul_rn(v, sc[e]), sh[e]);
        v = __fadd_rn(mish_f32(v), fi[e]);
        h[e] = m < len ? v : 0.f;
      }
      if (QUANT) {
        uint2 q;
        int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
        for (int e = 0; e < 8; ++e) qe[e] = quant_i8(h[e], s);
        *reinterpret_cast<uint2*>(p.h8 + o) = q;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) mx[e] = max_nan(mx[e], fabsf(h[e]));
      }
    }
  }
  if (!QUANT) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[lane_r][(tid & 31) * 8 + e] = mx[e];
    __syncthreads();
  }
  if (!QUANT && lane_r == 0 && active) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float m = red[0][tid * 8 + e];
      for (int r = 1; r < 8; ++r) m = max_nan(m, red[r][tid * 8 + e]);
      p.amax[((size_t)b * gridDim.y + chunk) * C + c0 + e] = m;
    }
  }
}

int quantize_launch_blocks(size_t nvec) {
  size_t blocks = (nvec + 255) / 256;
  return (int)(blocks > 65535 ? 65535 : blocks);
}

}  // namespace

extern "C" {

int us_i8_glue_chunks(int N) { return us_ceil_div(N, GLUE_ROWS); }

// The conv1 input of K9: from amax (B, n_amax) (the row abs-max of the
// masked x, K7), sx (B) and swe (B, Cout) = (1/sx) * rsw; then
// x8 = quantize(x) (B, N, Cin) with rows >= lens zero. Cin % 8 == 0.
int us_i8_quantize_rows(const void* x, const int* lens, const float* amax, int n_amax,
                        const float* rsw, void* x8, float* sx, float* swe, int B, int N, int Cin,
                        int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  i8_scales<<<B, 256, 0, st>>>(amax, n_amax, rsw, Cout, sx, swe);
  int err = (int)cudaGetLastError();
  if (err) return err;
  i8_quantize<<<quantize_launch_blocks((size_t)B * N * Cin / 8), 256, 0, st>>>(
      static_cast<const bf16*>(x), lens, sx, static_cast<int8_t*>(x8), B, N, Cin);
  return (int)cudaGetLastError();
}

// int8 conv3x3 + dequantize + bias -> out (bf16) and per-tile statistics
// (part, as us_resnet_conv3x3 writes them). w8t (Cout, 9*Cin) int8.
int us_resnet_conv3x3_i8(const void* x8, const void* w8t, const float* swe, const float* bias,
                         const int* lens, void* out, float* part, int B, int N, int F, int Cin,
                         int Cout, void* stream) {
  I8ConvArgs p;
  p.x = static_cast<const int8_t*>(x8);
  p.w = static_cast<const int8_t*>(w8t);
  p.swe = swe;
  p.bias = bias;
  p.lens = lens;
  p.out = static_cast<bf16*>(out);
  p.part = part;
  p.N = N;
  p.F = F;
  p.Cin = Cin;
  p.Cout = Cout;
  dim3 grid(us_ceil_div(N, IG_BM), Cout / IG_BN, B);
  conv3x3_i8<<<grid, IG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The glue of K9 (_kernel_glue_q_deep): pass 0 writes the maxima of |h| to
// amax (B, us_i8_glue_chunks(N), C), us_i8_scales turns them into sx (B)
// and swe (B, C) = (1/sx) * rsw, pass 1 writes h8 = quantize(h). C % 8 == 0.
int us_i8_glue(const void* c1, const float* mean, const float* inv, const float* scale,
               const float* shift, const void* film, const int* lens, const float* rsw,
               float* amax, void* h8, float* sx, float* swe, int B, int N, int C,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GlueArgs p;
  p.c = static_cast<const bf16*>(c1);
  p.mean = mean;
  p.inv = inv;
  p.scale = scale;
  p.shift = shift;
  p.film = static_cast<const bf16*>(film);
  p.lens = lens;
  p.sx = sx;
  p.amax = amax;
  p.h8 = static_cast<int8_t*>(h8);
  p.N = N;
  p.C = C;
  const int chunks = us_i8_glue_chunks(N);
  dim3 grid(us_ceil_div(C, 256), chunks, B);
  glue_i8<false><<<grid, 256, 0, st>>>(p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  i8_scales<<<B, 256, 0, st>>>(amax, chunks * C, rsw, C, sx, swe);
  err = (int)cudaGetLastError();
  if (err) return err;
  glue_i8<true><<<grid, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
