// ResnetBlock with both convs quantized in kernel per TPU tile (kernel K10a).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block(int8=True): _fused_resnet's _kernel_a and _kernel_b
// with _conv3x3_taps_int8; kernel C is K1's in its raw-weight form
// (us_resnet_out_rows). It keeps the element-load main loops of common.cuh
// (igemm_s8); no served path runs it. (K10b, the deep blocks' in-kernel
// int8 mode, runs on K9's chain: csrc/resnet_deep_i8.cu.)
//
// What the TPU kernels compute: each grid step quantizes its conv input
// window, the tile's fpt frames plus one halo frame above and below (zero
// outside the array and at rows >= len), with ONE scale
// s = 127 / (max|window| + 1e-8); the products run int8 x int8 -> int32,
// dequantized as f32(acc) * ((1/s) * rsw[c]) + bias, with rsw the
// per-output-channel reciprocal weight scales (_quant_w). Kernel B
// quantizes h = mish(GN1(c1) * scale + shift) + FiLM, masked and rounded to
// the activation dtype first. The tiles are fpt = _pick_frames_per_tile
// frames.
//
// Layout: rows n = t*F + f of one batch element, channels last. The scale
// groups belong to the TPU's tiles, which the 128-row GEMM tile does not
// line up with, so the scale is a property of the OUTPUT row's tile: a halo
// input row is quantized with the scale of the tile it feeds, not its own,
// and the input cannot be quantized once ahead of the conv (as K9 does).
// So the conv quantizes on load: the A-operand loader reads bf16, applies
// kernel B's transform where there is one, and rounds with the scale of
// the output row's tile. The scales come from two small passes first: the
// abs-max of every (batch, frame) (the halo is one frame and the row mask
// is frame-granular) and a reduction of those maxima over each tile's
// frames plus its halo frames.
//
// What bounds it on the H100: the convs' products. At the early stages
// (F = 80/40) each conv is 12-24 GOP per call against 7-21 MB of
// activations; int8 on mma.sync m16n8k32 (s8 in, s32 accumulate) runs at
// twice the bf16 rate. The quantize costs a convert, a multiply, a round
// and a clip per loaded element, and kernel B's transform (with its exp)
// is recomputed per tap as in K1's kernel B: both ride in the loader. The
// weights are n-major (Cout, Kp) int8, Kp = 9*Cin rounded up to 16 (zero
// columns), so Cin = 2 takes the same 16-byte B loads. Rounding follows
// JAX operation by operation (__fmul_rn, __fadd_rn, rintf), as K9 does.
#include "common.cuh"

extern "C" {
int us_gn_finalize(const float* part, int B, int n_tiles, int C, int groups, int n_rows,
                   float eps, float* mean, float* inv, int pdl, void* stream);
int us_resnet_out_rows(const void* c2, const void* x, const float* mean, const float* inv,
                       const float* scale, const float* shift, const void* wres,
                       const float* bres, const int* lens, void* out, int B, int N, int Cin,
                       int Cout, void* stream);
int us_n_row_tiles(int N);
}

namespace {

// Kernel B's input transform, one element, in JAX's order of operations:
// bf16(mish((c1 - mean) * inv * scale + shift) + film). `t` is the table
// (mean, inv, scale, shift, film) of 5 * C floats in shared memory.
US_DEV float xform_i8(float v, int c, const float* t, int C) {
  float h = __fmul_rn(__fsub_rn(v, t[c]), t[C + c]);
  h = __fadd_rn(__fmul_rn(h, t[2 * C + c]), t[3 * C + c]);
  return bf16_round(__fadd_rn(mish_f32(h), t[4 * C + c]));
}

struct Xform {
  const float* mean;   // (B, C)
  const float* inv;    // (B, C)
  const float* scale;  // (C)
  const float* shift;  // (C)
  const bf16* film;    // (B, C)
};

US_DEV void load_table(float* t, const Xform& x, int b, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    t[c] = x.mean[b * C + c];
    t[C + c] = x.inv[b * C + c];
    t[2 * C + c] = x.scale[c];
    t[3 * C + c] = x.shift[c];
    t[4 * C + c] = __bfloat162float(x.film[b * C + c]);
  }
  __syncthreads();
}

// fmax[b, t] = max |v| over frame t of batch element b, v the conv input
// (XFORM: kernel B's transformed h), 0 on rows >= lens[b]. Grid (T, B).
// VEC: C % 8 == 0 (16-byte loads).
template <bool XFORM, bool VEC>
__global__ void __launch_bounds__(256) frame_absmax(const bf16* x, const int* lens, Xform xf,
                                                    float* fmax, int N, int F, int C) {
  extern __shared__ float table[];
  __shared__ float scratch[256];
  const int t = blockIdx.x, b = blockIdx.y, T = gridDim.x;
  const int len = lens[b];
  if (XFORM) load_table(table, xf, b, C);
  const int row0 = t * F;
  const bf16* xb = x + ((size_t)b * N + row0) * C;
  float m = 0.f;
  if (VEC) {
    for (int v = threadIdx.x; v < F * C / 8; v += blockDim.x) {
      int e0 = v * 8, c0 = e0 % C;
      if (row0 + e0 / C >= len) continue;
      float vals[8];
      load8(xb + e0, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        m = max_nan(m, fabsf(XFORM ? xform_i8(vals[e], c0 + e, table, C) : vals[e]));
    }
  } else {
    for (int e = threadIdx.x; e < F * C; e += blockDim.x) {
      if (row0 + e / C >= len) continue;
      float v = __bfloat162float(xb[e]);
      m = max_nan(m, fabsf(XFORM ? xform_i8(v, e % C, table, C) : v));
    }
  }
  m = block_max(m, scratch);
  if (threadIdx.x == 0) fmax[b * T + t] = m;
}

// sx[b, j] = 127 / (m + 1e-8), m the max of fmax over tile j's fpt frames
// and the one halo frame on each side that exists.
__global__ void __launch_bounds__(256) tile_scales(const float* fmax, int T, int fpt,
                                                   int n_tiles, int total, float* sx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / n_tiles, j = i % n_tiles;
  const int lo = max(j * fpt - 1, 0), hi = min((j + 1) * fpt, T - 1);
  float m = 0.f;
  for (int t = lo; t <= hi; ++t) m = max_nan(m, fmax[b * T + t]);
  sx[i] = __fdiv_rn(127.f, __fadd_rn(m, 1e-8f));
}

struct I8QArgs {
  const bf16* x;      // (B, N, Cin) the conv input, bf16
  const int8_t* w;    // (Cout, Kp) int8, n-major, zero past 9*Cin
  const float* rsw;   // (Cout) reciprocal weight scales
  const float* bias;  // (Cout)
  const int* lens;    // (B) valid rows
  const float* sx;    // (B, n_tiles) activation scale of each tile
  Xform xf;           // kernel B's transform (XFORM)
  bf16* out;          // (B, N, Cout)
  float* part;        // (B, n_mtiles, 2, Cout) tile statistics
  int N, F, Cin, Cout, Kp, tile;
};

// conv3x3 + dequantize + bias -> out (bf16) + tile statistics of the f32
// value, quantizing the A operand on load with the scale of the output
// row's tile. VEC: Cin % 16 == 0 (one tap and 16 channels per chunk);
// otherwise element loads (Cin = 2).
template <bool XFORM, bool VEC>
__global__ void __launch_bounds__(IG_THREADS) conv3x3_i8q(I8QArgs p) {
  __shared__ IgemmTilesS8 tiles;
  __shared__ float red[4][2][IG_BN];
  extern __shared__ float table[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN, b = blockIdx.z;
  const int N = p.N, F = p.F, Cin = p.Cin, Cout = p.Cout, Kp = p.Kp, tile = p.tile;
  const int T = N / F, n_tiles = N / tile;
  const int len = p.lens[b];
  const int K = 9 * Cin, nk = (Kp + IG8_BK - 1) / IG8_BK;
  const bf16* xb = p.x + (size_t)b * N * Cin;
  const float* sxb = p.sx + (size_t)b * n_tiles;
  if (XFORM) load_table(table, p.xf, b, Cin);

  // the source row of output row m at tap (dt, df), or -1 off the grid or
  // at/after the length (both read zero)
  auto source = [&](int m, int tap) -> int {
    int t = m / F, f = m - t * F;
    int tt = t + tap / 3 - 1, ff = f + tap % 3 - 1;
    if (tt < 0 || tt >= T || ff < 0 || ff >= F) return -1;
    int src = tt * F + ff;
    return src < len ? src : -1;
  };
  auto value_in = [&](float v, int ci) -> float {
    return XFORM ? xform_i8(v, ci, table, Cin) : v;
  };

  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * IG8_BK + (v & 3) * 16;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= N || k >= K) continue;
      const float sc = sxb[m / tile];
      int8_t* q = reinterpret_cast<int8_t*>(&reg[s]);
      if (VEC) {
        int tap = k / Cin, ci = k - tap * Cin;
        int src = source(m, tap);
        if (src < 0) continue;
        const bf16* ptr = xb + (size_t)src * Cin + ci;
        float lo[8], hi[8];
        load8(ptr, lo);
        load8(ptr + 8, hi);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          q[e] = quant_i8(value_in(lo[e], ci + e), sc);
          q[8 + e] = quant_i8(value_in(hi[e], ci + 8 + e), sc);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          int ke = k + e;
          if (ke >= K) break;
          int tap = ke / Cin, ci = ke - tap * Cin;
          int src = source(m, tap);
          if (src < 0) continue;
          q[e] = quant_i8(value_in(__bfloat162float(xb[(size_t)src * Cin + ci]), ci), sc);
        }
      }
    }
  };
  auto load_b = [&](int kb) -> uint4 {
    int k = kb * IG8_BK + (tid & 3) * 16;
    if (k >= Kp) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + (tid >> 2)) * Kp + k);
  };

  int acc[2][4][4];
  igemm_s8(acc, tiles, nk, load_a, load_b);
  auto value = [&](int a, int m, int n) -> float {
    float swe = __fmul_rn(__fdiv_rn(1.f, sxb[m / tile]), p.rsw[n]);
    return __fadd_rn(__fmul_rn(__int2float_rn(a), swe), p.bias[n]);
  };
  store_tile_stats(acc, value, p.out, p.part, red, N, Cout, m0, n0, b);
}

// The activation scales of one conv (the two passes) and the conv itself.
template <bool XFORM>
int quantized_conv(const void* x, const int8_t* w8t, const float* rsw, const float* bias,
                   const int* lens, Xform xf, float* fmax, float* sx, void* out, float* part,
                   int B, int N, int F, int Cin, int Cout, int fpt, cudaStream_t st) {
  const int T = N / F, n_tiles = T / fpt;
  const int dyn = XFORM ? 5 * Cin * (int)sizeof(float) : 0;
  const bf16* xin = static_cast<const bf16*>(x);
  auto fm = Cin % 8 == 0 ? frame_absmax<XFORM, true> : frame_absmax<XFORM, false>;
  auto conv = Cin % 16 == 0 ? conv3x3_i8q<XFORM, true> : conv3x3_i8q<XFORM, false>;
  // above 48 KB of shared memory in all only after an opt-in
  cudaError_t err = cudaFuncSetAttribute(fm, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  fm<<<dim3(T, B), 256, dyn, st>>>(xin, lens, xf, fmax, N, F, Cin);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = B * n_tiles;
  tile_scales<<<us_ceil_div(total, 256), 256, 0, st>>>(fmax, T, fpt, n_tiles, total, sx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  I8QArgs p;
  p.x = xin;
  p.w = w8t;
  p.rsw = rsw;
  p.bias = bias;
  p.lens = lens;
  p.sx = sx;
  p.xf = xf;
  p.out = static_cast<bf16*>(out);
  p.part = part;
  p.N = N;
  p.F = F;
  p.Cin = Cin;
  p.Cout = Cout;
  p.Kp = us_ceil_div(9 * Cin, 16) * 16;
  p.tile = fpt * F;
  conv<<<dim3(us_ceil_div(N, IG_BM), Cout / IG_BN, B), IG_THREADS, dyn, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One ResnetBlock with int8 convs quantized in kernel per tile of fpt
// frames (K10a), in one call: conv1 (int8), its GroupNorm, conv2 (int8 on
// kernel B's transform), its GroupNorm, kernel C (residual: identity when
// wres == NULL). w8t1 (Cout, Kp(Cin)) and w8t2 (Cout, 9*Cout) int8 with
// reciprocal scales rsw1/rsw2 (Cout). Scratch: fmax (B, T), sx (B, T / fpt),
// c1, c2 (B, N, Cout) bf16, part (B, us_n_row_tiles(N), 2, Cout), mean/inv
// (B, Cout). N = T*F, T % fpt == 0, Cout % 64 == 0.
int us_resnet_block_i8(const void* x, const void* w8t1, const float* rsw1, const float* b1,
                       const float* s1, const float* be1, const void* film, const void* w8t2,
                       const float* rsw2, const float* b2, const float* s2, const float* be2,
                       const void* wres, const float* bres, const int* lens, float* fmax,
                       float* sx, void* c1, void* c2, float* part, float* mean1, float* inv1,
                       float* mean2, float* inv2, void* out, int B, int N, int F, int Cin,
                       int Cout, int fpt, int groups, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = us_n_row_tiles(N);
  const Xform none = {};
  int err = quantized_conv<false>(x, static_cast<const int8_t*>(w8t1), rsw1, b1, lens, none,
                                  fmax, sx, c1, part, B, N, F, Cin, Cout, fpt, st);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean1, inv1, 0, stream);
  if (err) return err;
  const Xform h = {mean1, inv1, s1, be1, static_cast<const bf16*>(film)};
  err = quantized_conv<true>(c1, static_cast<const int8_t*>(w8t2), rsw2, b2, lens, h, fmax, sx,
                             c2, part, B, N, F, Cout, Cout, fpt, st);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean2, inv2, 0, stream);
  if (err) return err;
  return us_resnet_out_rows(c2, x, mean2, inv2, s2, be2, wres, bres, lens, out, B, N, Cin,
                            Cout, stream);
}

}  // extern "C"
