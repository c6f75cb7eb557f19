// ResnetBlock with both convs quantized in kernel per TPU tile (kernel K10a).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resnet.py:
// fused_resnet_block(int8=True): _fused_resnet's _kernel_a and _kernel_b
// with _conv3x3_taps_int8; kernel C is K1's (us_resnet_out).
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
// A halo row takes the scale of the tile it feeds, not its own: each row at
// a tile edge is quantized twice, with two scales. So the input is not
// quantized once in place (as K9's is) but into a per-tile copy x8t (B,
// n_tiles, fpt + 2, F, Cp) int8: tile j's window, its halo frames
// duplicated from the neighbouring tiles, every element rounded with sx[b,
// j]; zero outside the array, at frames >= len and at channels past the
// input's (Cp is C rounded up to 16: the first block's Cin = 2 gives TMA a
// 16-byte row, and the packed weights have zero rows there). Both convs run
// on K9's Hopper loop (csrc/resnet_block.cu conv_tc with I8) in its tiled
// mode: TMA boxes of one tile's copy, s8 wgmma into s32, the dequantize with
// the tile's scale in the epilogue. One block is nine launches, each a
// programmatic dependent launch (common.cuh launch_pdl):
//
//   fmax       = frame maxima of |x| (0 at frames >= len)       frame_absmax
//   sx1, x8t   = tile scales from fmax, x's per-tile copy          tile_copy
//   c1 + stats = conv3x3(x8t) * (1/sx1[tile]) rsw1 + b1            conv_tc
//   mean1, inv1 = GroupNorm 1                                       gn_finalize
//   h, fmax    = bf16(mish(GN1(c1) scale + shift) + FiLM) in place
//                of c1, once per element, and its frame maxima     frame_absmax
//   sx2, h8t   = h's per-tile copy                                 tile_copy
//   c2 + stats = conv3x3(h8t) * (1/sx2[tile]) rsw2 + b2            conv_tc
//   mean2, inv2 = GroupNorm 2                                       gn_finalize
//   out        = mish(GN2(c2)) mask + residual                     K1's kernel C
//
// What bounds it on the H100: the convs' products. At the early stages each
// conv is 12-24 GOP a call (3 rows of the 344-frame bucket), 6-12 us at the
// int8 rate; the passes around them move the activations a few times (the
// copy is (fpt + 2) / fpt of the input's int8 bytes: 1.25x at F = 80, 1.5x
// at the fpt = 4 site). A conv row tile never crosses a TPU tile (TT <=
// fpt), so where fpt is not a multiple of the row tile part of a tile's
// rows is idle (PERF.md). Rounding follows JAX operation by operation
// (__fmul_rn, __fadd_rn, rintf), as K9 does.
#include "common.cuh"

extern "C" {
int us_gn_finalize(const float* part, int B, int n_tiles, int C, int groups, int n_rows,
                   float eps, float* mean, float* inv, int pdl, void* stream);
int us_resnet_out(const void* c2, const void* x, const float* mean, const float* inv,
                  const float* scale, const float* shift, const void* wres, int BN,
                  const float* bres, const int* lens, void* out, int B, int N, int Cin,
                  int Cout, int pdl, void* stream);
int us_resnet_conv3x3_i8_tiles(const void* x8t, const void* w8, int BN, const float* sx,
                               const float* rsw, const float* bias, void* out, float* part, int B,
                               int N, int F, int Cp, int Cout, int fpt, void* stream);
int us_conv_i8_tiles_n_tiles(int N, int F, int fpt);
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

// max_nan over the 32 lanes of a warp (every lane gets it)
US_DEV float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Eight 16-byte pieces of bf16 as floats.
US_DEV void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f2 = __bfloat1622float2(hv[i]);
    v[2 * i] = f2.x, v[2 * i + 1] = f2.y;
  }
}

// fmax[b, t] = max |v| over frame t of batch element b, 0 at frames >=
// lens[b] (rows, a multiple of F). XFORM: v is kernel B's h of x (c1),
// written back in place (h = x allowed; the frames at/after the length are
// not written: the copy never reads them). A thread's pieces are loaded
// eight at a time before any is transformed or stored, and the block's
// maximum is taken by warp shuffles. Grid (T, B) of 256 threads. VEC: C %
// 8 == 0 (16-byte loads).
template <bool XFORM, bool VEC>
__global__ void __launch_bounds__(256) frame_absmax(const bf16* x, bf16* h, const int* lens,
                                                    Xform xf, float* fmax, int N, int F, int C) {
  extern __shared__ float table[];
  __shared__ float wmax[8];
  griddep_wait();
  griddep_launch();
  const int t = blockIdx.x, b = blockIdx.y, T = gridDim.x;
  const int row0 = t * F;
  float m = 0.f;
  if (row0 < lens[b]) {  // a whole frame is valid or not
    if (XFORM) load_table(table, xf, b, C);
    const size_t base = ((size_t)b * N + row0) * C;
    if (VEC) {
      const int pieces = F * C / 8;
      const uint4* src = reinterpret_cast<const uint4*>(x + base);
      for (int p0 = 0; p0 < pieces; p0 += 8 * blockDim.x) {
        uint4 raw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int idx = p0 + threadIdx.x + k * blockDim.x;
          raw[k] = idx < pieces ? __ldg(src + idx) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int idx = p0 + threadIdx.x + k * blockDim.x;
          if (idx >= pieces) continue;
          float v[8];
          unpack8(raw[k], v);
          if (XFORM) {
            const int c0 = idx * 8 % C;
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = xform_i8(v[e], c0 + e, table, C);
            store8(h + base + (size_t)idx * 8, v);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) m = max_nan(m, fabsf(v[e]));
        }
      }
    } else {
      for (int e = threadIdx.x; e < F * C; e += blockDim.x)
        m = max_nan(m, fabsf(__bfloat162float(x[base + e])));
    }
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) m = max_nan(m, wmax[w]);
    fmax[b * T + t] = m;
  }
}

// The per-tile copy: x8t[b, j, c, f, :] = clip(rint(v[b, (j fpt - 1 + c) F +
// f, :] * sx[b, j]), -127, 127) for the copy frames c = 0 .. fpt + 1 of
// tile j: its window, the halo frames duplicated from the neighbouring
// tiles and rounded with this tile's scale; zero at frames outside [0, T)
// and at/after the length, and at channels C .. Cp. sx[b, j] = 127 / (m +
// 1e-8), m the max of fmax over the window's frames: each warp reduces
// them itself while its first loads are in flight (no block barrier), and
// copy frame 0's block writes it. Grid (fpt + 2, n_tiles, B); 8 channels a
// thread (VEC: C % 8 == 0, else element loads).
template <bool VEC>
__global__ void __launch_bounds__(256) tile_copy(const bf16* x, const int* lens,
                                                 const float* fmax, float* sx, int8_t* x8t,
                                                 int T, int F, int C, int Cp, int fpt) {
  griddep_wait();
  griddep_launch();
  const int c = blockIdx.x, j = blockIdx.y, b = blockIdx.z, nt = gridDim.y;
  const int t = j * fpt - 1 + c;  // the copy frame's frame of x
  const bool live = t >= 0 && t < T && t * F < lens[b];
  const int cpp = Cp / 8, pieces = F * cpp;
  const bf16* src = x + ((size_t)b * T + (live ? t : 0)) * F * C;
  int8_t* dst = x8t + (((size_t)b * nt + j) * (fpt + 2) + c) * F * Cp;
  float s = 0.f;
  for (int base = 0; base < pieces; base += 8 * blockDim.x) {  // the same trips in every thread
    uint4 raw[8];  // eight pieces loaded before the scale and the stores
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + threadIdx.x + k * blockDim.x, c0 = (idx % cpp) * 8;
      raw[k] = make_uint4(0, 0, 0, 0);
      if (!live || idx >= pieces || c0 >= C) continue;
      const bf16* p = src + (size_t)(idx / cpp) * C + c0;
      if (VEC) {
        raw[k] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        bf16* r = reinterpret_cast<bf16*>(&raw[k]);
        for (int e = 0; e < 8 && c0 + e < C; ++e) r[e] = p[e];
      }
    }
    if (base == 0) {
      const int lo = max(j * fpt - 1, 0), hi = min((j + 1) * fpt, T - 1);
      float m = 0.f;
      for (int i = lo + (threadIdx.x & 31); i <= hi; i += 32) m = max_nan(m, fmax[b * T + i]);
      m = warp_max(m);
      s = __fdiv_rn(127.f, __fadd_rn(m, 1e-8f));
      if (c == 0 && threadIdx.x == 0) sx[b * nt + j] = s;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = base + threadIdx.x + k * blockDim.x;
      if (idx >= pieces) continue;
      float v[8];
      unpack8(raw[k], v);
      uint2 q;
      int8_t* qe = reinterpret_cast<int8_t*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) qe[e] = quant_i8(v[e], s);
      *reinterpret_cast<uint2*>(dst + (size_t)(idx / cpp) * Cp + (idx % cpp) * 8) = q;
    }
  }
}

int round16(int c) { return (c + 15) / 16 * 16; }

// The frame maxima of v (XFORM: h of x, written in place) and v's per-tile
// copy with its scales: two launches.
template <bool XFORM>
int quantize_tiles(const void* x, void* h, const int* lens, Xform xf, float* fmax, float* sx,
                   void* x8t, int B, int N, int F, int C, int fpt, cudaStream_t st) {
  const int T = N / F;
  const int dyn = XFORM ? 5 * C * (int)sizeof(float) : 0;
  auto fm = XFORM ? frame_absmax<true, true>
                  : C % 8 == 0 ? frame_absmax<false, true> : frame_absmax<false, false>;
  cudaError_t e = cudaFuncSetAttribute(fm, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (e != cudaSuccess) return (int)e;
  int err = launch_pdl(fm, dim3(T, B), 256, dyn, st, static_cast<const bf16*>(x),
                       static_cast<bf16*>(h), lens, xf, fmax, N, F, C);
  if (err) return err;
  const bf16* v = static_cast<const bf16*>(XFORM ? h : x);
  return launch_pdl(C % 8 == 0 ? tile_copy<true> : tile_copy<false>, dim3(fpt + 2, T / fpt, B),
                    256, 0, st, v, lens, static_cast<const float*>(fmax), sx,
                    static_cast<int8_t*>(x8t), T, F, C, round16(C), fpt);
}

}  // namespace

extern "C" {

// x's per-tile copy alone (the chain's first two launches): fmax (B, N / F)
// scratch, sx (B, n_tiles) and x8t (B, n_tiles, fpt + 2, F, round16(C))
// int8, n_tiles = N / (F fpt).
int us_i8_tile_copy(const void* x, const int* lens, float* fmax, float* sx, void* x8t, int B,
                    int N, int F, int C, int fpt, void* stream) {
  if (fpt <= 0 || N % (F * fpt)) return (int)cudaErrorInvalidValue;
  return quantize_tiles<false>(x, nullptr, lens, Xform{}, fmax, sx, x8t, B, N, F, C, fpt,
                               static_cast<cudaStream_t>(stream));
}

// One ResnetBlock with int8 convs quantized in kernel per tile of fpt
// frames (K10a), in one call of nine launches. w8p1 / w8p2 packed by
// pack_conv_weight_i8 (conv1 for round16(Cin) input channels) in Cout
// tiles of BN, with reciprocal scales rsw1 / rsw2 (Cout); wres the 1x1
// residual as us_resnet_out takes it (packed in Cout tiles of BN, or the
// raw (Cin, Cout) rows for Cin % 8 != 0), NULL for the identity. Scratch:
// fmax (B, T), sx1, sx2 (B, T / fpt), x8t (B, T / fpt, fpt + 2, F,
// round16(Cin)), h8t (the same with Cout) int8, c1, c2 (B, N, Cout) bf16
// (c1 becomes h), part (B, us_conv_i8_tiles_n_tiles(N, F, fpt), 2, Cout),
// mean/inv (B, Cout). N = T * F, T % fpt == 0, Cout % 64 == 0.
int us_resnet_block_i8(const void* x, const void* w8p1, const float* rsw1, const float* b1,
                       const float* s1, const float* be1, const void* film, const void* w8p2,
                       const float* rsw2, const float* b2, const float* s2, const float* be2,
                       const void* wres, const float* bres, const int* lens, float* fmax,
                       float* sx1, float* sx2, void* x8t, void* h8t, void* c1, void* c2,
                       float* part, float* mean1, float* inv1, float* mean2, float* inv2,
                       void* out, int B, int N, int F, int Cin, int Cout, int fpt, int groups,
                       float eps, int BN, void* stream) {
  if (fpt <= 0 || N % (F * fpt) || Cout % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = us_conv_i8_tiles_n_tiles(N, F, fpt);
  int err = quantize_tiles<false>(x, nullptr, lens, Xform{}, fmax, sx1, x8t, B, N, F, Cin, fpt,
                                  st);
  if (err) return err;
  err = us_resnet_conv3x3_i8_tiles(x8t, w8p1, BN, sx1, rsw1, b1, c1, part, B, N, F, round16(Cin),
                                   Cout, fpt, stream);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean1, inv1, 1, stream);
  if (err) return err;
  const Xform h = {mean1, inv1, s1, be1, static_cast<const bf16*>(film)};
  err = quantize_tiles<true>(c1, c1, lens, h, fmax, sx2, h8t, B, N, F, Cout, fpt, st);
  if (err) return err;
  err = us_resnet_conv3x3_i8_tiles(h8t, w8p2, BN, sx2, rsw2, b2, c2, part, B, N, F, Cout, Cout,
                                   fpt, stream);
  if (err) return err;
  err = us_gn_finalize(part, B, nt, Cout, groups, N, eps, mean2, inv2, 1, stream);
  if (err) return err;
  return us_resnet_out(c2, x, mean2, inv2, s2, be2, wres, BN, bres, lens, out, B, N, Cin, Cout, 1,
                       stream);
}

}  // extern "C"
