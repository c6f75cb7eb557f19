// The U-Net's strided resampling convs (kernels K11a and K11b).
//
// Replaces the Pallas kernels in unitspeech_tpu/ops/pallas_resample.py:
// fused_downsample_conv (_fused_downsample: _downsample_kernel), conv3x3
// stride 2, and fused_upsample_conv (_fused_upsample: _upsample_kernel),
// ConvTranspose 4x4 stride 2 with flax padding (2, 2). Both zero the input
// rows at/after the sequence length as they load them (the estimator skips
// its `h * mask` pass) and add the bias to every output row.
//
// Layout: rows n = t*F + f of one batch element, channels last, bf16; the
// kernel (kh, kw, Cin, Cout) in flax layout read as (taps*Cin, Cout),
// unflipped.
//
// What bounds them on the H100: at the 344-frame bucket (3 rows) each
// downsample is 6.1 GFLOP (6.2 us of tensor cores) against 14-27 MB of
// input and output (4-8 us of memory), the upsample 10.8 GFLOP against
// 27 MB: tensor cores and memory about equally. So the products go to the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) and the
// strides live in the loaders, with no im2col, no dilated copy and no
// phase buffer in device memory: each byte is read and written once.
//   * down: an implicit GEMM over the output rows (to, fo); tap (dt, df)
//     reads input row (2 to + dt, 2 fo + df), K = 9 * Cin;
//   * up: the four output phases (a, b) are four implicit GEMMs over the
//     undilated input rows (m, j), K = 4 * Cin: time tap a = 0 reads
//     (kt = 0, m - 1) and (kt = 2, m), a = 1 reads (kt = 1, m) and
//     (kt = 3, m + 1), and the same over (kf, j) for b. Each phase writes
//     its rows (2 m + a, 2 j + b) of the (2T, 2F) output directly (the TPU
//     kernel packs phases on lanes because Mosaic cannot interleave rows).
#include "common.cuh"

namespace {

struct ResampleArgs {
  const bf16* x;      // (B, T*F, Cin)
  const bf16* w;      // (taps*Cin, Cout)
  const float* bias;  // (Cout)
  const int* lens;    // (B) valid input rows (frames * F)
  bf16* out;          // (B, rows out, Cout)
  int T, F, Cin, Cout;
};

// out[b, row(m)] = acc + bias for the tile's rows m < M.
template <class Row>
__device__ __forceinline__ void store_bias_rows(const float (&acc)[2][4][4], const ResampleArgs& p,
                                                int M, int rows_out, int m0, int n0, int b,
                                                Row& row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = m0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
        int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
        if (m >= M) continue;
        float v0 = acc[i][j][2 * h] + p.bias[n];
        float v1 = acc[i][j][2 * h + 1] + p.bias[n + 1];
        *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)b * rows_out + row(m)) * p.Cout + n) =
            __floats2bfloat162_rn(v0, v1);
      }
}

__global__ void __launch_bounds__(IG_THREADS) downsample_conv(ResampleArgs p) {
  __shared__ IgemmTiles tiles;
  const int tid = threadIdx.x;
  const int T = p.T, F = p.F, Cin = p.Cin, Cout = p.Cout;
  const int Fo = F / 2, M = (T / 2) * Fo;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN, b = blockIdx.z;
  const int len = p.lens[b];
  const int K = 9 * Cin, nk = (K + IG_BK - 1) / IG_BK;
  const bf16* xb = p.x + (size_t)b * T * F * Cin;

  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * IG_BK + (v & 3) * 8;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= M || k >= K) continue;
      int tap = k / Cin, ci = k - tap * Cin;
      int to = m / Fo, fo = m - to * Fo;
      int ti = 2 * to + tap / 3 - 1, fi = 2 * fo + tap % 3 - 1;
      if (ti < 0 || ti >= T || fi < 0 || fi >= F) continue;
      int src = ti * F + fi;
      if (src >= len) continue;
      reg[s] = *reinterpret_cast<const uint4*>(xb + (size_t)src * Cin + ci);
    }
  };
  auto load_b = [&](int kb) -> uint4 {
    int k = kb * IG_BK + (tid >> 3);
    if (k >= K) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(p.w + (size_t)k * Cout + n0 + (tid & 7) * 8);
  };

  float acc[2][4][4];
  igemm_bf16(acc, tiles, nk, load_a, load_b);
  auto row = [](int m) { return m; };
  store_bias_rows(acc, p, M, M, m0, n0, b, row);
}

// blockIdx.z = batch * 4 + phase, phase = a * 2 + b (output row parity in
// time, in frequency).
__global__ void __launch_bounds__(IG_THREADS) upsample_conv(ResampleArgs p) {
  __shared__ IgemmTiles tiles;
  const int tid = threadIdx.x;
  const int T = p.T, F = p.F, Cin = p.Cin, Cout = p.Cout;
  const int M = T * F;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN;
  const int b = blockIdx.z >> 2, pa = (blockIdx.z >> 1) & 1, pb = blockIdx.z & 1;
  const int len = p.lens[b];
  const int K = 4 * Cin, nk = (K + IG_BK - 1) / IG_BK;
  const bf16* xb = p.x + (size_t)b * M * Cin;

  // tap q = it * 2 + jf: time tap it reads input frame m - 1 + it (a = 0)
  // or m + it (a = 1) with kernel row kt = a + 2 it; the same over (jf, kf)
  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * IG_BK + (v & 3) * 8;
      reg[s] = make_uint4(0, 0, 0, 0);
      if (m >= M || k >= K) continue;
      int q = k / Cin, ci = k - q * Cin;
      int mt = m / F, mf = m - mt * F;
      int ti = mt + (q >> 1) - 1 + pa, fi = mf + (q & 1) - 1 + pb;
      if (ti < 0 || ti >= T || fi < 0 || fi >= F) continue;
      int src = ti * F + fi;
      if (src >= len) continue;
      reg[s] = *reinterpret_cast<const uint4*>(xb + (size_t)src * Cin + ci);
    }
  };
  auto load_b = [&](int kb) -> uint4 {
    int k = kb * IG_BK + (tid >> 3);
    if (k >= K) return make_uint4(0, 0, 0, 0);
    int q = k / Cin, ci = k - q * Cin;
    int kt = pa + 2 * (q >> 1), kf = pb + 2 * (q & 1);
    size_t wrow = (size_t)(kt * 4 + kf) * Cin + ci;
    return *reinterpret_cast<const uint4*>(p.w + wrow * Cout + n0 + (tid & 7) * 8);
  };

  float acc[2][4][4];
  igemm_bf16(acc, tiles, nk, load_a, load_b);
  auto row = [&](int m) {
    int mt = m / F, mf = m - mt * F;
    return (2 * mt + pa) * (2 * F) + 2 * mf + pb;
  };
  store_bias_rows(acc, p, M, 4 * M, m0, n0, b, row);
}

ResampleArgs resample_args(const void* x, const void* w, const float* bias, const int* lens,
                           void* out, int T, int F, int Cin, int Cout) {
  ResampleArgs p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.lens = lens;
  p.out = static_cast<bf16*>(out);
  p.T = T;
  p.F = F;
  p.Cin = Cin;
  p.Cout = Cout;
  return p;
}

}  // namespace

extern "C" {

// K11a: x (B, T*F, Cin) -> out (B, (T/2)*(F/2), Cout); T, F even, Cin % 8 == 0,
// Cout % 64 == 0, w (9*Cin, Cout).
int us_downsample_conv(const void* x, const void* w, const float* bias, const int* lens,
                       void* out, int B, int T, int F, int Cin, int Cout, void* stream) {
  ResampleArgs p = resample_args(x, w, bias, lens, out, T, F, Cin, Cout);
  dim3 grid(us_ceil_div((T / 2) * (F / 2), IG_BM), Cout / IG_BN, B);
  downsample_conv<<<grid, IG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K11b: x (B, T*F, Cin) -> out (B, 2T*2F, Cout); Cin % 8 == 0, Cout % 64 == 0,
// w (16*Cin, Cout) in flax ConvTranspose tap order (kt, kf).
int us_upsample_conv(const void* x, const void* w, const float* bias, const int* lens,
                     void* out, int B, int T, int F, int Cin, int Cout, void* stream) {
  ResampleArgs p = resample_args(x, w, bias, lens, out, T, F, Cin, Cout);
  dim3 grid(us_ceil_div(T * F, IG_BM), Cout / IG_BN, B * 4);
  upsample_conv<<<grid, IG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
