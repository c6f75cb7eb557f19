// The kernels of two measurement tools (P1 and P2).
//
// P1 replaces the Pallas kernel of tools/bench_transcendental.py (make_fn,
// pallas_call :41): K rounds of acc = body(acc) * 0.5 + x over a (rows, 128)
// f32 array, one kernel per body (a template over the body). The accurate
// bodies use CUDA's sinf / expf / tanhf and the f32 division; rsqrt is
// rsqrtf (within 2 ulp); fast_sin and fast_exp are the polynomials of
// unitspeech_tpu_torch/ops/fastmath.py operation by operation, the exponent
// of fast_exp built as __int_as_float((n + 127) << 23). Every multiply and
// add rounds on its own (__fmul_rn, __fadd_rn): nvcc would otherwise
// contract body * 0.5 + x into one fused multiply-add, which PyTorch does
// not. What bounds it: the operations (k rounds of the body per element
// read and written once; 4 MB of f32 at the tool's defaults); one thread
// per element, a grid-stride loop.
//
// P2 replaces the Pallas kernels of tools/probe_stride.py (run_case,
// pallas_call :42), which asked which row-subsample forms Mosaic lowers:
//   row_select      out row r = x row (r / keep) * period + r % keep: the
//                   strided getitem, lax.slice and sublane-reshape forms
//                   (period 2, keep 1) and the frame-block select (period
//                   2F, keep F) are all this one gather;
//   selection_mm    S @ x with S[i, 2i] = 1 of shape (R/2, R), a 0/1 product
//                   on the tensor cores (mma.sync, f32 accumulate: exact),
//                   S made in the A-operand loader;
//   interleave_rows out row 2i = x row i, row 2i + 1 = bf16(x row i + 1).
// Rows are bf16 and C % 8 == 0 (16-byte loads; the product needs C % 64).
// What bounds them: bytes (each reads x once and writes its rows once; the
// product's 2 * R/2 * R * C operations sit far under the tensor-core rate).
#include "common.cuh"

namespace {

enum Body { MUL, JNP_SIN, FAST_SIN, JNP_EXP, FAST_EXP, JNP_TANH, DIV, RSQRT };

// fast_sin (ops/fastmath.py): r = x - round(x / pi) * pi, odd degree-7
US_DEV float fast_sin(float x) {
  float n = rintf(__fmul_rn(x, 0.3183098861837907f));
  float r = __fsub_rn(x, __fmul_rn(n, 3.141592653589793f));
  float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(-0.16665168f, __fmul_rn(r2, __fadd_rn(8.3095146e-3f,
                                                                 __fmul_rn(r2, -1.8447153e-4f))));
  p = __fadd_rn(0.99999749f, __fmul_rn(r2, p));
  return __fmul_rn(r, p);
}

// fast_exp (ops/fastmath.py): 2^round(z) from the exponent field times a
// degree-5 polynomial of the fraction, z = clip(x, -87, 30) * log2(e)
US_DEV float fast_exp(float x) {
  float z = __fmul_rn(fminf(fmaxf(x, -87.f), 30.f), 1.4426950408889634f);
  float n = rintf(z);
  float f = __fsub_rn(z, n);
  float p = __fadd_rn(0.00967077f, __fmul_rn(f, 0.00133953f));
  p = __fadd_rn(0.05550341f, __fmul_rn(f, p));
  p = __fadd_rn(0.24022211f, __fmul_rn(f, p));
  p = __fadd_rn(0.69314718f, __fmul_rn(f, p));
  p = __fadd_rn(1.f, __fmul_rn(f, p));
  return __fmul_rn(p, __int_as_float(((int)n + 127) << 23));
}

template <int BODY>
US_DEV float body(float x) {
  switch (BODY) {
    case MUL: return __fmul_rn(x, 1.1f);
    case JNP_SIN: return sinf(x);
    case FAST_SIN: return fast_sin(x);
    case JNP_EXP: return expf(fminf(x, 8.f));
    case FAST_EXP: return fast_exp(fminf(x, 8.f));
    case JNP_TANH: return tanhf(x);
    case DIV: return __fdiv_rn(1.3f, __fadd_rn(fabsf(x), 1.f));
    default: return rsqrtf(__fadd_rn(fabsf(x), 1.f));
  }
}

template <int BODY>
__global__ void __launch_bounds__(256) chain(const float* x, float* out, int n, int k) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float xv = x[i];
    float acc = xv;
    for (int r = 0; r < k; ++r) acc = __fadd_rn(__fmul_rn(body<BODY>(acc), 0.5f), xv);
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(256) row_select(const bf16* x, bf16* out, int rows_out, int C,
                                                  int period, int keep) {
  const int cv = C / 8;
  const size_t nvec = (size_t)rows_out * cv;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    int r = (int)(v / cv), c = (int)(v % cv) * 8;
    int src = (r / keep) * period + r % keep;
    *reinterpret_cast<uint4*>(out + (size_t)r * C + c) =
        *reinterpret_cast<const uint4*>(x + (size_t)src * C + c);
  }
}

__global__ void __launch_bounds__(256) interleave_rows(const bf16* x, bf16* out, int R, int C) {
  const int cv = C / 8;
  const size_t nvec = (size_t)R * cv;
  for (size_t v = blockIdx.x * (size_t)blockDim.x + threadIdx.x; v < nvec;
       v += (size_t)gridDim.x * blockDim.x) {
    int r = (int)(v / cv), c = (int)(v % cv) * 8;
    const bf16* src = x + (size_t)(r / 2) * C + c;
    bf16* dst = out + (size_t)r * C + c;
    if (r % 2 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      float vals[8];
      load8(src, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __fadd_rn(vals[e], 1.f);
      store8(dst, vals);
    }
  }
}

// (R/2, R) selection matrix times x (R, C): the shared 128 x 64 implicit
// GEMM loop of common.cuh with S generated in the A loader.
__global__ void __launch_bounds__(IG_THREADS) selection_mm(const bf16* x, bf16* out, int R,
                                                           int C) {
  __shared__ IgemmTiles tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * IG_BM, n0 = blockIdx.y * IG_BN;
  const int M = R / 2;
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  auto load_a = [&](int kb, uint4 (&reg)[2]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int v = tid + s * IG_THREADS;
      int m = m0 + (v >> 2);
      int k = kb * IG_BK + (v & 3) * 8;
      bf16* r = reinterpret_cast<bf16*>(&reg[s]);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = (m < M && k + e == 2 * m) ? one : zero;
    }
  };
  auto load_b = [&](int kb) -> uint4 {
    int k = kb * IG_BK + (tid >> 3);
    if (k >= R) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(x + (size_t)k * C + n0 + (tid & 7) * 8);
  };
  float acc[2][4][4];
  igemm_bf16(acc, tiles, (R + IG_BK - 1) / IG_BK, load_a, load_b);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m = m0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
        int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
        if (m >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * C + n) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

int grid_for(size_t items) {
  size_t blocks = (items + 255) / 256;
  return (int)(blocks > 65535 ? 65535 : blocks);
}

}  // namespace

extern "C" {

// P1: out = k rounds of acc = body(acc) * 0.5 + x over n f32 elements;
// body in Body's order (mul, jnp_sin, fast_sin, jnp_exp, fast_exp,
// jnp_tanh, div, rsqrt).
int us_transcendental_chain(const float* x, float* out, int n, int k, int body_id,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = grid_for(n);
  switch (body_id) {
    case MUL: chain<MUL><<<g, 256, 0, st>>>(x, out, n, k); break;
    case JNP_SIN: chain<JNP_SIN><<<g, 256, 0, st>>>(x, out, n, k); break;
    case FAST_SIN: chain<FAST_SIN><<<g, 256, 0, st>>>(x, out, n, k); break;
    case JNP_EXP: chain<JNP_EXP><<<g, 256, 0, st>>>(x, out, n, k); break;
    case FAST_EXP: chain<FAST_EXP><<<g, 256, 0, st>>>(x, out, n, k); break;
    case JNP_TANH: chain<JNP_TANH><<<g, 256, 0, st>>>(x, out, n, k); break;
    case DIV: chain<DIV><<<g, 256, 0, st>>>(x, out, n, k); break;
    case RSQRT: chain<RSQRT><<<g, 256, 0, st>>>(x, out, n, k); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// P2: out (rows_out, C) = the first `keep` rows of every `period` rows of x.
int us_row_select(const void* x, void* out, int rows_out, int C, int period, int keep,
                  void* stream) {
  row_select<<<grid_for((size_t)rows_out * C / 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows_out, C, period, keep);
  return (int)cudaGetLastError();
}

// P2: out (R, C): rows 2i = x[i], 2i + 1 = bf16(x[i] + 1), i < R / 2.
int us_interleave_rows(const void* x, void* out, int R, int C, void* stream) {
  interleave_rows<<<grid_for((size_t)R * C / 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), R, C);
  return (int)cudaGetLastError();
}

// P2: out (R/2, C) = S @ x, S[i, 2i] = 1, on the tensor cores. C % 64 == 0.
int us_selection_matmul(const void* x, void* out, int R, int C, void* stream) {
  selection_mm<<<dim3(us_ceil_div(R / 2, IG_BM), C / IG_BN), IG_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(x),
                                                      static_cast<bf16*>(out), R, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
