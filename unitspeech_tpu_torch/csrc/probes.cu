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
// read and written once; 4 MB of f32 at the tool's defaults), and within
// them the issue slots: a multiply and an add that must not contract take
// two where one FMA would do both, and the accurate bodies are sequences of
// a few tens of instructions (tools/bench_transcendental.py counts them in
// the SASS). Each round depends on the last, so a thread carries four
// independent elements (one float4 load and store), their chains
// interleaved in the round loop (unrolled by P1_UNROLL) so that one
// element's latency can hide behind another's; the grid is one full wave
// (the SMs times the blocks an SM holds, no tail wave), grid-striding over
// float4s, and the n % 4 elements past the last float4 take one thread each
// in block 0. (Measured: one element a thread in two waves was already
// issue-bound, at 74-100% of the SASS's issue-slot least time, so this form
// gains 2%: PERF.md.)
//
// P2 replaces the Pallas kernels of tools/probe_stride.py (run_case,
// pallas_call :42), which asked which row-subsample forms Mosaic lowers:
//   row_select      out row r = x row (r / keep) * period + r % keep: the
//                   strided getitem, lax.slice and sublane-reshape forms
//                   (period 2, keep 1) and the frame-block select (period
//                   2F, keep F) are all this one gather;
//   selection_band  S @ x with S[i, 2i] = 1 of shape (R/2, R) (k_selmat), a
//                   0/1 product on the tensor cores, below;
//   interleave_rows out row 2i = x row i, row 2i + 1 = bf16(x row i + 1).
// Rows are bf16 and C % 8 == 0 (16-byte pieces).
// What bounds them: bytes (each reads x once and writes its rows once; the
// product's 2 * R/2 * R * C operations sit far under the tensor-core rate),
// and at the tool's (512, 128) the launch: the product's 192 KB take 0.06 us
// at 3.35 TB/s, and an empty kernel takes about 5 us. row_select and
// interleave_rows are one grid-stride pass of 16-byte copies at that floor.
//
// The selection product, band form: output rows [m0, m0 + 64) have their
// ones in x rows [2 m0, 2 m0 + 128), so a warpgroup takes only that band.
// A block owns a column strip of 8 (one 16-byte piece a row) and all R
// rows, one thread a row: each loads its row's piece and stores it to
// shared memory (R x 16 bytes; each 8 rows a contiguous 128-byte core
// matrix, no swizzle; a proxy fence makes the stores visible to wgmma),
// and warpgroup g runs eight wgmma m64n8k16 over band g, with S made in
// registers as the A fragment (lane l of warp w holds row 16 w + l / 4
// (+ 8) and columns 2 (l % 4) (+ 8) of each k16 step: a one where column
// == 2 row) and the band as an MN-major B (its rows are k, 8 contiguous n
// each). The sum is
// f32 from zero, so each output is x[2i] exactly (1 * x + 0s), and the
// band's other rows reach it as 0 * x: an inf or NaN there gives NaN, as
// the full product does. Rows outside the band are skipped, so the
// non-finite rule is kept by a count: the block holds every row of its
// columns, counts each column's non-finite values once (from each thread's
// piece), and an output is NaN where its column has one in a row other than
// its own x[2i]. x is read once; no block needs another's rows. Grid C / 8
// blocks of R threads (R / 128 warpgroups). Measured and dropped (PERF.md):
// a cluster of four 64-column blocks a strip that added the others' counts
// through distributed shared memory, and a TMA copy of each band (an
// mbarrier and one issuing thread ahead of the products: slower at this
// size than the threads' own loads).
#include <algorithm>

#include "hopper.cuh"

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

constexpr int P1_UNROLL = 4;  // rounds a trip of the round loop

template <int BODY>
US_DEV float chain_round(float acc, float x) {
  return __fadd_rn(__fmul_rn(body<BODY>(acc), 0.5f), x);
}

template <int BODY>
__global__ void __launch_bounds__(256) chain(const float* x, float* out, int n, int k) {
  const int n4 = n / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + i);
    float a0 = xv.x, a1 = xv.y, a2 = xv.z, a3 = xv.w;
    int r = 0;
#pragma unroll 1
    for (; r + P1_UNROLL <= k; r += P1_UNROLL) {
#pragma unroll
      for (int u = 0; u < P1_UNROLL; ++u) {
        a0 = chain_round<BODY>(a0, xv.x);
        a1 = chain_round<BODY>(a1, xv.y);
        a2 = chain_round<BODY>(a2, xv.z);
        a3 = chain_round<BODY>(a3, xv.w);
      }
    }
    for (; r < k; ++r) {
      a0 = chain_round<BODY>(a0, xv.x);
      a1 = chain_round<BODY>(a1, xv.y);
      a2 = chain_round<BODY>(a2, xv.z);
      a3 = chain_round<BODY>(a3, xv.w);
    }
    reinterpret_cast<float4*>(out)[i] = make_float4(a0, a1, a2, a3);
  }
  const int i = n4 * 4 + threadIdx.x;  // the tail
  if (blockIdx.x == 0 && i < n) {
    const float xv = x[i];
    float acc = xv;
    for (int r = 0; r < k; ++r) acc = chain_round<BODY>(acc, xv);
    out[i] = acc;
  }
}

// One full wave of chain<BODY> blocks of 256 threads for n elements (n / 4
// float4s), at least one block.
template <int BODY>
int launch_chain(const float* x, float* out, int n, int k, cudaStream_t st) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain<BODY>, 256, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = std::max(1, std::min(n_sms() * per_sm, us_ceil_div(n / 4, 256)));
  chain<BODY><<<blocks, 256, 0, st>>>(x, out, n, k);
  return (int)cudaGetLastError();
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

constexpr int SEL_COLS = 8;          // columns of a block: one 16-byte piece a row
constexpr int SEL_BM = 64;           // output rows of a warpgroup: wgmma's M
constexpr int SEL_BAND = 2 * SEL_BM; // the x rows they reach
constexpr int SEL_MAX_ROWS = 1024;   // R threads a block

// D (64 x 8 f32) += A (64 x 16 bf16, registers, as hopper.cuh WgmmaRS) * B
// (16 x 8 bf16 in shared memory, MN-major: 16 rows of 8 n values, two
// 128-byte core matrices, no swizzle). The last immediate transposes B.
US_DEV void wgmma_n8_mn(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Descriptor of that B: no swizzle, core matrices (8 rows of 16 bytes,
// 128 bytes) one after another along k; both byte offsets 128, so the k
// step between them is 128 bytes whichever field the MN-major form reads
// (the n direction has one core matrix). 16 rows on is 16 added.
US_DEV uint64_t wgmma_desc_mn8(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (8ull << 16) | (8ull << 32);
}

// The non-finite bf16 values of a 32-bit pair (exponent all ones), low and high.
US_DEV int bad_lo(uint32_t w) { return (w & 0x7F80u) == 0x7F80u; }
US_DEV int bad_hi(uint32_t w) { return (w & 0x7F800000u) == 0x7F800000u; }

// out (R/2, C) = S x for the block's 8 columns; see the header. R threads.
__global__ void __launch_bounds__(SEL_MAX_ROWS) selection_band(const bf16* x, bf16* out,
                                                               int C) {
  __shared__ __align__(128) uint8_t strip[SEL_MAX_ROWS * 16];  // row r at 16 r
  __shared__ int bad[SEL_COLS];  // the strip's non-finite values per column
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int c0 = blockIdx.x * SEL_COLS;
  const uint4 mine = __ldg(reinterpret_cast<const uint4*>(x + (size_t)tid * C + c0));
  *reinterpret_cast<uint4*>(strip + tid * 16) = mine;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  if (tid < SEL_COLS) bad[tid] = 0;
  // S's fragments: k16 step j, register i
  uint32_t a[SEL_BAND / 16][4];
#pragma unroll
  for (int j = 0; j < SEL_BAND / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * warp + (lane >> 2) + 8 * (i & 1);
      const int col = 16 * j + 2 * (lane & 3) + 8 * (i >> 1);
      a[j][i] = col == 2 * row ? 0x3F80u : 0u;  // bf16 1.0 in the low (even) column
    }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();
  wgmma_fence_acc(acc);
  wgmma_fence();
  const uint64_t desc = wgmma_desc_mn8(strip + wg * SEL_BAND * 16);
#pragma unroll
  for (int j = 0; j < SEL_BAND / 16; ++j) wgmma_n8_mn(acc, a[j], desc + 16 * j);
  wgmma_commit();
  {  // the count while the products run: thread t holds row t
    const uint32_t w[4] = {mine.x, mine.y, mine.z, mine.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (bad_lo(w[q])) atomicAdd(&bad[2 * q], 1);
      if (bad_hi(w[q])) atomicAdd(&bad[2 * q + 1], 1);
    }
  }
  wgmma_wait<0>();
  wgmma_fence_acc(acc);
  __syncthreads();
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * SEL_BM + 16 * warp + (lane >> 2) + 8 * h;
    // NaN where the column has a non-finite value besides x[2m]'s own
    const uint32_t own = *reinterpret_cast<const uint32_t*>(strip + 2 * m * 16 + col * 2);
    const float qnan = __int_as_float(0x7FC00000);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * C + c0 + col) =
        __floats2bfloat162_rn(bad[col] > bad_lo(own) ? qnan : acc[2 * h],
                              bad[col + 1] > bad_hi(own) ? qnan : acc[2 * h + 1]);
  }
}

int grid_for(size_t items) {
  size_t blocks = (items + 255) / 256;
  return (int)(blocks > 65535 ? 65535 : blocks);
}

}  // namespace

extern "C" {

// P1: out = k rounds of acc = body(acc) * 0.5 + x over n f32 elements (x
// and out 16-byte aligned); body in Body's order (mul, jnp_sin, fast_sin,
// jnp_exp, fast_exp, jnp_tanh, div, rsqrt).
int us_transcendental_chain(const float* x, float* out, int n, int k, int body_id,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body_id) {
    case MUL: return launch_chain<MUL>(x, out, n, k, st);
    case JNP_SIN: return launch_chain<JNP_SIN>(x, out, n, k, st);
    case FAST_SIN: return launch_chain<FAST_SIN>(x, out, n, k, st);
    case JNP_EXP: return launch_chain<JNP_EXP>(x, out, n, k, st);
    case FAST_EXP: return launch_chain<FAST_EXP>(x, out, n, k, st);
    case JNP_TANH: return launch_chain<JNP_TANH>(x, out, n, k, st);
    case DIV: return launch_chain<DIV>(x, out, n, k, st);
    case RSQRT: return launch_chain<RSQRT>(x, out, n, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// P2: out (R/2, C) = S @ x, S[i, 2i] = 1, the band form on the tensor
// cores. C % 8 == 0, R % 128 == 0, R <= 1024.
int us_selection_matmul(const void* x, void* out, int R, int C, void* stream) {
  if (C % SEL_COLS || R % SEL_BAND || R > SEL_MAX_ROWS || R <= 0)
    return (int)cudaErrorInvalidValue;
  selection_band<<<C / SEL_COLS, R, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), C);
  return (int)cudaGetLastError();
}

}  // extern "C"
