// Shared device helpers for the estimator kernels: bf16 tensor-core
// fragments (mma.sync m16n8k16 fed by ldmatrix), the f32 mish used by the
// fused blocks, and deterministic block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define US_DEV __device__ __forceinline__

US_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 0-7, 8-15, 16-23, 24-31 give the row
// addresses of matrices 0..3.
US_DEV void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

US_DEV void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

US_DEV void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a warp tile of MT*16 rows by NT*8 columns (NT even).
// `a` points at the warp's first row at the current k16 column of a
// row-major [rows][lda] bf16 tile; `b` at the current k16 row and the warp's
// first column of a k-major [k][ldb] bf16 tile. Accumulator element
// acc[i][j][e] sits at row i*16 + lane/4 + (e >= 2 ? 8 : 0), column
// j*8 + (lane%4)*2 + (e & 1).
template <int MT, int NT>
US_DEV void warp_mma_k16(float (&acc)[MT][NT][4], const bf16* a, int lda,
                         const bf16* b, int ldb, int lane) {
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldmatrix_x4(af[i], a + (i * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, b + (lane & 15) * ldb + j * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16_16816(acc[i][2 * j], af[i], bf[0], bf[1]);
      mma_bf16_16816(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
    }
  }
}

// The implicit-GEMM main loop of the conv kernels: a 128 x 64 output tile
// per block of 256 threads (8 warps of 32 x 32), two shared-memory stages,
// the next k-block's global loads issued before this one's tensor-core
// math. The caller's functors gather the operands:
//   load_a(kb, uint4 (&)[2]): this thread's two 16-byte chunks of the A
//     tile at k-block kb; chunk s is tile row v / 4, k = (v % 4) * 8 .. +7,
//     with v = threadIdx.x + s * 256;
//   load_b(kb) -> uint4: B is k-major, row threadIdx.x / 8, columns
//     (threadIdx.x % 8) * 8 .. +7.
constexpr int IG_BM = 128, IG_BN = 64, IG_THREADS = 256;
constexpr int IG_BK = 32;              // bf16 k-block
constexpr int IG_AST = IG_BK + 8;      // padded smem row strides (elements):
constexpr int IG_BST = IG_BN + 8;      // ldmatrix without bank conflicts

struct __align__(16) IgemmTiles {
  bf16 a[2][IG_BM * IG_AST];
  bf16 b[2][IG_BK * IG_BST];
};

template <class LoadA, class LoadB>
US_DEV void igemm_bf16(float (&acc)[2][4][4], IgemmTiles& sm, int nk, LoadA& load_a,
                       LoadB& load_b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
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
      int v = tid + s * IG_THREADS;
      *reinterpret_cast<uint4*>(&sm.a[buf][(v >> 2) * IG_AST + (v & 3) * 8]) = areg[s];
    }
    *reinterpret_cast<uint4*>(&sm.b[buf][(tid >> 3) * IG_BST + (tid & 7) * 8]) = breg;
    __syncthreads();
    if (kb + 1 < nk) {
      load_a(kb + 1, areg);
      breg = load_b(kb + 1);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      warp_mma_k16<2, 4>(acc, &sm.a[buf][(wm * 32) * IG_AST + kk * 16], IG_AST,
                         &sm.b[buf][(kk * 16) * IG_BST + wn * 32], IG_BST, lane);
  }
}

// Epilogue of a 128 x 64 tile for the kernels A/B of a ResnetBlock: the
// value v = value(acc, row, column) of each row < M goes to out (bf16), and its
// per-column sum and sum of squares over the tile to
// part[((b * gridDim.x + blockIdx.x) * 2 + {0, 1}) * Cout + column], for
// GroupNorm statistics reduced in a fixed order afterwards. `red` is
// [4][2][IG_BN] floats of shared memory.
template <class Acc, class Value>
US_DEV void store_tile_stats(const Acc (&acc)[2][4][4], Value& value, bf16* out, float* part,
                             float (*red)[2][IG_BN], int M, int Cout, int m0, int n0, int b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
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
        if (m >= M) continue;
        float v0 = value(acc[i][j][2 * h], m, n);
        float v1 = value(acc[i][j][2 * h + 1], m, n + 1);
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * M + m) * Cout + n) =
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
  if (tid < 2 * IG_BN) {
    int st = tid / IG_BN, c = tid % IG_BN;
    float s = red[0][st][c] + red[1][st][c] + red[2][st][c] + red[3][st][c];
    part[(((size_t)b * gridDim.x + blockIdx.x) * 2 + st) * Cout + n0 + c] = s;
  }
}

// mish(x) = x * tanh(softplus(x)) with one exp: tanh(log(1 + e)) =
// ((1+e)^2 - 1) / ((1+e)^2 + 1); (1+e)^2 overflows near x = 44, and the
// factor is 1.0 in f32 for x > 20, so large x passes through.
US_DEV float mish_f32(float x) {
  float e = expf(fminf(x, 30.0f));
  float t = (1.0f + e) * (1.0f + e);
  return x > 20.0f ? x : x * ((t - 1.0f) / (t + 1.0f));
}

US_DEV float bf16_round(float x) { return __bfloat162float(__float2bfloat16(x)); }

// Load 8 consecutive bf16 as floats (16-byte aligned).
US_DEV void load8(const bf16* p, float (&v)[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

US_DEV void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// max that propagates a NaN in either operand, as torch.amax and jnp.max do
US_DEV float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

// int8 quantize as JAX rounds it: clip(round_half_even(v * s), -127, 127),
// the product rounded once (no fused multiply-add)
US_DEV int8_t quant_i8(float v, float s) {
  float r = rintf(__fmul_rn(v, s));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// Max over a block of threads (max_nan); every thread gets the result.
// `scratch` holds blockDim.x floats.
US_DEV float block_max(float v, float* scratch) {
  int tid = threadIdx.x;
  __syncthreads();
  scratch[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) scratch[tid] = max_nan(scratch[tid], scratch[tid + s]);
    __syncthreads();
  }
  float r = scratch[0];
  __syncthreads();
  return r;
}

// Sum over a block of `n` threads in a fixed order (deterministic).
// `scratch` holds n floats; every thread gets the total.
US_DEV float block_sum(float v, float* scratch) {
  int tid = threadIdx.x;
  int n = blockDim.x;
  __syncthreads();
  scratch[tid] = v;
  __syncthreads();
  for (int s = n / 2; s > 0; s >>= 1) {
    if (tid < s) scratch[tid] += scratch[tid + s];
    __syncthreads();
  }
  float r = scratch[0];
  __syncthreads();
  return r;
}

static inline int us_ceil_div(int a, int b) { return (a + b - 1) / b; }

// The current device's SMs (the launch plans size their grids by them).
static inline int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Programmatic dependent launch (K4's launches, K9's chain): a kernel
// launched with launch_pdl may start while the kernel before it in the
// stream drains, and waits in griddep_wait, before it reads or writes
// anything, until that kernel has finished and its writes are visible;
// griddep_launch lets the next such kernel start once every block of this
// one has started. Launched the usual way, both are no-ops.
US_DEV void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
US_DEV void griddep_launch() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

template <typename... KArgs, typename... Args>
static inline int launch_pdl(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}
