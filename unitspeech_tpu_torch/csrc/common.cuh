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
