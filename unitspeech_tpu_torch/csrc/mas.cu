// M1: monotonic alignment search (the STEP1 training step's Viterbi path;
// counterpart of unitspeech_tpu/ops/mas.py `maximum_path`, a lax.scan in
// the JAX package, no Pallas kernel). Plain version and semantics:
// unitspeech_tpu_torch/ops/mas.py `maximum_path_plain`, which this kernel
// equals bit for bit: the same f32 multiply, max and add in the same order
// (__fmul_rn / __fadd_rn, so nothing contracts into an FMA).
//
// One thread block per batch row, threads over tokens. The running value
// row lives in shared memory, double-buffered across frames, with one
// barrier per frame; frame y's decisions (advance >= stay) go to a
// (B, Ty, Tx) byte scratch buffer. After the last active frame one thread
// walks the decisions back from (t_x - 1, t_y - 1) and writes the path
// into the output, which the block zero-filled first. Lengths come from
// the mask (its first frame summed over tokens, its first token over
// frames; a 0/1 mask sums exactly), each at least 1. Frames past t_y are
// not visited: their rows are frozen and their decisions unread.
//
// What bounds it: the frames are serial (one barrier each), and the walk
// back is one thread's chain of dependent loads, so a row costs about
// Ty barriers plus Ty L2 round trips, whatever the width; B rows fill B
// of the card's SMs. A simple design first; not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float masked_lp(const float* lp, const float* m, size_t i) {
  return __fmul_rn(lp[i], m[i]);
}

__global__ void mas_kernel(const float* __restrict__ log_prior, const float* __restrict__ mask,
                           float* __restrict__ path, uint8_t* __restrict__ decisions, int Tx,
                           int Ty) {
  extern __shared__ float value[];  // [2][Tx]
  __shared__ float lens[2];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = (size_t)blockIdx.x * Tx * Ty;
  const float* lp = log_prior + base;
  const float* m = mask + base;
  float* out = path + base;
  uint8_t* dec = decisions + (size_t)blockIdx.x * Ty * Tx;

  if (tid == 0) lens[0] = lens[1] = 0.f;
  __syncthreads();
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += nt) sx += m[(size_t)x * Ty];
  for (int y = tid; y < Ty; y += nt) sy += m[y];
  atomicAdd(&lens[0], sx);
  atomicAdd(&lens[1], sy);
  for (size_t i = tid; i < (size_t)Tx * Ty; i += nt) out[i] = 0.f;
  for (int x = tid; x < Tx; x += nt) value[x] = x == 0 ? masked_lp(lp, m, 0) : kNegInf;
  __syncthreads();
  const int x_len = max((int)lens[0], 1), y_len = max((int)lens[1], 1);

  for (int y = 0; y < y_len; ++y) {
    const float* cur = value + (y & 1) * Tx;
    float* nxt = value + ((y + 1) & 1) * Tx;
    for (int x = tid; x < Tx; x += nt) {
      const float stay = cur[x];
      const float adv = x > 0 ? cur[x - 1] : kNegInf;
      dec[(size_t)y * Tx + x] = adv >= stay;
      float best = adv >= stay ? adv : stay;
      if (adv != adv) best = adv;  // a NaN propagates, as torch.maximum
      nxt[x] = y > 0 ? __fadd_rn(masked_lp(lp, m, (size_t)x * Ty + y), best) : stay;
    }
    __syncthreads();
  }

  if (tid == 0) {
    int index = x_len - 1;
    for (int y = y_len - 1; y >= 0; --y) {
      const size_t at = (size_t)index * Ty + y;
      out[at] = m[at];  // 1 x mask
      const bool d = dec[(size_t)y * Tx + index] != 0;
      if (index > 0 && (index == y || d)) --index;
    }
  }
}

}  // namespace

extern "C" {

// log_prior, mask: (B, Tx, Ty) f32 (mask 0/1); path: (B, Tx, Ty) f32 out;
// decisions: (B, Ty, Tx) bytes of scratch. 0 or a CUDA error code.
int us_maximum_path(const float* log_prior, const float* mask, float* path,
                    uint8_t* decisions, int B, int Tx, int Ty, void* stream) {
  if (B < 1 || Tx < 1 || Ty < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)Tx * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = Tx >= kMaxThreads ? kMaxThreads : (Tx + 31) / 32 * 32;
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(log_prior, mask, path,
                                                                     decisions, Tx, Ty);
  return (int)cudaGetLastError();
}

}  // extern "C"
