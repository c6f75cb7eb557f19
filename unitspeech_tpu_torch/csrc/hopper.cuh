// Hopper (sm_90a) building blocks for the port's kernels: mbarriers, bulk
// copies (cp.async.bulk, the TMA engine's non-tensor form), 4-D tensor
// copies (TMA) of channels-last activations, warpgroup products (wgmma)
// with A from registers and B from shared memory through a descriptor (bf16,
// and s8 into s32 for K9's int8 convs), and the box + weight-ring pipeline
// that the conv kernels (csrc/resample.cu, csrc/resnet_block.cu) build on:
//   * per chunk of one 128-byte row of channels (64 bf16, 128 int8), one
//     TMA copy brings the input box that a 2-D row tile's taps reach, in
//     the 128-byte swizzle (16-byte piece j of box row R at piece j ^ (R %
//     8)), zero outside the tensor;
//   * one producer warp streams the weights, packed once at load into
//     K-major tiles of BN rows of 128 bytes in the same swizzle, through a
//     ring of stages under full/empty mbarriers;
//   * the consumers load A fragments from the box with ldmatrix (the row
//     addresses carry the tap's shift; a lane whose row has no input reads
//     a zero row) and run wgmma m64nBNk16 (bf16) or m64nBNk32 (s8) with B
//     by descriptor.
#pragma once

#include <cuda.h>  // CUtensorMap (the type only: the library links the CUDA runtime alone)

#include "common.cuh"

// --- mbarriers -------------------------------------------------------------

US_DEV void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (bulk copies).
US_DEV void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

US_DEV void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
US_DEV void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a pipeline fault) traps after about two seconds instead of hanging
// the card.
US_DEV void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// --- bulk copies -----------------------------------------------------------

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory; completion adds to `bar`'s transaction count.
US_DEV void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A tiled tensor copy (TMA) of the box at coordinates (c0, c1, c2, c3),
// innermost first, of the 4-D tensor `map` describes; coordinates outside
// the tensor read as zero. `map` is a __grid_constant__ kernel parameter.
US_DEV void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// --- warpgroup products ----------------------------------------------------

US_DEV void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
US_DEV void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
US_DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous product.
template <int R>
US_DEV void wgmma_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major bf16 B tile in the 128-byte swizzle: rows of 64
// k values (128 bytes, 16-byte chunk j of row r stored at chunk j ^ (r % 8)),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned. Adding 2 to the
// descriptor moves it 16 k values (32 bytes) on.
US_DEV uint64_t wgmma_desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x N f32, the warpgroup's accumulator fragment) += A (64 x 16 bf16,
// one ldmatrix.x4 fragment per warp: warp w holds rows 16 w .. 16 w + 15 as
// mma.sync's m16n8k16 A) * B (16 x N, K-major in shared memory). Fragment
// element d[j * 4 + e] of lane l in warp w is row 16 w + l / 4 + 8 (e / 2),
// column 8 j + 2 (l % 4) + e % 2.
template <int N>
struct WgmmaRS;

#define F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <> struct WgmmaRS<32> {
  static US_DEV void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : F8(0), F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  static US_DEV void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct WgmmaRS<128> {
  static US_DEV void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct WgmmaRS<256> {
  static US_DEV void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
#undef F8

// The int8 form (K9's convs): D (64 x N s32) += A (64 x 32 s8 from registers:
// warp w holds rows 16 w .. 16 w + 15 as mma.sync's m16n8k32 A, which is
// one ldmatrix.x4 of 16-byte row pieces, as for bf16) * B (32 x N s8,
// K-major in shared memory: a 128-byte row is 128 k values, so the
// descriptor moves 32 k values per 2 as it moves 16 bf16 ones). Exact.
template <int N>
struct WgmmaRS8;

#define R8(i)                                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

template <> struct WgmmaRS8<64> {
  static US_DEV void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : R8(0), R8(8), R8(16), R8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct WgmmaRS8<128> {
  static US_DEV void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
#undef R8

template <int R>
US_DEV void wgmma_fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// --- the box + weight-ring pipeline ------------------------------------------

constexpr int KC = 64;               // channels per chunk: one 128-byte row of a tile
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may ask for
constexpr int SMEM_PER_SM = 233472;  // the SM's 228 KB

US_DEV void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

US_DEV void bar_sync_named(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The dynamic shared memory, 1024-byte aligned (the swizzled tiles' base).
US_DEV uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// Half of one 64-channel chunk at one tap: the A fragments of k16 steps
// kk0 and kk0 + 1 from box row `row` (128 bytes in the 128-byte swizzle:
// 16-byte chunk j of row R at j ^ (R % 8); rx = R % 8), this lane's k half
// `hi`. A lane whose row has no input reads the zero row (rx = 0). Channels
// past Cin read as zero (the copy fills them) and meet zero weight rows, so
// every chunk takes all four steps.
US_DEV void load_half(uint32_t (&a)[2][4], uint32_t row, uint32_t rx, uint32_t hi, int kk0) {
#pragma unroll
  for (int j = 0; j < 2; ++j) ldsm_x4(a[j], row + ((((2 * (kk0 + j) + hi) ^ rx) & 7) << 4));
}

// Their two products on the warpgroup's accumulator, committed as a group.
template <int BN>
US_DEV void mma_half(float (&acc)[BN / 2], const uint32_t (&a)[2][4], uint64_t desc, int kk0) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) WgmmaRS<BN>::mma(acc, a[j], desc + 2 * (kk0 + j));
  wgmma_commit();
}

// The same on int8 operands (two k32 steps of a 128-channel chunk).
template <int BN>
US_DEV void mma_half(int (&acc)[BN / 2], const uint32_t (&a)[2][4], uint64_t desc, int kk0) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 2; ++j) WgmmaRS8<BN>::mma(acc, a[j], desc + 2 * (kk0 + j));
  wgmma_commit();
}

// Lane 0 of each consumer warp arrives once the warp is done with a slot.
US_DEV void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The producer warp: for each of n_chunks chunks, n_stages weight stages of
// stage_bytes (src_stride bytes apart from wsrc on) into a ring of n_ring
// slots, and one input box (a TMA copy of the chunk's chunk_ch channels,
// 128 bytes: 64 bf16 or 128 int8, at
// frequencies fi0 .., frames ti0 .., batch element bz; box_tx bytes) into nb
// slots of box_bytes. With three slots or more the next chunk's box goes out
// before a chunk's first stage, a whole chunk ahead of its use; with fewer a
// chunk's box goes out before its stage `box_at`, so that its first weight
// stages are in flight while the previous chunk ends (PERF.md: the third
// slot is worth it where it costs no blocks an SM). A box of one frequency
// may come as `pieces` copies of piece_rows frames (128-byte rows), each
// at most the 256 rows of a TMA box.
US_DEV void produce_ring(const CUtensorMap* xmap, uint8_t* ring, uint8_t* box, uint64_t* w_full,
                         uint64_t* w_empty, uint64_t* x_full, uint64_t* x_empty, int n_ring,
                         int n_stages, int stage_bytes, int src_stride, int nb, int box_bytes,
                         int box_tx, int n_chunks, const void* wsrc, int fi0, int ti0, int bz,
                         int chunk_ch = KC, int pieces = 1, int piece_rows = 0) {
  const int lane = threadIdx.x & 31;
  const int box_at = min(n_ring - 1, n_stages - 1);
  const bool lead = nb >= 3;
  int ws = 0, xs = 0;
  uint32_t wph = 0, xph = 0;
  auto issue_box = [&](int c) {
    mbar_wait(&x_empty[xs], xph ^ 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(&x_full[xs], box_tx);
      for (int i = 0; i < pieces; ++i)
        tma_load_4d(box + xs * box_bytes + i * piece_rows * 128, xmap, c * chunk_ch, fi0,
                    ti0 + i * piece_rows, bz, &x_full[xs]);
    }
    __syncwarp();
    if (++xs == nb) xs = 0, xph ^= 1;
  };
  if (lead) issue_box(0);
  for (int c = 0; c < n_chunks; ++c) {
    for (int s = 0; s < n_stages; ++s) {
      if (lead ? s == 0 && c + 1 < n_chunks : s == box_at) issue_box(lead ? c + 1 : c);
      mbar_wait(&w_empty[ws], wph ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&w_full[ws], stage_bytes);
        bulk_g2s(ring + ws * stage_bytes,
                 reinterpret_cast<const uint8_t*>(wsrc) + (size_t)(c * n_stages + s) * src_stride,
                 stage_bytes, &w_full[ws]);
      }
      __syncwarp();
      if (++ws == n_ring) ws = 0, wph ^= 1;
    }
  }
}

// --- tensor maps (host side) ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links the CUDA runtime alone).
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// x (B, T, F, C) bf16 (int8 with i8), channels last, as a 4-D tensor map
// with box (one 128-byte row of channels: 64 bf16 or 128 int8, box_f
// frequencies, box_t frames, 1) in the 128-byte swizzle; rows of 16-byte
// multiples (C % 8 == 0, int8 C % 16 == 0). Returns 0 on success.
static inline int x_tensor_map(CUtensorMap* map, const void* x, int B, int T, int F, int C,
                               int box_t, int box_f, bool i8 = false) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t es = i8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)F, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * es, (cuuint64_t)F * C * es,
                                 (cuuint64_t)T * F * C * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), (cuuint32_t)box_f, (cuuint32_t)box_t, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(x), dims, strides,
                   box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

static inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
