// Tensor-core pieces of the bf16 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): warpgroup wgmma m64nNk16 bf16 -> fp32 with shared-memory
// descriptors, cp.async or TMA (with mbarriers) into 128B-swizzled tiles,
// setmaxnreg, and the hi/lo split of fp32 operands.
//
// Register layouts (PTX ISA, g = lane / 4, t = lane % 4): a warp's part of a
// wgmma accumulator is that of mma.m16n8k16 over its 16 rows, n tile j (8
// columns) in registers 4 j .. 4 j + 3: c0, c1 (row g, cols 2t, 2t+1), c2, c3
// (row g+8). An A operand from registers takes the m16n8k16 A layout, four
// 32-bit registers of two bf16 each: a0 (row g, cols 2t, 2t+1), a1 (row g+8,
// same cols), a2 (row g, cols 8+2t, 9+2t), a3 (row g+8, cols 8+2t, 9+2t).
// So the accumulators of two neighbouring n tiles (16 columns) are, packed
// two by two, the A operand of a product over those 16 columns: that is how
// P (and dS) go from one product into the next without leaving registers.
//
// Precision rule: the tensor cores take bf16 operands. Q, K, V and dO are
// bf16 inputs already. P and dS are fp32; rounding them to bf16 once before a
// product fails the kernel-vs-plain check of chip_smoke.py at GPT-2 medium's
// shapes, so each goes in as two bf16 parts, hi = bf16(x) and lo = bf16(x -
// hi), and both products are summed into the fp32 accumulator (hi + lo keeps
// ~16 bits of x). Every accumulator is fp32. Built with
// -DHVD_FLASH_ONE_ROUNDING, lo is 0: chip_smoke.py builds that variant as a
// planted fault its check must catch, and tests/test_torch_port_precision.py
// pins the rule on the CPU.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no -lcuda

#include "flash_common.cuh"

namespace hvdflash {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; writes 16 zero bytes instead
// when !valid (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x0, x1), lo = bf16(x - hi), each packed with x0 in the low half.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf162_bits(h);
#ifdef HVD_FLASH_ONE_ROUNDING
  lo = 0u;
#else
  const float2 hf = __bfloat1622float2(h);
  lo = bf162_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
#endif
}

// The hi and lo A fragments of the 16 x 16 block held by accumulator tiles
// c (columns 0-7) and c8 (columns 8-15).
__device__ __forceinline__ void acc_to_a_split(const float (&c)[4],
                                               const float (&c8)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_bf16(c[0], c[1], hi[0], lo[0]);
  split_bf16(c[2], c[3], hi[1], lo[1]);
  split_bf16(c8[0], c8[1], hi[2], lo[2]);
  split_bf16(c8[2], c8[3], hi[3], lo[3]);
}

// Sum over the four lanes of a quad (the lanes that share a C row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Whether the pair of q tile [q0, q0 + bq) and k tile [k0, k0 + bk) has any
// masked entry: a bias or segment ids, a ragged edge, or the causal
// diagonal. The other tile pairs need no masking work at all.
__device__ __forceinline__ bool tile_has_mask(const FlashArgs& a, int q0,
                                              int bq, int k0, int bk) {
  return a.bias != nullptr || a.seg != nullptr || k0 + bk > a.tk ||
         q0 + bq > a.tq || (a.causal && k0 + bk - 1 > q0 + a.offset);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the special-function unit, one instruction (relative error ~2^-22;
// results below the normal range flush to 0, as exp of a masked score must).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------- warpgroup products (wgmma)
//
// wgmma.mma_async m64nNk16: the four warps of a block issue one product of a
// 64-row tile together (warp w: rows 16 w .. 16 w + 15). B (and A, when not
// in registers) is read from shared memory through a 64-bit descriptor.
// Tiles are stored in parts of 64 rows by 64 columns (128-byte rows of
// bf16), one part per 64 columns of the head dim (NH parts, kPart bytes
// apart), each in the 128B-swizzle layout: 16-byte chunk c of row r at byte
// r * 128 + ((c ^ (r % 8)) * 16) of a 1024-byte-aligned part.

constexpr int kPart = 64 * 128;  // bytes of one 64 x 64 bf16 part

// Byte offset of chunk c of row r in a 128B-swizzled part.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Rows [row0, row0 + ROWS) of a (t, d) bf16 matrix, d <= 64 * NH, into NH
// 128B-swizzled parts of ROWS rows each, ROWS * 128 bytes apart; rows past t
// and columns past d are zero-filled.
template <int ROWS, int NH>
__device__ __forceinline__ void load_tile_sw128_async(unsigned char* dst,
                                                      const bf16* src,
                                                      int row0, int t,
                                                      int d) {
  static_assert(NH == 1 || NH == 2, "64 or 128 columns");
  // 16-byte chunks per row, and its log2. A shift and a mask, not / and %
  // on the signed index, which hold 7-10 more registers a thread across the
  // kernels' main loops.
  constexpr int CPR = 8 * NH, SHIFT = NH == 1 ? 3 : 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i >> SHIFT, c = i & (CPR - 1);
    const int row = row0 + r;
    const bool ok = row < t && c * 8 < d;
    cp_async16(dst + (c >> 3) * (ROWS * 128) + sw128(r, c & 7),
               ok ? src + (size_t)row * d + c * 8 : src, ok);
  }
}

// Descriptor of a 128B-swizzled tile at shared address addr whose 8-row
// groups are 1024 bytes apart (the stride that both a K-major operand and
// a transposed, MN-major one of 64 columns need).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The descriptor of k16 step kc of a K-major operand stored as 64-column
// parts kPart bytes apart: part kc / 4, 32 bytes further per step within it
// (the descriptor counts 16-byte units).
__device__ __forceinline__ uint64_t kmajor_step(uint64_t desc, int kc) {
  return desc + (kc >> 2) * (kPart >> 4) + 2 * (kc & 3);
}

#define HVD_WG_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_WG_OUT(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define HVD_WG_D16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HVD_WG_OUT16(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// d (64 x 64, fp32) += A B, A (64 x 16) and B (16 x 64, stored K-major as
// 64 rows of k) both from shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WG_D32
      ", %32, %33, 1, 1, 1, 0, 0;\n"
      : HVD_WG_OUT(d)
      : "l"(da), "l"(db));
}

// The same with N = 32: d (64 x 32) += A B, B 32 rows of k.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HVD_WG_D16
      ", %16, %17, 1, 1, 1, 0, 0;\n"
      : HVD_WG_OUT16(d)
      : "l"(da), "l"(db));
}

// d (64 x 64, fp32) += A B, A (64 x 16) from registers, B (16 x 64) from
// shared memory stored MN-major (16 rows of 64 columns, transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WG_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : HVD_WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Orders register writes before the next wgmma reads its operands.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Issues the wgmma's since the last commit and waits for all of them.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes (cp.async included) visible to
// the asynchronous proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- TMA and mbarriers
//
// A tensor map (cuTensorMapEncodeTiled, see make_tile_map) describes a
// (d, t, bh) bf16 tensor in boxes of 64 columns (128 bytes) by ROWS rows of
// one head, 128B-swizzled: a box lands in shared memory exactly as
// load_tile_sw128_async lays out one 64-column part, and reads past t or d
// fill zeros. One thread starts the copy; the hardware reports its bytes to
// an mbarrier, on which the consumers wait by phase parity.

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "HVD_MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra HVD_MBAR_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Copies the box at element coordinates (c0, c1, c2) of `map` to shared
// address dst, reporting its bytes to the mbarrier at bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Hands registers between warpgroups: every warp of the warpgroup executes
// it, N a multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The lane's two query rows' segment ids (0 without segment ids).
__device__ __forceinline__ void load_row_segs(const FlashArgs& a, int b,
                                              int qp0, int (&sq)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    sq[r] = (a.seg != nullptr && qp < a.tq) ? a.seg[(size_t)b * a.tq + qp]
                                            : 0;
  }
}

// Raises one kernel's dynamic shared-memory limit once per device and keeps
// the result, instead of a driver call at every launch. One instance per
// kernel (a function-local static of its launcher).
struct SmemLimit {
  static constexpr int kMaxDevices = 64;
  int state[kMaxDevices] = {};  // 0: not raised yet; else 1 + cudaError_t

  cudaError_t raise(const void* kernel, int bytes) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices)
      return cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (state[dev] == 0)
      state[dev] = 1 + (int)cudaFuncSetAttribute(
                           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
    return (cudaError_t)(state[dev] - 1);
  }
};

// cuTensorMapEncodeTiled is a driver function: it is looked up once through
// the runtime, so that the library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The tensor map of a (bh, t, d) row-major bf16 tensor at p, as tma_load_3d
// reads it: dims (d, t, bh), boxes of 64 columns by `rows` rows of one head,
// 128B swizzle, zeros past t and d. The row stride d * 2 bytes is a
// multiple of 16 for every d the kernels take (d % 8 == 0), as TMA needs,
// and p is 16-byte aligned (checked by the wrappers). False if the driver
// refuses it.
static bool make_tile_map(CUtensorMap* m, const void* p, int bh, int t,
                          int d, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hvdflash
