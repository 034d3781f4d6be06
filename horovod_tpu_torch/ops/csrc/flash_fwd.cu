// Flash-attention forward for Hopper (sm_90a): O and the per-row logsumexp.
//
// Replaces the TPU kernel _fwd_kernel in horovod_tpu/ops/flash_attention.py
// (launched by _fwd through pl.pallas_call). The TPU kernel walks a
// (BH, q tiles, k tiles) grid whose innermost k axis runs in order on one
// core, carrying the online-softmax state in VMEM scratch from one grid step
// to the next. Here one thread block owns one (bh, q tile) and loops over
// the k tiles itself; nothing carries over between blocks.
//
// What bounds it on an H100: at GPT-2 medium's shapes (BH 128, T 1024, d 64,
// causal) the work is ~17 GFLOP against ~67 MB of q/k/v/o, so the bound is
// the bytes (~20 us at 3.35 TB/s) and the kernel should be near the tensor
// cores' rate. This first version does its products as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak), so it is bound by FMA issue and shared-memory
// reads instead: each k/v element a block loads is reused by every query row
// of the block from shared memory, each lane keeps its query row and its
// output accumulator in registers, and 16-byte shared loads feed four FMAs
// each. Moving the two products onto wgmma is the next step.
//
// Per block: kThreads threads, BQ = kThreads / NS query rows (NS = HD / 32
// lanes per row), k tiles of BK rows of K and V staged in shared memory as
// fp32. Whole k tiles above the causal diagonal are skipped.

#include "flash_common.cuh"

namespace hvdflash {

template <int HD>
struct FwdTiles {
  static constexpr int NS = HD / 32;
  static constexpr int BQ = kThreads / NS;
  static constexpr int BK = HD <= 64 ? 64 : 32;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  using Tl = FwdTiles<HD>;
  constexpr int NS = Tl::NS, BQ = Tl::BQ, BK = Tl::BK;
  __shared__ __align__(16) float Ks[BK * Tile<HD>::STRIDE];
  __shared__ __align__(16) float Vs[BK * Tile<HD>::STRIDE];
  __shared__ float Bs[BK];
  __shared__ int Ss[BK];

  const int bh = blockIdx.x, qb = blockIdx.y, b = bh / a.heads;
  const int tid = threadIdx.x, hs = tid % NS;
  const int qpos = qb * BQ + tid / NS;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const T* qh = static_cast<const T*>(a.q) + (size_t)bh * tq * d;
  const T* kh = static_cast<const T*>(a.k) + (size_t)bh * tk * d;
  const T* vh = static_cast<const T*>(a.v) + (size_t)bh * tk * d;
  const bool has_bias = a.bias != nullptr, has_seg = a.seg != nullptr;

  float qr[32], acc[32];
  load_row(qr, qh, qpos, tq, d, hs * 32, a.scale);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  const int sq = (has_seg && qpos < tq) ? a.seg[(size_t)b * tq + qpos] : 0;
  float m = kNegInf, l = 0.f;

  const int nkt = k_tiles_needed(qb * BQ, BQ, BK, tk, a.causal, a.offset);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile has been consumed
    load_tile<T, HD>(Ks, kh, k0, BK, tk, d, 1.f);
    load_tile<T, HD>(Vs, vh, k0, BK, tk, d, 1.f);
    for (int j = tid; j < BK; j += kThreads) {
      const int kp = k0 + j;
      Bs[j] = (has_bias && kp < tk) ? a.bias[(size_t)b * tk + kp] : 0.f;
      Ss[j] = (has_seg && kp < tk) ? a.seg[(size_t)b * tk + kp] : 0;
    }
    __syncthreads();

    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float x = group_sum<NS>(dot_row<HD>(qr, Ks, j, hs));
      s[j] = mask_score(x, has_bias, Bs[j], has_seg, sq, Ss[j],
                        visible(qpos, k0 + j, tq, tk, a.causal, a.offset));
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // A row with no visible key yet has mx == kNegInf; masked entries
      // must still give exactly 0, not exp(0).
      const float p = s[j] > kNegInf * 0.5f ? expf(s[j] - mx) : 0.f;
      s[j] = p;
      psum += p;
    }
    l = l * corr + psum;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) axpy_row<HD>(acc, s[j], Vs, j, hs);
    m = mx;
  }

  if (qpos < tq) {
    // A row with every key masked normalises to 0 with lse = kNegInf.
    const float ls = l == 0.f ? 1.f : l;
    T* orow = static_cast<T*>(a.o) + ((size_t)bh * tq + qpos) * d;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = hs * 32 + c;
      if (col < d) orow[col] = from_f<T>(acc[c] / ls);
    }
    if (hs == 0) a.lse[(size_t)bh * tq + qpos] = m + logf(ls);
  }
}

template <typename T, int HD>
static void launch_fwd(const FlashArgs& a, int bh, cudaStream_t st) {
  constexpr int BQ = FwdTiles<HD>::BQ;
  dim3 grid(bh, (a.tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, st>>>(a);
}

template <typename T>
static void launch_fwd_hd(const FlashArgs& a, int bh, cudaStream_t st) {
  if (a.d <= 32) {
    launch_fwd<T, 32>(a, bh, st);
  } else if (a.d <= 64) {
    launch_fwd<T, 64>(a, bh, st);
  } else {
    launch_fwd<T, 128>(a, bh, st);
  }
}

}  // namespace hvdflash

// C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seg, void* o,
                             void* lse, int bh, int tq, int tk, int d,
                             int heads, float scale, int causal, int offset,
                             int dtype, void* stream) {
  using namespace hvdflash;
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
      heads <= 0 || bh % heads != 0 || (dtype != 0 && dtype != 1) ||
      (tq + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seg = static_cast<const int*>(seg);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.heads = heads;
  a.causal = causal;
  a.offset = offset;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_fwd_hd<__nv_bfloat16>(a, bh, st);
  } else {
    launch_fwd_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}
