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
// the bytes (~20 us at 3.35 TB/s), with the operations close behind (~17 us
// at 989 TFLOP/s bf16). Two kernels, chosen by input type:
//
// - bf16, flash_fwd_wg_kernel<HD> (HD 64 for d <= 64, the training path's
//   64; HD 128 above): both products on the tensor cores as warpgroup
//   wgmma's (fp32 accumulators; see flash_mma.cuh). One block of four warps
//   per (bh, 64-query tile), each warp owning 16 query rows of the m64
//   products. Q, and K and V tiles of 64 keys, stay bf16 in shared memory in
//   the 128B-swizzle layout wgmma reads (one 64-column part per 64 columns
//   of the head dim), K and V double-buffered with cp.async so that the next
//   tile is in flight while this one computes. S = Q K^T lands in registers, is scaled,
//   masked and exponentiated there (row max and sum over the four lanes of a
//   quad), and becomes the register A operand of O += P V. P goes in as
//   hi + lo bf16 parts (two products), which keeps O within two bf16 ulps of
//   the fp32 plain version; one rounding of P would not. The grid starts
//   with the last q tiles, which under the causal mask walk the most k tiles.
// - fp32, flash_fwd_kernel: the first port's fp32 FMAs on the CUDA cores
//   (TF32 tensor cores would keep only ~3 digits). A lane group of NS =
//   HD / 32 lanes owns a query row; k tiles of BK rows of K and V are staged
//   in shared memory as fp32 and reused by every query row of the block.
//
// Whole k tiles above the causal diagonal are skipped in both.

#include "flash_mma.cuh"

namespace hvdflash {

// ---------------------------------------------------------------- fp32

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

// ---------------------------------------------------------------- bf16

// Start the copies of the K and V rows [k0, k0 + BK) into the swizzled
// tiles Kb and Vb, and stage their key bias (times log2(e)) and segment ids
// in Bb and Sb.
template <int BK, int NH>
__device__ __forceinline__ void stage_kv(const FlashArgs& a, const bf16* kh,
                                         const bf16* vh, int b, int k0,
                                         unsigned char* Kb, unsigned char* Vb,
                                         float* Bb, int* Sb) {
  load_tile_sw128_async<BK, NH>(Kb, kh, k0, a.tk, a.d);
  load_tile_sw128_async<BK, NH>(Vb, vh, k0, a.tk, a.d);
  for (int j = threadIdx.x; j < BK; j += kThreads) {
    const int kp = k0 + j;
    const bool ok = kp < a.tk;
    Bb[j] = (a.bias != nullptr && ok)
                ? a.bias[(size_t)b * a.tk + kp] * kLog2e
                : 0.f;
    Sb[j] = (a.seg != nullptr && ok) ? a.seg[(size_t)b * a.tk + kp] : 0;
  }
}

// One k tile of the online softmax, on this lane's accumulators of a 16-row
// warp tile (rows qp0 and qp0 + 8 of the sequence): scale the raw scores s
// to log2 units, apply the bias / segment / position masks when the tile
// has any masked entry (`full`: the diagonal and ragged tiles, or every
// tile under a bias or segment ids), update the running max m and this
// lane's part of the running sum l, rescale O, and leave P = 2^(s - m) in s.
// A row with no visible key yet keeps m == kNegInf; its masked entries must
// give exactly 0, not 2^0.
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(
    const FlashArgs& a, float (&s)[NS][4], float (&o)[NO][4], float (&m)[2],
    float (&l)[2], const int (&sq)[2], const float* Bt, const int* St,
    bool full, int qp0, int k0, int t2) {
  const float sl = a.scale * kLog2e;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = j * 8 + t2 + (e & 1);
      float x = s[j][e] * sl;
      if (full)
        x = mask_score(x, a.bias != nullptr, Bt[col], a.seg != nullptr,
                       sq[r], St[col],
                       visible(qp0 + 8 * r, k0 + col, a.tq, a.tk, a.causal,
                               a.offset));
      s[j][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    const float corr = ex2(m[r] - mx[r]);
    l[r] *= corr;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * r] *= corr;
      o[j][2 * r + 1] *= corr;
    }
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float x = s[j][e];
      const float p = (!full || x > kNegInf * 0.5f) ? ex2(x - m[r]) : 0.f;
      s[j][e] = p;
      l[r] += p;
    }
  }
}

// O = acc / l and lse of this lane's two rows qp0, qp0 + 8. A row with every
// key masked normalises to 0 with lse = kNegInf.
template <int NO>
__device__ __forceinline__ void store_o_lse(const FlashArgs& a,
                                            const float (&o)[NO][4],
                                            const float (&m)[2],
                                            const float (&l)[2], int bh,
                                            int qp0, int t2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const int qp = qp0 + 8 * r;
    if (qp < a.tq) {
      const float ls = lt == 0.f ? 1.f : lt;
      bf16* orow = static_cast<bf16*>(a.o) + ((size_t)bh * a.tq + qp) * a.d;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + t2;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[j][2 * r] / ls, o[j][2 * r + 1] / ls);
      }
      if (t2 == 0)
        a.lse[(size_t)bh * a.tq + qp] =
            lt == 0.f ? kNegInf : m[r] * kLn2 + logf(lt);
    }
  }
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

// The wgmma kernel at head dims up to HD (64 or 128; columns past d are
// zero). S = Q K^T reads both operands from shared memory; O += P V takes P
// from registers and V through a transposed (MN-major) descriptor, one
// 64-column part of O at a time.
template <int HD>
struct WgFwdTiles {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int NH = HD / 64;          // 64-column parts
  static constexpr int TILE = NH * kPart;     // bytes of one Q, K or V tile
  // alignment slack | Q | K[2] | V[2] | key bias * log2(e) [2] | key
  // segment ids [2]
  static constexpr int SMEM = 1024 + 5 * TILE + 2 * BK * 8;
};

// At d 64 ptxas gives it 127 registers a thread, 4 blocks per SM (shared
// memory would allow 5). Holding it to 128 with __launch_bounds__ makes
// ptxas spill instead; at 134 (one block per SM fewer) it took ~13 % longer.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_wg_kernel(FlashArgs a) {
  using Tl = WgFwdTiles<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NH = Tl::NH, TILE = Tl::TILE;
  constexpr int NS = BK / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  // The swizzle pattern is a function of the address: tiles start on
  // 1024-byte boundaries.
  const uint32_t raw = smem_u32(smem), base = (raw + 1023) & ~1023u;
  unsigned char* Qs = smem + (base - raw);
  unsigned char* Ks = Qs + TILE;
  unsigned char* Vs = Ks + 2 * TILE;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TILE);
  int* Ss = reinterpret_cast<int*>(Bs + 2 * BK);

  const int bh = blockIdx.x, b = bh / a.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qp0 = q0 + warp * 16 + (lane >> 2), t2 = (lane & 3) * 2;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const bf16* qh = static_cast<const bf16*>(a.q) + (size_t)bh * tq * d;
  const bf16* kh = static_cast<const bf16*>(a.k) + (size_t)bh * tk * d;
  const bf16* vh = static_cast<const bf16*>(a.v) + (size_t)bh * tk * d;

  const int nkt = k_tiles_needed(q0, BQ, BK, tk, a.causal, a.offset);
  load_tile_sw128_async<BQ, NH>(Qs, qh, q0, tq, d);
  if (nkt > 0) stage_kv<BK, NH>(a, kh, vh, b, 0, Ks, Vs, Bs, Ss);
  cp_async_commit();

  int sq[2];
  load_row_segs(a, b, qp0, sq);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const uint64_t qdesc = sw128_desc(base);

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nkt)
      stage_kv<BK, NH>(a, kh, vh, b, k0 + BK, Ks + (buf ^ 1) * TILE,
                       Vs + (buf ^ 1) * TILE, Bs + (buf ^ 1) * BK,
                       Ss + (buf ^ 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt (and Q) have landed
    fence_proxy_async();
    __syncthreads();
    const uint64_t kdesc = sw128_desc(base + (1 + buf) * TILE);
    const uint64_t vdesc = sw128_desc(base + (3 + buf) * TILE);

    // S = Q K^T (fp32): HD / 16 k16 steps along the head dim.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      wgmma_ss(reinterpret_cast<float(&)[32]>(s), kmajor_step(qdesc, kc),
               kmajor_step(kdesc, kc));
    wgmma_commit_wait();
    softmax_tile(a, s, o, m, l, sq, Bs + buf * BK, Ss + buf * BK,
                 tile_has_mask(a, q0, BQ, k0, BK), qp0, k0, t2);

    // O += P V, P as hi + lo: four k16 steps of 16 keys, 2048 bytes apart,
    // into each 64-column part of O.
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      acc_to_a_split(s[2 * kc], s[2 * kc + 1], ph[kc], pl[kc]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t vd = vdesc + h * (kPart >> 4) + 128 * kc;
        wgmma_rs_t(reinterpret_cast<float(&)[32]>(o[8 * h]), ph[kc], vd);
        wgmma_rs_t(reinterpret_cast<float(&)[32]>(o[8 * h]), pl[kc], vd);
      }
    }
    wgmma_commit_wait();
    __syncthreads();  // every warp is done with buffer buf
  }
  cp_async_wait<0>();
  store_o_lse(a, o, m, l, bh, qp0, t2);
}

template <int HD>
static cudaError_t launch_fwd_wg(const FlashArgs& a, int bh,
                                 cudaStream_t st) {
  using Tl = WgFwdTiles<HD>;
  static SmemLimit limit;
  const cudaError_t e = limit.raise(
      reinterpret_cast<const void*>(flash_fwd_wg_kernel<HD>), Tl::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (a.tq + Tl::BQ - 1) / Tl::BQ);
  flash_fwd_wg_kernel<HD><<<grid, kThreads, Tl::SMEM, st>>>(a);
  return cudaSuccess;
}

static cudaError_t launch_fwd_bf16(const FlashArgs& a, int bh,
                                   cudaStream_t st) {
  return a.d <= 64 ? launch_fwd_wg<64>(a, bh, st)
                   : launch_fwd_wg<128>(a, bh, st);
}

}  // namespace hvdflash

// C interface, loaded with ctypes. dtype: 0 = fp32 (FMA kernel), 1 = bf16
// (tensor-core kernel). Returns the cudaError_t of the launch (0 on
// success).
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
    const cudaError_t e = launch_fwd_bf16(a, bh, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    launch_fwd_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory, in bytes, of one block of the bf16 kernel at head
// dim d (ptxas reports none for it).
extern "C" int hvd_flash_fwd_smem(int d) {
  using namespace hvdflash;
  return d <= 64 ? WgFwdTiles<64>::SMEM : WgFwdTiles<128>::SMEM;
}
