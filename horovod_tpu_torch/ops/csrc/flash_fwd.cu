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
//   wgmma's (fp32 accumulators; see flash_mma.cuh), warp-specialised. One
//   block per (bh, 128-query tile): a producer warp loads Q and a 2-stage
//   ring of K/V tiles by TMA (mbarriers report the bytes), two consumer
//   warpgroups of 64 query rows each share every K/V tile, and setmaxnreg
//   hands the producer warpgroup's registers to them. Tiles stay bf16 in
//   shared memory in the 128B-swizzle layout wgmma reads (one 64-column part
//   per 64 columns of the head dim), which TMA writes directly. S = Q K^T
//   lands in registers, is scaled, masked and exponentiated there (row max
//   and sum over the four lanes of a quad), and becomes the register A
//   operand of O += P V. Tiles with no masked entry take a softmax without
//   any mask code. P goes in as hi + lo bf16 parts (two products), which
//   keeps O within two bf16 ulps of the fp32 plain version; one rounding of
//   P would not. The grid starts with the last q tiles, which under the
//   causal mask walk the most k tiles.
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

// One k tile of the online softmax, on this lane's accumulators of a 16-row
// warp tile (rows qp0 and qp0 + 8 of the sequence): update the running max
// m and this lane's part of the running sum l, rescale O, and leave P =
// 2^(s * scale * log2(e) - m) in s, scores in log2 units. MASKED (the
// diagonal and ragged tiles, or every tile under a bias or segment ids)
// applies the bias / segment / position masks; a row with no visible key yet
// keeps m == kNegInf, and its masked entries must give exactly 0, not 2^0.
// The other tiles take the max of the raw scores and one FFMA per exponent's
// argument; the kernel sends a tile here only when the scale is positive, so
// that max is the max of the scaled scores, bit for bit.
template <bool MASKED, int NS, int NO>
__device__ __forceinline__ void softmax_tile(const FlashArgs& a,
                                             float (&s)[NS][4],
                                             float (&o)[NO][4], float (&m)[2],
                                             float (&l)[2], const float* Bt,
                                             const int* St, int b, int qp0,
                                             int k0, int t2) {
  const float sl = a.scale * kLog2e;
  float mx[2] = {m[0], m[1]};
  if (MASKED) {
    int sq[2];
    load_row_segs(a, b, qp0, sq);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + t2 + (e & 1);
        const float x = mask_score(
            s[j][e] * sl, a.bias != nullptr, Bt[col], a.seg != nullptr,
            sq[r], St[col],
            visible(qp0 + 8 * r, k0 + col, a.tq, a.tk, a.causal, a.offset));
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  } else {
    float raw[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) raw[e >> 1] = fmaxf(raw[e >> 1], s[j][e]);
    mx[0] = fmaxf(mx[0], raw[0] * sl);
    mx[1] = fmaxf(mx[1], raw[1] * sl);
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
      const float p = MASKED ? (x > kNegInf * 0.5f ? ex2(x - m[r]) : 0.f)
                             : ex2(fmaf(x, sl, -m[r]));
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

// One BK-key tile of a consumer warpgroup: S = Q K^T (fp32) in HD / 16
// k16 steps with both operands from shared memory, the online softmax, and O += P V with P as hi + lo
// register fragments and V through a transposed (MN-major) descriptor,
// BK / 16 k16 steps of 16 keys (2048 bytes apart) into each 64-column part
// of O.
template <bool MASKED, int HD, int BK>
__device__ __forceinline__ void fwd_tile(const FlashArgs& a,
                                         float (&o)[HD / 8][4], float (&m)[2],
                                         float (&l)[2], uint64_t qdesc,
                                         uint64_t kdesc, uint64_t vdesc,
                                         const float* Bt, const int* St,
                                         int b, int qp0, int k0, int t2) {
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc)
    wgmma_ss(reinterpret_cast<float(&)[BK / 2]>(s), kmajor_step(qdesc, kc),
             kmajor_step(kdesc, kc));
  wgmma_commit_wait();
  softmax_tile<MASKED>(a, s, o, m, l, Bt, St, b, qp0, k0, t2);

  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
    acc_to_a_split(s[2 * kc], s[2 * kc + 1], ph[kc], pl[kc]);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {
      const uint64_t vd = vdesc + h * (BK * 128 >> 4) + 128 * kc;
      wgmma_rs_t(reinterpret_cast<float(&)[32]>(o[8 * h]), ph[kc], vd);
      wgmma_rs_t(reinterpret_cast<float(&)[32]>(o[8 * h]), pl[kc], vd);
    }
  }
  wgmma_commit_wait();
}

// The wgmma kernel at head dims up to HD (64 or 128; columns past d are
// zero). Three warpgroups: a producer, whose first warp loads every tile by
// TMA, and two consumers, each with its own 64 query rows of the block's
// 128, sharing each K and V tile. The K/V tiles go through a ring of STAGES
// buffers, each with a `full` mbarrier (the producer's 32 lanes arrive once
// they staged the tile's key bias and segment ids; the TMA bytes complete
// it) and an `empty` one (every consumer thread arrives when its products
// have read the tile). The producer hands its registers to the consumers
// (setmaxnreg): at d <= 64 two blocks share an SM, 104 registers a consumer
// thread, so that one block's first loads and last stores overlap the
// other's products, and 32-key tiles keep S and P small enough for those
// registers; at d 128, where O alone holds 64 registers, one block with 240
// and 64-key tiles.
template <int HD>
struct WgFwdTiles {
  static constexpr int NWG = 2;                 // consumers, 64 rows each
  static constexpr int THREADS = (NWG + 1) * kThreads;
  static constexpr int BQ = 64 * NWG, BK = HD <= 64 ? 32 : 64, STAGES = 2;
  static constexpr int NH = HD / 64;            // 64-column parts
  static constexpr int TILE = NH * kPart;       // bytes of a Q tile
  static constexpr int KVT = NH * BK * 128;     // bytes of a K or V tile
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;  // per SM
  // ptxas holds every thread to KERNEL_REGS; the producer drops to
  // PRODUCER_REGS and the consumers take what it frees.
  static constexpr int KERNEL_REGS = (65536 / (THREADS * MIN_BLOCKS)) & ~7;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS =
      ((KERNEL_REGS * THREADS - PRODUCER_REGS * kThreads) /
       (NWG * kThreads)) & ~7;
  // alignment slack | Q[NWG] | {K, V}[STAGES] | key bias * log2(e)
  // [STAGES] | key segment ids [STAGES] | mbarriers: Q, full[STAGES],
  // empty[STAGES]
  static constexpr int SMEM = 1024 + NWG * TILE + 2 * STAGES * KVT +
                              STAGES * BK * 8 + 8 * (1 + 2 * STAGES);
  // The budgets after setmaxnreg: producer 24, consumers 104 at d <= 64
  // (80 at launch) and 240 at d 128 (168 at launch).
  static_assert(CONSUMER_REGS == (HD <= 64 ? 104 : 240),
                "setmaxnreg budget");
  static_assert(64 / BK <= STAGES, "a skipped tile's stage is reused");
  static_assert(NH == 1 || BK * 128 == kPart, "K's parts are kPart apart");
};

struct FwdMaps {
  CUtensorMap q, k, v;  // boxes of 64 (q) or BK rows, see make_tile_map
};

template <int HD>
__global__ void __launch_bounds__(WgFwdTiles<HD>::THREADS,
                                  WgFwdTiles<HD>::MIN_BLOCKS)
    flash_fwd_wg_kernel(const __grid_constant__ FwdMaps maps, FlashArgs a) {
  using Tl = WgFwdTiles<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NH = Tl::NH, TILE = Tl::TILE;
  constexpr int NWG = Tl::NWG, STAGES = Tl::STAGES, KVT = Tl::KVT;
  extern __shared__ __align__(16) unsigned char smem[];
  // The swizzle pattern is a function of the address: tiles start on
  // 1024-byte boundaries.
  const uint32_t raw = smem_u32(smem), base = (raw + 1023) & ~1023u;
  const uint32_t kv0 = base + NWG * TILE;  // stage s: K at kv0 + 2 s KVT
  float* Bs = reinterpret_cast<float*>(smem + (base - raw) + NWG * TILE +
                                       2 * STAGES * KVT);
  int* Ss = reinterpret_cast<int*>(Bs + STAGES * BK);
  const uint32_t qbar = smem_u32(Ss + STAGES * BK);
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / a.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int tq = a.tq, tk = a.tk;
  // The block walks the k tiles its last rows need.
  const int nkt = k_tiles_needed(q0, BQ, BK, tk, a.causal, a.offset);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 32);
      mbar_init(empty0 + 8 * st, NWG * kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer
    setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (warp != 0) return;
    if (lane == 0) {
      mbar_arrive_tx(qbar, NWG * TILE);
      for (int w = 0; w < NWG; ++w)
        for (int h = 0; h < NH; ++h)
          tma_load_3d(base + w * TILE + h * kPart, &maps.q, qbar, 64 * h,
                      q0 + 64 * w, bh);
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt % STAGES, k0 = kt * BK;
      // Stage st was last read by tile kt - STAGES.
      if (kt >= STAGES) mbar_wait(empty0 + 8 * st, (kt / STAGES - 1) & 1);
      for (int j = lane; j < BK; j += 32) {
        const int kp = k0 + j;
        const bool ok = kp < tk;
        Bs[st * BK + j] = (a.bias != nullptr && ok)
                              ? a.bias[(size_t)b * tk + kp] * kLog2e
                              : 0.f;
        Ss[st * BK + j] =
            (a.seg != nullptr && ok) ? a.seg[(size_t)b * tk + kp] : 0;
      }
      const uint32_t full = full0 + 8 * st;
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * KVT);
        const uint32_t kdst = kv0 + 2 * st * KVT;
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(kdst + h * BK * 128, &maps.k, full, 64 * h, k0, bh);
          tma_load_3d(kdst + KVT + h * BK * 128, &maps.v, full, 64 * h, k0,
                      bh);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // A consumer.
  setmaxnreg_inc<Tl::CONSUMER_REGS>();
  const int qw = q0 + 64 * wg;  // this warpgroup's first query
  const int qp0 = qw + warp * 16 + (lane >> 2), t2 = (lane & 3) * 2;
  // Under the causal mask the first warpgroup may need fewer k tiles than
  // the block: it skips the last 64 keys at most. A skipped tile's stage is
  // never reused (64 / BK <= STAGES), so no empty barrier waits on it.
  const int my_nkt = k_tiles_needed(qw, 64, BK, tk, a.causal, a.offset);
  // The tiles without a masked entry (tile_has_mask false) come first:
  // whole tiles of keys below the diagonal, with no bias, no segment ids
  // and no rows past tq. Their softmax needs a positive scale.
  int n_plain = 0;
  if (a.bias == nullptr && a.seg == nullptr && qw + 64 <= tq &&
      a.scale > 0.f) {
    n_plain = tk / BK;
    if (a.causal) {
      const int lim = qw + a.offset + 1;  // k_pos < lim for every row
      n_plain = min(n_plain, lim <= 0 ? 0 : lim / BK);
    }
    n_plain = min(n_plain, my_nkt);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const uint64_t qdesc = sw128_desc(base + wg * TILE);
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < my_nkt; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(full0 + 8 * st, (kt / STAGES) & 1);
    const uint64_t kdesc = sw128_desc(kv0 + 2 * st * KVT);
    const uint64_t vdesc = sw128_desc(kv0 + (2 * st + 1) * KVT);
    if (kt < n_plain)
      fwd_tile<false, HD, BK>(a, o, m, l, qdesc, kdesc, vdesc, nullptr,
                              nullptr, b, qp0, kt * BK, t2);
    else
      fwd_tile<true, HD, BK>(a, o, m, l, qdesc, kdesc, vdesc, Bs + st * BK,
                             Ss + st * BK, b, qp0, kt * BK, t2);
    mbar_arrive(empty0 + 8 * st);  // this thread's products are done
  }
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
  FwdMaps maps;
  if (!make_tile_map(&maps.q, a.q, bh, a.tq, a.d, 64) ||
      !make_tile_map(&maps.k, a.k, bh, a.tk, a.d, Tl::BK) ||
      !make_tile_map(&maps.v, a.v, bh, a.tk, a.d, Tl::BK))
    return cudaErrorInvalidValue;
  dim3 grid(bh, (a.tq + Tl::BQ - 1) / Tl::BQ);
  flash_fwd_wg_kernel<HD><<<grid, Tl::THREADS, Tl::SMEM, st>>>(maps, a);
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
