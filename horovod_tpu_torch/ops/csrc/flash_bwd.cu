// Flash-attention backward for Hopper (sm_90a): dQ, and dK / dV / dbias.
//
// Replaces the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel in
// horovod_tpu/ops/flash_attention.py (launched by _bwd through two
// pl.pallas_call). Both recompute P = exp(S - lse) from the saved per-row
// logsumexp instead of storing P, and dS = P * (dO V^T - delta) with
// delta = rowsum(dO * O) computed outside (plain torch, as in the
// reference). On the TPU the innermost grid axis runs in order and carries
// the accumulators in VMEM; here the dQ kernels give one block to each
// (bh, q tile) and loop over k tiles, and the dK/dV kernels give one block
// to each (bh, k tile) and loop over q tiles.
//
// What bounds them on an H100: at GPT-2 medium's shapes (BH 128, T 1024,
// d 64, causal) the dQ kernel does ~25.8 GFLOP over ~85 MB and the dK/dV
// kernel ~34.4 GFLOP over ~102 MB, so with tensor cores (989 TFLOP/s bf16,
// 3.35 TB/s) both are bound by the operations (~26 and ~35 us; the bytes
// alone take ~25 and ~30 us).
//
// - bf16, both kernels on the tensor cores as warpgroup wgmma's (fp32
//   accumulators; see flash_mma.cuh), HD 64 for d <= 64 (the training
//   path's 64) and HD 128 above. One block of four warps (one warpgroup) per
//   64-row tile, each warp owning 16 rows of the m64 products; the tiles stay
//   bf16 in shared memory in the 128B-swizzle layout (cp.async), the walked
//   ones double-buffered.
//   - dQ, flash_bwd_dq_wg_kernel<HD>: one block per (bh, 64-query tile),
//     walking the k tiles of 64 up to the causal diagonal, as the forward
//     kernel does. Q and dO are loaded once; K and V (with the key bias and
//     segment ids) along the walk; each lane keeps its two rows' lse and
//     delta in registers. Per k tile: S = Q K^T and dP = dO V^T from shared
//     memory, P and dS in registers, dQ += dS K with dS as register hi + lo
//     bf16 parts (two products) and K through a transposed descriptor. At
//     d 128 dQ alone holds 64 registers, so S and dP go 32 keys at a time.
//     The grid starts with the last q tiles, which walk the most k tiles.
//   - dK/dV, flash_bwd_dkv_wg_kernel<HD>: one block per (bh, 64-key tile),
//     walking the q tiles of 64 from the first one that sees a key of the
//     block, the lse / delta rows staged beside Q and dO. Per q tile:
//     S^T = K Q^T and dP^T = V dO^T from shared memory; P^T and dS^T in
//     registers; dV += P^T dO and dK += dS^T Q with P and dS as hi + lo. The
//     grid starts with the first k tiles, which walk the most q tiles.
//   The hi + lo split keeps every output within two bf16 ulps of the fp32
//   plain version; one rounding would not.
// - fp32: the first port's fp32 FMAs on the CUDA cores (TF32 tensor cores
//   would keep only ~3 digits). The tile a block walks over (K and V for dQ,
//   Q and dO for dK/dV) is staged once in shared memory and reused by every
//   row of the block, while each lane keeps its own row's operands and
//   accumulators in registers.
//
// The split into a dQ pass and a dK/dV pass is the reference's: each output
// row is owned by exactly one block, so neither kernel needs atomics or fp32
// scratch, and dQ is deterministic.
//
// Masked entries give P == 0 and dS == 0 exactly, whatever the other terms
// hold, as in the reference (0 * garbage must never reach an accumulator).

#include "flash_mma.cuh"

namespace hvdflash {

template <int HD>
struct DqTiles {
  static constexpr int NS = HD / 32;
  static constexpr int BQ = kThreads / NS;   // query rows per block
  static constexpr int BK = HD <= 64 ? 64 : 32;
};

template <int HD>
struct DkvTiles {
  static constexpr int NS = HD / 32;
  static constexpr int BK = kThreads / NS;   // key rows per block
  static constexpr int BQ = 32;              // query rows per staged tile
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(FlashArgs a) {
  using Tl = DqTiles<HD>;
  constexpr int NS = Tl::NS, BQ = Tl::BQ, BK = Tl::BK;
  __shared__ __align__(16) float Ks[BK * Tile<HD>::STRIDE];
  __shared__ __align__(16) float Vs[BK * Tile<HD>::STRIDE];
  __shared__ float Bs[BK];
  __shared__ int Ss[BK];

  const int bh = blockIdx.x, qb = blockIdx.y, b = bh / a.heads;
  const int tid = threadIdx.x, hs = tid % NS;
  const int qpos = qb * BQ + tid / NS;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const size_t qoff = (size_t)bh * tq * d, koff = (size_t)bh * tk * d;
  const T* kh = static_cast<const T*>(a.k) + koff;
  const T* vh = static_cast<const T*>(a.v) + koff;
  const bool has_bias = a.bias != nullptr, has_seg = a.seg_q != nullptr;

  float qr[32], dor[32], acc[32];
  load_row(qr, static_cast<const T*>(a.q) + qoff, qpos, tq, d, hs * 32,
           a.scale);
  load_row(dor, static_cast<const T*>(a.dout) + qoff, qpos, tq, d, hs * 32,
           1.f);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  const bool qvalid = qpos < tq;
  const int sq = (has_seg && qvalid) ? a.seg_q[(size_t)b * tq + qpos] : 0;
  const float lse = qvalid ? a.lse_in[(size_t)bh * tq + qpos] : 0.f;
  const float delta = qvalid ? a.delta[(size_t)bh * tq + qpos] : 0.f;

  const int nkt = k_tiles_needed(qb * BQ, BQ, BK, tk, a.causal, a.offset);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, HD>(Ks, kh, k0, BK, tk, d, 1.f);
    load_tile<T, HD>(Vs, vh, k0, BK, tk, d, 1.f);
    for (int j = tid; j < BK; j += kThreads) {
      const int kp = k0 + j;
      Bs[j] = (has_bias && kp < tk) ? a.bias[(size_t)b * tk + kp] : 0.f;
      Ss[j] = (has_seg && kp < tk) ? a.seg_k[(size_t)b * tk + kp] : 0;
    }
    __syncthreads();

    // One key at a time, so that only scalars live beside the three
    // register rows (arrays of per-key scores spill to local memory).
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float s = group_sum<NS>(dot_row<HD>(qr, Ks, j, hs));
      const float dp = group_sum<NS>(dot_row<HD>(dor, Vs, j, hs));
      const float x = mask_score(s, has_bias, Bs[j], has_seg, sq, Ss[j],
                                 visible(qpos, k0 + j, tq, tk, a.causal,
                                         a.offset));
      const float p = x > kNegInf * 0.5f ? expf(x - lse) : 0.f;
      const float ds = p > 0.f ? p * (dp - delta) : 0.f;
      axpy_row<HD>(acc, ds, Ks, j, hs);
    }
  }

  if (qvalid) {
    T* row = static_cast<T*>(a.dq) + qoff + (size_t)qpos * d;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = hs * 32 + c;
      if (col < d) row[col] = from_f<T>(acc[c] * a.scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    FlashArgs a) {
  using Tl = DkvTiles<HD>;
  constexpr int NS = Tl::NS, BK = Tl::BK, BQ = Tl::BQ;
  __shared__ __align__(16) float Qs[BQ * Tile<HD>::STRIDE];  // q * scale
  __shared__ __align__(16) float Ds[BQ * Tile<HD>::STRIDE];  // dO
  __shared__ float Ls[BQ];
  __shared__ float Dl[BQ];
  __shared__ int Sq[BQ];

  const int bh = blockIdx.x, kb = blockIdx.y, b = bh / a.heads;
  const int tid = threadIdx.x, hs = tid % NS;
  const int kpos = kb * BK + tid / NS;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const size_t qoff = (size_t)bh * tq * d, koff = (size_t)bh * tk * d;
  const T* qh = static_cast<const T*>(a.q) + qoff;
  const T* doh = static_cast<const T*>(a.dout) + qoff;
  const bool has_bias = a.bias != nullptr, has_seg = a.seg_q != nullptr;
  const bool kvalid = kpos < tk;

  float kr[32], vr[32], dk[32], dv[32];
  load_row(kr, static_cast<const T*>(a.k) + koff, kpos, tk, d, hs * 32, 1.f);
  load_row(vr, static_cast<const T*>(a.v) + koff, kpos, tk, d, hs * 32, 1.f);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    dk[c] = 0.f;
    dv[c] = 0.f;
  }
  float db = 0.f;
  const float bias = (has_bias && kvalid) ? a.bias[(size_t)b * tk + kpos]
                                          : 0.f;
  const int sk = (has_seg && kvalid) ? a.seg_k[(size_t)b * tk + kpos] : 0;

  const int nqt = (tq + BQ - 1) / BQ;
  for (int qt = first_q_tile(kb * BK, BQ, a.causal, a.offset); qt < nqt;
       ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, HD>(Qs, qh, q0, BQ, tq, d, a.scale);
    load_tile<T, HD>(Ds, doh, q0, BQ, tq, d, 1.f);
    for (int i = tid; i < BQ; i += kThreads) {
      const int qp = q0 + i;
      const bool ok = qp < tq;
      Ls[i] = ok ? a.lse_in[(size_t)bh * tq + qp] : 0.f;
      Dl[i] = ok ? a.delta[(size_t)bh * tq + qp] : 0.f;
      Sq[i] = (has_seg && ok) ? a.seg_q[(size_t)b * tq + qp] : 0;
    }
    __syncthreads();

    // One query at a time: only scalars live beside the four register rows.
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      const float s = group_sum<NS>(dot_row<HD>(kr, Qs, i, hs));
      const float dp = group_sum<NS>(dot_row<HD>(vr, Ds, i, hs));
      const float x = mask_score(s, has_bias, bias, has_seg, Sq[i], sk,
                                 visible(q0 + i, kpos, tq, tk, a.causal,
                                         a.offset));
      const float p = x > kNegInf * 0.5f ? expf(x - Ls[i]) : 0.f;
      const float ds = p > 0.f ? p * (dp - Dl[i]) : 0.f;
      db += ds;
      axpy_row<HD>(dv, p, Ds, i, hs);
      // dK = dS^T (q * scale): the staged q tile already carries the scale.
      axpy_row<HD>(dk, ds, Qs, i, hs);
    }
  }

  if (kvalid) {
    T* dkrow = static_cast<T*>(a.dk) + koff + (size_t)kpos * d;
    T* dvrow = static_cast<T*>(a.dv) + koff + (size_t)kpos * d;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = hs * 32 + c;
      if (col < d) {
        dkrow[col] = from_f<T>(dk[c]);
        dvrow[col] = from_f<T>(dv[c]);
      }
    }
    // d(score)/d(bias) = 1 on visible entries: dbias_k = sum_q dS.
    if (a.dbias != nullptr && hs == 0) a.dbias[(size_t)bh * tk + kpos] = db;
  }
}

template <typename T, int HD>
static void launch_dq(const FlashArgs& a, int bh, cudaStream_t st) {
  constexpr int BQ = DqTiles<HD>::BQ;
  dim3 grid(bh, (a.tq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, 0, st>>>(a);
}

template <typename T, int HD>
static void launch_dkv(const FlashArgs& a, int bh, cudaStream_t st) {
  constexpr int BK = DkvTiles<HD>::BK;
  dim3 grid(bh, (a.tk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, HD><<<grid, kThreads, 0, st>>>(a);
}

template <typename T>
static void launch_dq_hd(const FlashArgs& a, int bh, cudaStream_t st) {
  if (a.d <= 32) {
    launch_dq<T, 32>(a, bh, st);
  } else if (a.d <= 64) {
    launch_dq<T, 64>(a, bh, st);
  } else {
    launch_dq<T, 128>(a, bh, st);
  }
}

template <typename T>
static void launch_dkv_hd(const FlashArgs& a, int bh, cudaStream_t st) {
  if (a.d <= 32) {
    launch_dkv<T, 32>(a, bh, st);
  } else if (a.d <= 64) {
    launch_dkv<T, 64>(a, bh, st);
  } else {
    launch_dkv<T, 128>(a, bh, st);
  }
}

// ---------------------------------------------------------------- dK/dV bf16

// Start the copies of the q and dO rows [q0, q0 + BQ) into the swizzled
// tiles Qb and Db, and stage their lse * log2(e), delta and segment ids in
// Lb, Dlb and Sqb.
template <int BQ, int NH>
__device__ __forceinline__ void stage_q(const FlashArgs& a, const bf16* qh,
                                        const bf16* doh, int bh, int b,
                                        int q0, unsigned char* Qb,
                                        unsigned char* Db, float* Lb,
                                        float* Dlb, int* Sqb) {
  load_tile_sw128_async<BQ, NH>(Qb, qh, q0, a.tq, a.d);
  load_tile_sw128_async<BQ, NH>(Db, doh, q0, a.tq, a.d);
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int qp = q0 + i;
    const bool ok = qp < a.tq;
    Lb[i] = ok ? a.lse_in[(size_t)bh * a.tq + qp] * kLog2e : 0.f;
    Dlb[i] = ok ? a.delta[(size_t)bh * a.tq + qp] : 0.f;
    Sqb[i] = (a.seg_q != nullptr && ok) ? a.seg_q[(size_t)b * a.tq + qp]
                                        : 0;
  }
}

// The key bias (times log2(e)) and segment ids of the block's keys
// [k0, k0 + BK), into Kb and Sk.
template <int BK>
__device__ __forceinline__ void stage_keys(const FlashArgs& a, int b, int k0,
                                           float* Kb, int* Sk) {
  for (int j = threadIdx.x; j < BK; j += kThreads) {
    const int kp = k0 + j;
    const bool ok = kp < a.tk;
    Kb[j] = (a.bias != nullptr && ok)
                ? a.bias[(size_t)b * a.tk + kp] * kLog2e
                : 0.f;
    Sk[j] = (a.seg_k != nullptr && ok) ? a.seg_k[(size_t)b * a.tk + kp] : 0;
  }
}

// P^T = 2^(S^T - lse) and dS^T = P^T (dP^T - delta), in place, on this
// lane's accumulators of a 16-key warp tile (tile rows kr0 and kr0 + 8 of
// keys [k0, ...)) over queries q0 + qc + [0, 8 NS): s holds the raw S^T
// scores and becomes P^T, dp holds dP^T and becomes dS^T, and db gains the
// row sums of dS^T (d(score)/d(bias) = 1: dbias_k = sum_q dS). Scores are in
// log2 units, as in the forward kernel; masked entries give exactly 0.
// `full`: the tile pair has a masked entry.
template <int NS>
__device__ __forceinline__ void probs_and_ds(
    const FlashArgs& a, float (&s)[NS][4], float (&dp)[NS][4], float (&db)[2],
    const float* lt, const float* dlt, const int* sqt, const float* Kb,
    const int* Sk, bool full, int q0, int qc, int k0, int kr0, int t2) {
  const float sl = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = qc + j * 8 + t2 + (e & 1);
      const float x = s[j][e] * sl;
      float p, ds;
      if (full) {
        const int kr = kr0 + 8 * r;
        const float xm = mask_score(
            x, a.bias != nullptr, Kb[kr], a.seg_q != nullptr, sqt[col],
            Sk[kr],
            visible(q0 + col, k0 + kr, a.tq, a.tk, a.causal, a.offset));
        p = xm > kNegInf * 0.5f ? ex2(xm - lt[col]) : 0.f;
        ds = p > 0.f ? p * (dp[j][e] - dlt[col]) : 0.f;
      } else {
        p = ex2(x - lt[col]);
        ds = p * (dp[j][e] - dlt[col]);
      }
      s[j][e] = p;
      dp[j][e] = ds;
      db[r] += ds;
    }
  }
}

// Writes this lane's rows kp0 and kp0 + 8 of dK (times scale: dK =
// dS^T (q * scale), the scale applied once, here), dV and dbias.
template <int NO>
__device__ __forceinline__ void store_dk_dv(const FlashArgs& a,
                                            const float (&dk)[NO][4],
                                            const float (&dv)[NO][4],
                                            const float (&db)[2], int bh,
                                            int kp0, int t2) {
  const size_t koff = (size_t)bh * a.tk * a.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dbr = quad_sum(db[r]);
    const int kp = kp0 + 8 * r;
    if (kp < a.tk) {
      bf16* dkrow = static_cast<bf16*>(a.dk) + koff + (size_t)kp * a.d;
      bf16* dvrow = static_cast<bf16*>(a.dv) + koff + (size_t)kp * a.d;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + t2;
        if (col < a.d) {
          *reinterpret_cast<__nv_bfloat162*>(dkrow + col) =
              __floats2bfloat162_rn(dk[j][2 * r] * a.scale,
                                    dk[j][2 * r + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvrow + col) =
              __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
        }
      }
      if (a.dbias != nullptr && t2 == 0)
        a.dbias[(size_t)bh * a.tk + kp] = dbr;
    }
  }
}

// The wgmma kernel at head dims up to HD (64 or 128; columns past d are
// zero). S^T and dP^T read both operands from shared memory; dV and dK take
// P^T and dS^T from registers and dO and Q through transposed (MN-major)
// descriptors, one 64-column part of dV and dK at a time.
template <int HD>
struct WgDkvTiles {
  static constexpr int BK = 64, BQ = 64;
  static constexpr int NH = HD / 64;        // 64-column parts
  static constexpr int TILE = NH * kPart;   // bytes of one K, V, Q or dO tile
  // Queries per pass of the products: at d 128 the dK and dV accumulators
  // alone take 128 registers, so S^T and dP^T are taken 32 queries at a
  // time (wgmma n32) to keep everything in registers.
  static constexpr int QC = HD <= 64 ? 64 : 32;
  // alignment slack | K | V | Q[2] | dO[2] | lse * log2(e) [2] | delta [2]
  // | q segment ids [2] | key bias * log2(e) | key segment ids
  static constexpr int SMEM = 1024 + 6 * TILE + 2 * BQ * 12 + BK * 8;
  // Blocks per SM the registers are held to (at most 168 a thread at d 64,
  // where shared memory would allow 4); at 2 blocks the kernel takes ~28 %
  // longer.
  static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : 2;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, WgDkvTiles<HD>::MIN_BLOCKS)
    flash_bwd_dkv_wg_kernel(FlashArgs a) {
  using Tl = WgDkvTiles<HD>;
  constexpr int BK = Tl::BK, BQ = Tl::BQ, NH = Tl::NH, TILE = Tl::TILE;
  constexpr int QC = Tl::QC, NS = QC / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  // The swizzle pattern is a function of the address: tiles start on
  // 1024-byte boundaries.
  const uint32_t raw = smem_u32(smem), base = (raw + 1023) & ~1023u;
  unsigned char* Ks = smem + (base - raw);
  unsigned char* Vs = Ks + TILE;
  unsigned char* Qs = Vs + TILE;
  unsigned char* Ds = Qs + 2 * TILE;
  float* Ls = reinterpret_cast<float*>(Ds + 2 * TILE);
  float* Dl = Ls + 2 * BQ;
  int* Sq = reinterpret_cast<int*>(Dl + 2 * BQ);
  float* Kb = reinterpret_cast<float*>(Sq + 2 * BQ);
  int* Sk = reinterpret_cast<int*>(Kb + BK);

  const int bh = blockIdx.x, b = bh / a.heads, k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Tile row of accumulator entries 0, 1; entries 2, 3 are kr0 + 8.
  const int kr0 = warp * 16 + (lane >> 2), t2 = (lane & 3) * 2;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const size_t qoff = (size_t)bh * tq * d, koff = (size_t)bh * tk * d;
  const bf16* qh = static_cast<const bf16*>(a.q) + qoff;
  const bf16* doh = static_cast<const bf16*>(a.dout) + qoff;

  const int qt0 = first_q_tile(k0, BQ, a.causal, a.offset);
  const int nqt = (tq + BQ - 1) / BQ;
  load_tile_sw128_async<BK, NH>(Ks, static_cast<const bf16*>(a.k) + koff,
                                k0, tk, d);
  load_tile_sw128_async<BK, NH>(Vs, static_cast<const bf16*>(a.v) + koff,
                                k0, tk, d);
  if (qt0 < nqt)
    stage_q<BQ, NH>(a, qh, doh, bh, b, qt0 * BQ, Qs, Ds, Ls, Dl, Sq);
  cp_async_commit();
  stage_keys<BK>(a, b, k0, Kb, Sk);

  float dk[NO][4], dv[NO][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }
  const uint64_t kdesc = sw128_desc(base), vdesc = sw128_desc(base + TILE);

  for (int qt = qt0; qt < nqt; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * BQ;
    if (qt + 1 < nqt)
      stage_q<BQ, NH>(a, qh, doh, bh, b, q0 + BQ, Qs + (buf ^ 1) * TILE,
                      Ds + (buf ^ 1) * TILE, Ls + (buf ^ 1) * BQ,
                      Dl + (buf ^ 1) * BQ, Sq + (buf ^ 1) * BQ);
    cp_async_commit();
    cp_async_wait<1>();  // q tile qt (and K, V) have landed
    fence_proxy_async();
    __syncthreads();
    const uint64_t qdesc = sw128_desc(base + (2 + buf) * TILE);
    const uint64_t odesc = sw128_desc(base + (4 + buf) * TILE);
    const bool full = tile_has_mask(a, q0, BQ, k0, BK);

#pragma unroll 1
    for (int qc = 0; qc < BQ; qc += QC) {
      // S^T = K Q^T and dP^T = V dO^T (fp32) over queries [qc, qc + QC):
      // HD / 16 k16 steps along the head dim; query row qc starts qc * 128
      // bytes into each part.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      const int row = qc * 128 >> 4;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        wgmma_ss(reinterpret_cast<float(&)[NS * 4]>(s),
                 kmajor_step(kdesc, kc), kmajor_step(qdesc, kc) + row);
        wgmma_ss(reinterpret_cast<float(&)[NS * 4]>(dp),
                 kmajor_step(vdesc, kc), kmajor_step(odesc, kc) + row);
      }
      wgmma_commit_wait();
      probs_and_ds(a, s, dp, db, Ls + buf * BQ, Dl + buf * BQ,
                   Sq + buf * BQ, Kb, Sk, full, q0, qc, k0, kr0, t2);

      // dV += P^T dO and dK += dS^T Q, P and dS as hi + lo: k16 steps of
      // 16 queries, 2048 bytes apart, into each 64-column part.
      uint32_t ph[QC / 16][4], pl[QC / 16][4], sh[QC / 16][4],
          slo[QC / 16][4];
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        acc_to_a_split(s[2 * kc], s[2 * kc + 1], ph[kc], pl[kc]);
        acc_to_a_split(dp[2 * kc], dp[2 * kc + 1], sh[kc], slo[kc]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int step = h * (kPart >> 4) + 128 * (qc / 16 + kc);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dv[8 * h]), ph[kc],
                     odesc + step);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dv[8 * h]), pl[kc],
                     odesc + step);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dk[8 * h]), sh[kc],
                     qdesc + step);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dk[8 * h]), slo[kc],
                     qdesc + step);
        }
      }
      wgmma_commit_wait();
    }
    __syncthreads();  // every warp is done with buffer buf
  }
  cp_async_wait<0>();
  store_dk_dv(a, dk, dv, db, bh, k0 + kr0, t2);
}

template <int HD>
static cudaError_t launch_dkv_wg(const FlashArgs& a, int bh,
                                 cudaStream_t st) {
  using Tl = WgDkvTiles<HD>;
  static SmemLimit limit;
  const cudaError_t e = limit.raise(
      reinterpret_cast<const void*>(flash_bwd_dkv_wg_kernel<HD>), Tl::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (a.tk + Tl::BK - 1) / Tl::BK);
  flash_bwd_dkv_wg_kernel<HD><<<grid, kThreads, Tl::SMEM, st>>>(a);
  return cudaSuccess;
}

static cudaError_t launch_dkv_bf16(const FlashArgs& a, int bh,
                                   cudaStream_t st) {
  return a.d <= 64 ? launch_dkv_wg<64>(a, bh, st)
                   : launch_dkv_wg<128>(a, bh, st);
}

// ---------------------------------------------------------------- dQ bf16

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
    Sb[j] = (a.seg_k != nullptr && ok) ? a.seg_k[(size_t)b * a.tk + kp] : 0;
  }
}

// P = 2^(S - lse) and dS = P (dP - delta), in place, on this lane's
// accumulators of a 16-query warp tile (rows qp0 and qp0 + 8) over keys
// k0 + kc + [0, 8 NS): s holds the raw S scores and becomes P, dp holds dP
// and becomes dS. Scores are in log2 units, lse2 is lse * log2(e); masked
// entries give exactly 0. `full`: the tile pair has a masked entry.
template <int NS>
__device__ __forceinline__ void probs_and_ds_rows(
    const FlashArgs& a, float (&s)[NS][4], float (&dp)[NS][4],
    const float (&lse2)[2], const float (&dl)[2], const int (&sq)[2],
    const float* Bt, const int* St, bool full, int qp0, int k0, int kc,
    int t2) {
  const float sl = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = kc + j * 8 + t2 + (e & 1);
      const float x = s[j][e] * sl;
      float p, ds;
      if (full) {
        const float xm = mask_score(
            x, a.bias != nullptr, Bt[col], a.seg_q != nullptr, sq[r],
            St[col],
            visible(qp0 + 8 * r, k0 + col, a.tq, a.tk, a.causal, a.offset));
        p = xm > kNegInf * 0.5f ? ex2(xm - lse2[r]) : 0.f;
        ds = p > 0.f ? p * (dp[j][e] - dl[r]) : 0.f;
      } else {
        p = ex2(x - lse2[r]);
        ds = p * (dp[j][e] - dl[r]);
      }
      s[j][e] = p;
      dp[j][e] = ds;
    }
  }
}

// The wgmma kernel at head dims up to HD (64 or 128; columns past d are
// zero). S = Q K^T and dP = dO V^T read both operands from shared memory;
// dQ += dS K takes dS from registers and K through a transposed (MN-major)
// descriptor, one 64-column part of dQ at a time, exactly as the forward
// kernel's O += P V takes V.
template <int HD>
struct WgDqTiles {
  static constexpr int BQ = 64, BK = 64;
  static constexpr int NH = HD / 64;        // 64-column parts
  static constexpr int TILE = NH * kPart;   // bytes of one Q, dO, K or V tile
  // Keys per pass of the products: at d 128 dQ alone takes 64 registers, so
  // S and dP are taken 32 keys at a time (wgmma n32) to keep everything in
  // registers.
  static constexpr int KC = HD <= 64 ? 64 : 32;
  // alignment slack | Q | dO | K[2] | V[2] | key bias * log2(e) [2] | key
  // segment ids [2]
  static constexpr int SMEM = 1024 + 6 * TILE + 2 * BK * 8;
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wg_kernel(
    FlashArgs a) {
  using Tl = WgDqTiles<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, NH = Tl::NH, TILE = Tl::TILE;
  constexpr int KC = Tl::KC, NS = KC / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  // The swizzle pattern is a function of the address: tiles start on
  // 1024-byte boundaries.
  const uint32_t raw = smem_u32(smem), base = (raw + 1023) & ~1023u;
  unsigned char* Qs = smem + (base - raw);
  unsigned char* Ds = Qs + TILE;
  unsigned char* Ks = Ds + TILE;
  unsigned char* Vs = Ks + 2 * TILE;
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TILE);
  int* Ss = reinterpret_cast<int*>(Bs + 2 * BK);

  const int bh = blockIdx.x, b = bh / a.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qp0 = q0 + warp * 16 + (lane >> 2), t2 = (lane & 3) * 2;
  const int tq = a.tq, tk = a.tk, d = a.d;
  const size_t qoff = (size_t)bh * tq * d, koff = (size_t)bh * tk * d;
  const bf16* kh = static_cast<const bf16*>(a.k) + koff;
  const bf16* vh = static_cast<const bf16*>(a.v) + koff;

  const int nkt = k_tiles_needed(q0, BQ, BK, tk, a.causal, a.offset);
  load_tile_sw128_async<BQ, NH>(Qs, static_cast<const bf16*>(a.q) + qoff, q0,
                                tq, d);
  load_tile_sw128_async<BQ, NH>(Ds, static_cast<const bf16*>(a.dout) + qoff,
                                q0, tq, d);
  if (nkt > 0) stage_kv<BK, NH>(a, kh, vh, b, 0, Ks, Vs, Bs, Ss);
  cp_async_commit();

  int sq[2];
  load_row_segs(a, b, qp0, sq);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    const bool ok = qp < tq;
    lse2[r] = ok ? a.lse_in[(size_t)bh * tq + qp] * kLog2e : 0.f;
    dl[r] = ok ? a.delta[(size_t)bh * tq + qp] : 0.f;
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const uint64_t qdesc = sw128_desc(base), odesc = sw128_desc(base + TILE);

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    if (kt + 1 < nkt)
      stage_kv<BK, NH>(a, kh, vh, b, k0 + BK, Ks + (buf ^ 1) * TILE,
                       Vs + (buf ^ 1) * TILE, Bs + (buf ^ 1) * BK,
                       Ss + (buf ^ 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // k tile kt (and Q, dO) have landed
    fence_proxy_async();
    __syncthreads();
    const uint64_t kdesc = sw128_desc(base + (2 + buf) * TILE);
    const uint64_t vdesc = sw128_desc(base + (4 + buf) * TILE);
    const bool full = tile_has_mask(a, q0, BQ, k0, BK);

#pragma unroll 1
    for (int kc = 0; kc < BK; kc += KC) {
      // S = Q K^T and dP = dO V^T (fp32) over keys [kc, kc + KC): HD / 16
      // k16 steps along the head dim; key row kc starts kc * 128 bytes into
      // each part.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      const int row = kc * 128 >> 4;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        wgmma_ss(reinterpret_cast<float(&)[NS * 4]>(s), kmajor_step(qdesc, c),
                 kmajor_step(kdesc, c) + row);
        wgmma_ss(reinterpret_cast<float(&)[NS * 4]>(dp),
                 kmajor_step(odesc, c), kmajor_step(vdesc, c) + row);
      }
      wgmma_commit_wait();
      probs_and_ds_rows(a, s, dp, lse2, dl, sq, Bs + buf * BK, Ss + buf * BK,
                        full, qp0, k0, kc, t2);

      // dQ += dS K, dS as hi + lo: k16 steps of 16 keys, 2048 bytes apart,
      // into each 64-column part.
      uint32_t sh[KC / 16][4], slo[KC / 16][4];
#pragma unroll
      for (int c = 0; c < KC / 16; ++c)
        acc_to_a_split(dp[2 * c], dp[2 * c + 1], sh[c], slo[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < KC / 16; ++c) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t kd = kdesc + h * (kPart >> 4) + 128 * (kc / 16 + c);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dq[8 * h]), sh[c], kd);
          wgmma_rs_t(reinterpret_cast<float(&)[32]>(dq[8 * h]), slo[c], kd);
        }
      }
      wgmma_commit_wait();
    }
    __syncthreads();  // every warp is done with buffer buf
  }
  cp_async_wait<0>();

  // dQ = scale * sum_k dS K, as the reference scales it once at the end.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qp0 + 8 * r;
    if (qp < tq) {
      bf16* row = static_cast<bf16*>(a.dq) + qoff + (size_t)qp * d;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + t2;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(dq[j][2 * r] * a.scale,
                                    dq[j][2 * r + 1] * a.scale);
      }
    }
  }
}

template <int HD>
static cudaError_t launch_dq_wg(const FlashArgs& a, int bh, cudaStream_t st) {
  using Tl = WgDqTiles<HD>;
  static SmemLimit limit;
  const cudaError_t e = limit.raise(
      reinterpret_cast<const void*>(flash_bwd_dq_wg_kernel<HD>), Tl::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (a.tq + Tl::BQ - 1) / Tl::BQ);
  flash_bwd_dq_wg_kernel<HD><<<grid, kThreads, Tl::SMEM, st>>>(a);
  return cudaSuccess;
}

static cudaError_t launch_dq_bf16(const FlashArgs& a, int bh,
                                  cudaStream_t st) {
  return a.d <= 64 ? launch_dq_wg<64>(a, bh, st) : launch_dq_wg<128>(a, bh, st);
}

static bool bad_shape(int bh, int tq, int tk, int d, int heads, int dtype) {
  return bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
         heads <= 0 || bh % heads != 0 || (dtype != 0 && dtype != 1) ||
         (tq + 31) / 32 > 65535 || (tk + 31) / 32 > 65535;
}

static bool bad_segs(const void* seg_q, const void* seg_k) {
  return (seg_q == nullptr) != (seg_k == nullptr);
}

static FlashArgs make_args(const void* q, const void* k, const void* v,
                           const void* bias, const void* seg_q,
                           const void* seg_k,
                           const void* dout, const void* lse,
                           const void* delta, int tq, int tk, int d,
                           int heads, float scale, int causal, int offset) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.heads = heads;
  a.causal = causal;
  a.offset = offset;
  a.scale = scale;
  return a;
}

}  // namespace hvdflash

// C interface, loaded with ctypes. dtype: 0 = fp32 (FMA kernels), 1 = bf16
// (tensor-core kernels). Each returns the cudaError_t of its launch (0 on
// success).
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* seg_q,
                                const void* seg_k, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int bh, int tq, int tk, int d, int heads,
                                float scale, int causal, int offset,
                                int dtype, void* stream) {
  using namespace hvdflash;
  if (bad_shape(bh, tq, tk, d, heads, dtype) || bad_segs(seg_q, seg_k))
    return (int)cudaErrorInvalidValue;
  FlashArgs a = make_args(q, k, v, bias, seg_q, seg_k, dout, lse, delta, tq,
                          tk, d, heads, scale, causal, offset);
  a.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const cudaError_t e = launch_dq_bf16(a, bh, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    launch_dq_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* seg_q,
                                 const void* seg_k, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, void* dbias, int bh, int tq,
                                 int tk, int d, int heads, float scale,
                                 int causal, int offset, int dtype,
                                 void* stream) {
  using namespace hvdflash;
  if (bad_shape(bh, tq, tk, d, heads, dtype) || bad_segs(seg_q, seg_k))
    return (int)cudaErrorInvalidValue;
  FlashArgs a = make_args(q, k, v, bias, seg_q, seg_k, dout, lse, delta, tq,
                          tk, d, heads, scale, causal, offset);
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const cudaError_t e = launch_dkv_bf16(a, bh, st);
    if (e != cudaSuccess) return (int)e;
  } else {
    launch_dkv_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory, in bytes, of one block of the bf16 dQ and dK/dV
// kernels at head dim d (ptxas reports none for them).
extern "C" int hvd_flash_bwd_dq_smem(int d) {
  using namespace hvdflash;
  return d <= 64 ? WgDqTiles<64>::SMEM : WgDqTiles<128>::SMEM;
}

extern "C" int hvd_flash_bwd_dkv_smem(int d) {
  using namespace hvdflash;
  return d <= 64 ? WgDkvTiles<64>::SMEM : WgDkvTiles<128>::SMEM;
}
