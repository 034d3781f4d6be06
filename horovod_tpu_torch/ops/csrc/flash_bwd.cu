// Flash-attention backward for Hopper (sm_90a): dQ, and dK / dV / dbias.
//
// Replaces the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel in
// horovod_tpu/ops/flash_attention.py (launched by _bwd through two
// pl.pallas_call). Both recompute P = exp(S - lse) from the saved per-row
// logsumexp instead of storing P, and dS = P * (dO V^T - delta) with
// delta = rowsum(dO * O) computed outside (plain torch, as in the
// reference). On the TPU the innermost grid axis runs in order and carries
// the accumulators in VMEM; here the dQ kernel gives one block to each
// (bh, q tile) and loops over k tiles, and the dK/dV kernel gives one block
// to each (bh, k tile) and loops over q tiles, so each output row is owned by
// exactly one block and needs no atomics.
//
// What bounds them on an H100: at GPT-2 medium's shapes (BH 128, T 1024,
// d 64, causal) the dQ kernel does ~25.8 GFLOP over ~85 MB and the dK/dV
// kernel ~34.4 GFLOP over ~102 MB, so even with tensor cores (989 TFLOP/s
// bf16, 3.35 TB/s) both would be bound by the operations (~26 and ~35 us;
// the bytes alone take ~25 and ~30 us). This first version multiplies with
// fp32 FMAs on the CUDA cores, so FMA issue and shared-memory reads bound it:
// the tile a block walks over (K and V for dQ, Q and dO for dK/dV) is staged
// once in shared memory and reused by every row of the block, while each
// lane keeps its own row's operands and accumulators in registers.
//
// Masked entries give P == 0 and dS == 0 exactly, whatever the other terms
// hold, as in the reference (0 * garbage must never reach an accumulator).

#include "flash_common.cuh"

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
  const bool has_bias = a.bias != nullptr, has_seg = a.seg != nullptr;

  float qr[32], dor[32], acc[32];
  load_row(qr, static_cast<const T*>(a.q) + qoff, qpos, tq, d, hs * 32,
           a.scale);
  load_row(dor, static_cast<const T*>(a.dout) + qoff, qpos, tq, d, hs * 32,
           1.f);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  const bool qvalid = qpos < tq;
  const int sq = (has_seg && qvalid) ? a.seg[(size_t)b * tq + qpos] : 0;
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
      Ss[j] = (has_seg && kp < tk) ? a.seg[(size_t)b * tk + kp] : 0;
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
  const bool has_bias = a.bias != nullptr, has_seg = a.seg != nullptr;
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
  const int sk = (has_seg && kvalid) ? a.seg[(size_t)b * tk + kpos] : 0;

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
      Sq[i] = (has_seg && ok) ? a.seg[(size_t)b * tq + qp] : 0;
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

static bool bad_shape(int bh, int tq, int tk, int d, int heads, int dtype) {
  return bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 || d % 8 != 0 ||
         heads <= 0 || bh % heads != 0 || (dtype != 0 && dtype != 1) ||
         (tq + 31) / 32 > 65535 || (tk + 31) / 32 > 65535;
}

static FlashArgs make_args(const void* q, const void* k, const void* v,
                           const void* bias, const void* seg,
                           const void* dout, const void* lse,
                           const void* delta, int tq, int tk, int d,
                           int heads, float scale, int causal, int offset) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seg = static_cast<const int*>(seg);
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

// C interface, loaded with ctypes. dtype: 0 = fp32, 1 = bf16. Each returns
// the cudaError_t of its launch (0 on success).
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* seg,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int bh, int tq,
                                int tk, int d, int heads, float scale,
                                int causal, int offset, int dtype,
                                void* stream) {
  using namespace hvdflash;
  if (bad_shape(bh, tq, tk, d, heads, dtype))
    return (int)cudaErrorInvalidValue;
  FlashArgs a = make_args(q, k, v, bias, seg, dout, lse, delta, tq, tk, d,
                          heads, scale, causal, offset);
  a.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_dq_hd<__nv_bfloat16>(a, bh, st);
  } else {
    launch_dq_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, const void* seg,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 void* dbias, int bh, int tq, int tk, int d,
                                 int heads, float scale, int causal,
                                 int offset, int dtype, void* stream) {
  using namespace hvdflash;
  if (bad_shape(bh, tq, tk, d, heads, dtype))
    return (int)cudaErrorInvalidValue;
  FlashArgs a = make_args(q, k, v, bias, seg, dout, lse, delta, tq, tk, d,
                          heads, scale, causal, offset);
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch_dkv_hd<__nv_bfloat16>(a, bh, st);
  } else {
    launch_dkv_hd<float>(a, bh, st);
  }
  return (int)cudaGetLastError();
}
