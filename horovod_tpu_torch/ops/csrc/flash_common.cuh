// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout and conventions, common to the three kernels:
// - q, k, v, dO, O, dQ, dK, dV are (BH, T, d) row-major, BH = batch * heads,
//   in fp32 or bf16. lse and delta are (BH, Tq) fp32; key_bias is (B, Tk)
//   fp32, segment ids (B, T) int32, dbias (BH, Tk) fp32.
// - A block runs kThreads threads. A row of the tile a block owns (a query
//   row for the forward and dQ kernels, a key row for dK/dV) belongs to NS =
//   HD / 32 neighbouring lanes; each lane keeps 32 of the HD columns of that
//   row in registers. A dot product over HD is the lane's partial sum over
//   its 32 columns, then a butterfly of NS - 1 shuffles; every lane of the
//   group ends with the same bits, so the softmax that follows is computed
//   redundantly and needs no further exchange.
// - HD is the head dim rounded up to 32, 64 or 128; columns past the real
//   head dim d are zero in every tile, so they add nothing to any product.
// - Scores and every accumulator are fp32. The masking constant, the
//   order of bias / segment / position masking and the "a masked entry
//   contributes exactly 0" rules are those of the TPU kernels
//   (horovod_tpu/ops/flash_attention.py: _mask_scores, _zero_oob_rows).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdflash {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;     // (B, Tk) or null
  const int* seg;        // (B, T) or null
  const void* dout;      // backward only
  const float* lse_in;   // backward only
  const float* delta;    // backward only
  void* o;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* dbias;          // (BH, Tk) or null
  int tq, tk, d, heads, causal, offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// An fp32 tile of `rows` rows and HD columns in shared memory. Each
// 32-column group of a row is followed by 4 spare words, so the NS lanes of
// a row group, which read the same row at column offsets 32 apart, land on
// different banks.
template <int HD>
struct Tile {
  static constexpr int NS = HD / 32;
  static constexpr int STRIDE = NS * 36;
  __device__ __forceinline__ static int at(int row, int col) {
    return row * STRIDE + (col >> 5) * 36 + (col & 31);
  }
};

// Sum over the NS lanes that share a row (NS divides 32, lanes adjacent).
template <int NS>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < NS; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + rows) of a (t, d) matrix into a tile, times `mul`.
// Rows past t and columns past d are written as 0, so nothing read past the
// end of the sequence ever meets a product.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int t, int d, float mul) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = row0 + r;
    float x = 0.f;
    if (row < t && c < d) x = to_f(src[(size_t)row * d + c]) * mul;
    dst[Tile<HD>::at(r, c)] = x;
  }
}

// The lane's 32 columns [col0, col0 + 32) of one row, times `mul`; zero
// past t or d.
template <typename T>
__device__ __forceinline__ void load_row(float (&dst)[32], const T* src,
                                         int row, int t, int d, int col0,
                                         float mul) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = col0 + c;
    dst[c] = (row < t && col < d) ? to_f(src[(size_t)row * d + col]) * mul
                                  : 0.f;
  }
}

// Partial dot product of the lane's 32 register columns with its 32
// columns of tile row `row`.
template <int HD>
__device__ __forceinline__ float dot_row(const float (&r)[32],
                                         const float* tile, int row, int hs) {
  const float4* p = reinterpret_cast<const float4*>(
      tile + row * Tile<HD>::STRIDE + hs * 36);
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x = p[c];
    a = fmaf(r[4 * c], x.x, a);
    a = fmaf(r[4 * c + 1], x.y, a);
    a = fmaf(r[4 * c + 2], x.z, a);
    a = fmaf(r[4 * c + 3], x.w, a);
  }
  return a;
}

// acc += w * (the lane's 32 columns of tile row `row`).
template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[32], float w,
                                         const float* tile, int row, int hs) {
  const float4* p = reinterpret_cast<const float4*>(
      tile + row * Tile<HD>::STRIDE + hs * 36);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x = p[c];
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

// Whether query qpos may see key kpos: both inside their sequences and, when
// causal, qpos + offset >= kpos (offset -1 is strict causal).
__device__ __forceinline__ bool visible(int qpos, int kpos, int tq, int tk,
                                        int causal, int offset) {
  return qpos < tq && kpos < tk && (!causal || qpos + offset >= kpos);
}

// One masked score, in the order of _mask_scores: + key bias, then the
// segment mask, then the position mask, each masked entry set to kNegInf.
__device__ __forceinline__ float mask_score(float s, bool has_bias,
                                            float bias, bool has_seg, int sq,
                                            int sk, bool vis) {
  if (has_bias) s += bias;
  if (has_seg && sq != sk) s = kNegInf;
  return vis ? s : kNegInf;
}

// Number of k tiles of width bk that a q tile [q0, q0 + bq) needs: every
// tile at or past the first whole tile above the (offset-shifted) diagonal
// holds no visible entry and is skipped.
__host__ __device__ __forceinline__ int k_tiles_needed(int q0, int bq, int bk,
                                                       int tk, int causal,
                                                       int offset) {
  int n = (tk + bk - 1) / bk;
  if (causal) {
    const long long lim = (long long)q0 + bq + offset;  // k_pos < lim
    const long long need = lim <= 0 ? 0 : (lim + bk - 1) / bk;
    if (need < n) n = (int)need;
  }
  return n;
}

// First q tile of height bq that can see any key of [k0, ...) when causal.
__host__ __device__ __forceinline__ int first_q_tile(int k0, int bq,
                                                     int causal, int offset) {
  if (!causal) return 0;
  const long long x = (long long)k0 - offset;  // need q_pos >= x
  return x <= 0 ? 0 : (int)(x / bq);
}

}  // namespace hvdflash
