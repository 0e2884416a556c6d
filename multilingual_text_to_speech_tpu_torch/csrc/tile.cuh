// Tensor-core building blocks shared by the port's CUDA sources
// (fused_decoder.cu and fused_train_decoder.cu): 16-byte asynchronous
// copies from device memory into shared memory, ldmatrix fragment loads
// (plain and transposing), the mma.sync products, bf16 m16n8k16 with
// float32 sums and int8 m16n8k32 with int32 sums, and the fused-gate LSTM
// product that both decoders run (gate_tile_kernel, at the end).
//
// The two products read their fragments in the same byte layout: an A
// fragment is rows g and g+8 (g = lane / 4) of a 16-row tile, 4 bytes at
// byte 4 * (lane % 4) of each 16-byte half of a 32-byte slice of K; a B
// fragment is column g, the same bytes.  So one ldmatrix.x4 of four 8 x 16
// byte matrices feeds either product, whatever the element type.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// 16 bytes into shared memory at `smem`: the first `src_bytes` (0 to 16)
// from `gmem`, the rest zero; with 0 nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 (16 bytes, 16-byte aligned); r[j] receives row lane / 4, word
// lane % 4 of matrix j
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* smem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// the same, each matrix transposed: r[j] holds elements (2 * (lane % 4),
// lane / 4) and (2 * (lane % 4) + 1, lane / 4) of matrix j
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* smem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// gate_tile_kernel: the fused-gate LSTM product of both decoders,
//   gates[row, q * H + unit] = sum_k a[row, k] * w[q * H + unit, k]
// for q = 0..3 (i, f, g, o).  a [M, K] and w [4H, K] (K contiguous; rows of
// lda and ldw bytes, 16-byte aligned; K of kbytes bytes, a multiple of 16)
// are the row.col operands of mma.sync as they lie: int8 (m16n8k32, int32
// sums) or bf16 (m16n8k16, float32 sums).
//
// Block: 32 * WM rows x 16 hidden units, whose i, f, g, o weight rows it
// gathers while copying (64 gate columns); WM x 2 warps of 32 rows x 32
// columns.  K walks in stages of GT_BK bytes through a GT_STAGES-deep
// cp.async ring; rows are padded by 16 bytes so that ldmatrix's eight row
// addresses fall in distinct banks.  The gate tile goes back through shared
// memory, and the epilogue epi(row, unit, g) sees the four gate sums g[q]
// of each (row, unit) inside [0, M) x [0, H).
// ---------------------------------------------------------------------------
constexpr int GT_BN = 64, GT_BK = 128, GT_STAGES = 4;
constexpr int GT_LD = GT_BK + 16;   // bytes a staged row
constexpr int GT_CLD = GT_BN + 4;   // words a row of the epilogue tile
constexpr int GT_ROW_CHUNKS = GT_BK / 16;

template <int WM>
struct GateTile {
  static constexpr int BM = 32 * WM, THREADS = 64 * WM;
  static constexpr int STAGE = (BM + GT_BN) * GT_LD;   // bytes
  static constexpr int SMEM = GT_STAGES * STAGE;       // dynamic
  static constexpr int CHUNKS = (BM + GT_BN) * GT_ROW_CHUNKS / THREADS;
  static_assert(BM * GT_CLD * 4 <= SMEM, "the epilogue tile fits the ring");
  static_assert(CHUNKS * THREADS == (BM + GT_BN) * GT_ROW_CHUNKS,
                "whole 16-byte chunks a thread");
};

template <bool INT8, int WM, class Epi>
__global__ void __launch_bounds__(GateTile<WM>::THREADS)
gate_tile_kernel(const uint8_t* __restrict__ a, int lda,
                 const uint8_t* __restrict__ w, int ldw, int kbytes, int M,
                 int H, Epi epi) {
  typedef GateTile<WM> T;
  typedef typename std::conditional<INT8, int, float>::type Acc;
  extern __shared__ __align__(16) uint8_t ring[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * (GT_BN / 4), row0 = blockIdx.y * T::BM;
  const int wm = (warp % WM) * 32, wn = (warp / WM) * 32;
  const int nk = (kbytes + GT_BK - 1) / GT_BK;

  // stage s, K tile kt: BM row slices then GT_BN weight-row slices,
  // GT_ROW_CHUNKS 16-byte chunks each; rows outside [0, M), units outside
  // [0, H) and bytes past K are zero-filled
  auto load = [&](int s, int kt) {
    uint8_t* base = ring + s * T::STAGE;
    const int kb = kt * GT_BK;
#pragma unroll
    for (int j = 0; j < T::CHUNKS; ++j) {
      const int i = tid + j * T::THREADS;
      const int r = i / GT_ROW_CHUNKS, c = (i % GT_ROW_CHUNKS) * 16;
      const bool in_k = kb + c < kbytes;
      if (r < T::BM) {
        const int row = row0 + r;
        const bool ok = in_k && row < M;
        cp_async16(base + r * GT_LD + c,
                   ok ? a + (size_t)row * lda + kb + c : a, ok ? 16 : 0);
      } else {
        const int n = r - T::BM, unit = unit0 + (n & 15);
        const bool ok = in_k && unit < H;
        cp_async16(base + r * GT_LD + c,
                   ok ? w + (size_t)((n >> 4) * H + unit) * ldw + kb + c : w,
                   ok ? 16 : 0);
      }
    }
  };

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < GT_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GT_STAGES - 2>();
    __syncthreads();
    // the slot refilled now was read in the previous iteration, which
    // every thread has finished (the barrier above)
    const int nxt = kt + GT_STAGES - 1;
    if (nxt < nk) load(nxt % GT_STAGES, nxt);
    cp_async_commit();
    const uint8_t* as = ring + (kt % GT_STAGES) * T::STAGE;
    const uint8_t* bs = as + T::BM * GT_LD;
#pragma unroll
    for (int kk = 0; kk < GT_BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], as + (wm + mt * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * GT_LD +
                            kk + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, bs + (wn + np * 16 + (lane & 7) + (lane >> 4) * 8) * GT_LD +
                       kk + ((lane >> 3) & 1) * 16);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (INT8)
            mma_s8(acc[mt][nt], af[mt], bf[nt]);
          else
            mma_bf16(acc[mt][nt], af[mt], bf[nt]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the gate tile through shared memory, so that one thread sees the four
  // gates of a (row, unit)
  Acc* cs = reinterpret_cast<Acc*>(ring);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm + mt * 16 + (lane >> 2);
      const int c = wn + nt * 8 + 2 * (lane & 3);
      cs[r * GT_CLD + c] = acc[mt][nt][0];
      cs[r * GT_CLD + c + 1] = acc[mt][nt][1];
      cs[(r + 8) * GT_CLD + c] = acc[mt][nt][2];
      cs[(r + 8) * GT_CLD + c + 1] = acc[mt][nt][3];
    }
  __syncthreads();

  for (int idx = tid; idx < T::BM * (GT_BN / 4); idx += T::THREADS) {
    const int r = idx >> 4, uu = idx & 15;
    const int row = row0 + r, unit = unit0 + uu;
    if (row >= M || unit >= H) continue;
    Acc g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = cs[r * GT_CLD + q * 16 + uu];
    epi(row, unit, g);
  }
}

template <bool INT8, int WM, class Epi>
cudaError_t gate_tile_run(const void* a, int lda, const void* w, int ldw,
                          int kbytes, int M, int H, const Epi& epi,
                          cudaStream_t stream) {
  typedef GateTile<WM> T;
  // the ring's shared memory may pass the 48 KB default: opt in once
  static const cudaError_t opt_in =
      allow_smem(gate_tile_kernel<INT8, WM, Epi>, T::SMEM);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((H + GT_BN / 4 - 1) / (GT_BN / 4), (M + T::BM - 1) / T::BM);
  gate_tile_kernel<INT8, WM, Epi><<<grid, T::THREADS, T::SMEM, stream>>>(
      (const uint8_t*)a, lda, (const uint8_t*)w, ldw, kbytes, M, H, epi);
  return cudaGetLastError();
}

// Rows a block: 128 above 128 rows, 64 above 32, else 32.  At the main
// paths' batches each weight tile is read by two row blocks (B=240: 128
// blocks, about a wave of the H100's 132 SMs) or one (B=50: 64 blocks of 4
// warps, faster on the H100 than 128 blocks of 2 warps that read it twice).
template <bool INT8, class Epi>
cudaError_t gate_tile_launch(const void* a, int lda, const void* w, int ldw,
                             int kbytes, int M, int H, const Epi& epi,
                             cudaStream_t stream) {
  if (M <= 0 || H <= 0 || kbytes <= 0 || kbytes % 16 != 0 ||
      lda % 16 != 0 || ldw % 16 != 0 || (uintptr_t)a % 16 != 0 ||
      (uintptr_t)w % 16 != 0)
    return cudaErrorInvalidValue;
  if (M > 128)
    return gate_tile_run<INT8, 4>(a, lda, w, ldw, kbytes, M, H, epi, stream);
  if (M > 32)
    return gate_tile_run<INT8, 2>(a, lda, w, ldw, kbytes, M, H, epi, stream);
  return gate_tile_run<INT8, 1>(a, lda, w, ldw, kbytes, M, H, epi, stream);
}

}  // namespace
