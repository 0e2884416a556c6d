// Tensor-core building blocks shared by the port's CUDA sources
// (fused_decoder.cu and fused_train_decoder.cu): 16-byte asynchronous
// copies from device memory into shared memory, ldmatrix fragment loads
// (plain and transposing), the mma.sync products, bf16 m16n8k16 with
// float32 sums, int8 m16n8k32 with int32 sums and float32 as three TF32
// m16n8k8 passes (mma_tf32x3), the thread-block-cluster helpers, and the
// two tile routines that both decoders run: the fused-gate LSTM product
// (gate_tile_kernel, its float32 instance split over a cluster) and the
// split-K product of every other weight (splitk_kernel and its float32
// instance splitk_f32_kernel, with the frame and stop head's epilogue
// HeadOut), each templated on its epilogue; then the forward prenet of
// both decoders (prenet_tile_kernel, clustered, templated on its
// epilogue), the location-conv band routine of the attention kernels
// (band_*) and the forward attention's context sum (ctx_*).
//
// The products read their fragments in the same byte layout: an A fragment
// is rows g and g+8 (g = lane / 4) of a 16-row tile, 4 bytes at byte 4 *
// (lane % 4) of each 16-byte half of a 32-byte slice of K; a B fragment is
// column g, the same bytes.  So one ldmatrix.x4 of four 8 x 16 byte
// matrices feeds any of them, whatever the element type.

#pragma once

#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

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

// one float, 4-byte aligned at both ends
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
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

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The float32 products of both decoders' float32 instances (the TPU
// kernels' float32 matmuls take precision=None: full float32,
// ops/pallas_decoder.py:398-412, ops/pallas_train_decoder.py:230-237) on
// the tensor cores in three TF32 passes (3xTF32).  Each float32 operand x
// is split in registers into hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, ties away, as cvt.rna.tf32.f32; x - hi is exact), and
//   a * b ~ a_lo * b_hi + a_hi * b_lo + a_hi * b_hi
// accumulates, small terms first, into float32 fragments of
// mma.sync.m16n8k8.tf32.  What is left out, a_lo * b_lo and the rounding
// of lo, is about 2^-22 of |a * b| (tests/test_torch_tf32x3.py emulates the
// split against a float64 product at the decoders' shapes).  One TF32 pass
// (10-bit mantissas) or bf16 operands would be off by about 1e-3 of the
// largest output, which chip_smoke.py's 1e-5 check fails.  The tensor
// cores' float32 sums are not IEEE's: summed over a whole K of 2368 the
// gates drifted by 1.1e-5 of the largest (PERF.md).  So the passes of each
// ring stage accumulate in a zeroed fragment, which tf32x3_promote adds to
// the float32 sums on the CUDA cores.
//
// The m16n8k8 fragments (g = lane / 4, t = lane % 4): A a[0..3] = (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4) of a 16 x 8 tile; B b[0..1] = (k
// t, n g), (k t + 4, n g); C as m16n8k16's.  With k contiguous, a 32-byte
// K slice of float32 is 8 k values, and the ldmatrix.x4 of the bf16
// products (the byte layout above) returns word t of row g of each 8 x 16
// byte matrix: exactly these fragments, from the same addresses.
// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (half of the 13
// dropped bits added to the magnitude, then cleared), in two integer
// operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x[i] (float32 bits) -> hi[i] + lo[i], TF32 values in float32 bits; hi
// may be x itself
template <int N>
__device__ __forceinline__ void tf32_split(uint32_t* hi, uint32_t* lo,
                                           const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float v = __uint_as_float(x[i]);
    hi[i] = tf32_rna(v);
    lo[i] = tf32_rna(v - __uint_as_float(hi[i]));
  }
}

// c += a * b over one m16n8k8 tile in three TF32 passes, small terms first
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// acc += stage, then stage = 0: a ring stage's passes added to the float32
// sums
__device__ __forceinline__ void tf32x3_promote(float (*acc)[4][4],
                                               float (*stage)[4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] += stage[i][j][q];
        stage[i][j][q] = 0.0f;
      }
}

// a warp's 32 x 32 tile over one 8-deep K step: acc[mt][nt] += A rows
// 16 mt .. 16 mt + 16 (fragments a[mt], float32 bits) times B columns 8 nt
// .. 8 nt + 8 (b[nt]); a and b are split in place
__device__ __forceinline__ void warp_tf32x3(float (*acc)[4][4],
                                            uint32_t (*a)[4],
                                            uint32_t (*b)[2]) {
  uint32_t a_lo[2][4], b_lo[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) tf32_split<4>(a[mt], a_lo[mt], a[mt]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) tf32_split<2>(b[nt], b_lo[nt], b[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_tf32x3(acc[mt][nt], a[mt], a_lo[mt], b[nt], b_lo[nt]);
}

// The float32 products of the prenet kernels (K1's and K2's forward
// prenet_tile_kernel<Epi, float>, K3's bwd_prenet_kernel<float>): a 16-row
// float32 tile A [16][lda] times B over K = kp (a multiple of 8) and n
// columns (a multiple of 8), on mma.sync m16n8k8 TF32 in three passes.  A
// warp takes an (n8 tile, K slice) pair, K split over the warps that the n8
// tiles leave (tf32x3_splits: at n = 32, 4 tiles x 2 slices; at n = 16, 2 x
// 4), so that all the CTA's warps run short chains; each pass and each
// k-step parity sums in an accumulator of its own (six chains of at most
// kp / 16 dependent mma.sync); both operands are split into their TF32
// halves in registers where they are read (each value is read by one or two
// warps once: a split copy would double the tiles and cost the deepest
// prenet that a CTA's shared memory holds); each warp's 16 x 8 partial goes
// to part[slice][16][n], and tf32x3_kslice_sum adds the slices in K order,
// so a run repeats bit for bit.
//
// B is "KN" ([K][ldb], the forward prenet's W[:, cols] slice) or "NK" ([n]
// [ldb], the backward's W rows).  "NK" takes the m16n8k8 fragments as they
// are: lane (g, t) (g = lane / 4, t = lane % 4) reads A's and B's words at
// k0 + t and k0 + t + 4, one word each, in 32 distinct banks at rows of 4
// words mod 32.  A "KN" B fragment read so would take rows k0 + t and k0 +
// t + 4 of column n0 + g, two-way conflicted at rows of np + 4 words.  So
// "KN" takes the k values of an 8-deep step in pairs, on A and B alike (the
// same product): the fragment's slot t holds k0 + 2t and slot t + 4 holds
// k0 + 2t + 1.  B's words then come from rows k0 + 2t and k0 + 2t + 1,
// banks 8t + g (or 24t + g) plus a constant at ldb = np + 4, np a multiple
// of 8: 32 distinct; A's two words of a row are one 8-byte read, each
// half-warp's in 32 distinct banks at rows of 8 words mod 32
// (tests/test_torch_tf32x3.py).
__host__ __device__ inline int tf32x3_splits(int n, int warps) {
  return n / 8 < warps ? warps / (n / 8) : 1;
}

// the K slice [k_lo, k_hi) (multiples of 8) of a warp's 16 x 8 tile at
// columns n0: sum[e] of rows g + 8 (e >> 1), columns n0 + 2t + (e & 1)
template <bool B_KN>
__device__ __forceinline__ void warp_tf32x3_kslice(float* sum, const float* a,
                                                   int lda, const float* b,
                                                   int ldb, int n0, int k_lo,
                                                   int k_hi, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ar = a + (size_t)g * lda + (B_KN ? 2 * t : t);
  const float* br = B_KN ? b + (size_t)(2 * t) * ldb + n0 + g
                         : b + (size_t)(n0 + g) * ldb + t;
  // acc[parity][pass]: a_lo b_hi, a_hi b_lo, a_hi b_hi
  float acc[2][3][4] = {};
  auto step = [&](int k, float (*c)[4]) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    if constexpr (B_KN) {
      const float2 a0 = *reinterpret_cast<const float2*>(ar + k);
      const float2 a8 = *reinterpret_cast<const float2*>(ar + 8 * lda + k);
      ah[0] = __float_as_uint(a0.x);
      ah[1] = __float_as_uint(a8.x);
      ah[2] = __float_as_uint(a0.y);
      ah[3] = __float_as_uint(a8.y);
      bh[0] = __float_as_uint(br[(size_t)k * ldb]);
      bh[1] = __float_as_uint(br[(size_t)(k + 1) * ldb]);
    } else {
      ah[0] = __float_as_uint(ar[k]);
      ah[1] = __float_as_uint(ar[8 * lda + k]);
      ah[2] = __float_as_uint(ar[k + 4]);
      ah[3] = __float_as_uint(ar[8 * lda + k + 4]);
      bh[0] = __float_as_uint(br[k]);
      bh[1] = __float_as_uint(br[k + 4]);
    }
    tf32_split<4>(ah, al, ah);
    tf32_split<2>(bh, bl, bh);
    mma_tf32(c[0], al, bh);
    mma_tf32(c[1], ah, bl);
    mma_tf32(c[2], ah, bh);
  };
  int k = k_lo;
  for (; k + 8 < k_hi; k += 16) {
    step(k, acc[0]);
    step(k + 8, acc[1]);
  }
  if (k < k_hi) step(k, acc[0]);
  // the small terms first, then the hi products
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sum[e] = ((acc[0][0][e] + acc[0][1][e]) + (acc[1][0][e] + acc[1][1][e])) +
             (acc[0][2][e] + acc[1][2][e]);
}

// every warp's K partials of A [16][lda] @ B over kp and n columns into
// part [slice][16][n]; the caller synchronizes before tf32x3_kslice_sum
template <bool B_KN>
__device__ __forceinline__ void tf32x3_kslices(float* part, const float* a,
                                               int lda, const float* b,
                                               int ldb, int n, int kp,
                                               int warp, int warps,
                                               int lane) {
  const int tiles = n / 8, splits = tf32x3_splits(n, warps);
  const int kslice = (kp / splits + 7) / 8 * 8;
  for (int pair = warp; pair < tiles * splits; pair += warps) {
    const int nt = pair % tiles, ks = pair / tiles;
    const int k_lo = min(kp, ks * kslice), k_hi = min(kp, k_lo + kslice);
    float sum[4];
    warp_tf32x3_kslice<B_KN>(sum, a, lda, b, ldb, nt * 8, k_lo, k_hi, lane);
    float* p = part + (size_t)ks * 16 * n + nt * 8 + 2 * (lane & 3);
    *reinterpret_cast<float2*>(p + (lane >> 2) * n) =
        make_float2(sum[0], sum[1]);
    *reinterpret_cast<float2*>(p + ((lane >> 2) + 8) * n) =
        make_float2(sum[2], sum[3]);
  }
}

// output o = r * n + c of the product: its K slices' partials in K order
__device__ __forceinline__ float tf32x3_kslice_sum(const float* part, int n,
                                                   int warps, int o) {
  const int splits = tf32x3_splits(n, warps);
  float acc = part[o];
  for (int ks = 1; ks < splits; ++ks) acc += part[(size_t)ks * 16 * n + o];
  return acc;
}

// ---------------------------------------------------------------------------
// Thread block clusters: a split barrier (arrive, then wait) across the
// CTAs of a cluster, and a launch with a cluster size chosen at run time.
// arrive releases this CTA's shared-memory writes to the cluster, wait
// acquires the others'; a CTA whose shared memory its peers read must not
// exit before they have arrived.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the same shared-memory variable of CTA `rank` of this cluster
template <class T>
__device__ __forceinline__ const T* cluster_peer(const T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// One-way messages over distributed shared memory: a CTA stores into a
// peer's shared memory with st.async, which counts its bytes on the peer's
// mbarrier (complete_tx); the peer waits on its own mbarrier, whose phase
// completes once every byte it expects (expect_tx at init) has landed.
// The mbarriers are initialized and armed before a cluster barrier that
// precedes every send (a split one: arrive after the init, wait before
// the first send).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared::cluster address of this CTA's shared variable `p` in CTA
// `rank`'s window
__device__ __forceinline__ uint32_t dsmem_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// one arrival (this thread's, at init) and `bytes` of messages to come
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(smem_addr(bar)) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// the inits visible to the cluster's st.async before its barrier
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// phase 0 of `bar` complete: every byte it expects has landed (a count
// of bytes that never completes traps instead of hanging the card)
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  uint32_t done;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// Hopper's bulk asynchronous copy (the TMA's 1-D form) into a CTA's own
// shared memory, counted on an mbarrier of that CTA: an mbarrier of
// `count` arrivals a phase (mbar_init; its init visible to the copies
// through fence_proxy_async), one arrival that also expects `bytes` of
// copies (mbar_arrive_expect), plain arrivals (mbar_arrive), the copy of
// `bytes` (a multiple of 16) from `gmem` to `smem`, both 16-byte aligned
// (bulk_copy_g2s), and the wait for a phase of a given parity
// (mbar_wait_parity).  A slot that the CTA's threads read is copied into
// again only after a barrier that follows those reads and a
// fence_proxy_async by the thread that issues the copy.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* smem, const void* gmem,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the phase of `bar` of this parity complete (traps rather than hang)
__device__ __forceinline__ void mbar_wait_parity(uint64_t* bar,
                                                 uint32_t parity) {
  uint32_t done;
  for (int spins = 0;; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// x, or the pair (x, y), at `dst` (dsmem_addr) of the peer whose mbarrier
// is at `bar` (dsmem_addr)
__device__ __forceinline__ void st_async(uint32_t dst, float x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst), "r"(__float_as_uint(x)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float x, float y,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst), "r"(__float_as_uint(x)),
      "r"(__float_as_uint(y)), "r"(bar) : "memory");
}

// the full rows [0, rows) x [0, k) of the cluster's slices into dst (rows
// of ldd; bf16, or float32 for the serving decoder's float32 prenet): CTA
// j's slice `own` (the same shared variable in every CTA; rows of ldo)
// holds the columns [j * np, j * np + np), np a multiple of 8; columns
// past cl * np are zero.  16-byte reads of distributed shared memory, four
// in flight a thread, after a cluster barrier that follows the slices'
// writes
template <class T>
__device__ __forceinline__ void cluster_gather_rows(T* dst, int ldd,
                                                    const T* own, int ldo,
                                                    int np, int cl, int rows,
                                                    int k, int threads) {
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte chunk
  const int row_chunks = k / V, n_chunks = rows * row_chunks;
  for (int i0 = threadIdx.x; i0 < n_chunks; i0 += 4 * threads) {
    uint4 u[4];   // four loads in flight before their stores
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * threads;
      const int r = i / row_chunks, col = (i % row_chunks) * V;
      const int j = col / np;
      u[q] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n_chunks && j < cl)
        u[q] = *reinterpret_cast<const uint4*>(
            cluster_peer(own, j) + (size_t)r * ldo + col - j * np);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q * threads;
      if (i < n_chunks)
        *reinterpret_cast<uint4*>(dst + (size_t)(i / row_chunks) * ldd +
                                  (i % row_chunks) * V) = u[q];
    }
  }
}

// opts `kernel` in to all of a block's shared memory, and to clusters past
// the portable 8 CTAs, at its first launch; kernels of one signature (the
// instances of a template over the attention kind) share the table, keyed
// by the kernel's address
template <typename... KArgs>
cudaError_t opt_in_smem(void (*kernel)(KArgs...)) {
  static const void* done[8];
  static int n_done = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < n_done; ++i)
    if (done[i] == key) return cudaSuccess;
  cudaError_t err = allow_smem(kernel, 227 * 1024);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && n_done < 8) done[n_done++] = key;
  return err;
}

// a grid of CTAs in clusters of `cluster` CTAs consecutive in x; the
// first launch of each kernel opts it in to all of a block's shared memory
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads,
                           size_t smem, int cluster, cudaStream_t stream,
                           Args&&... args) {
  const cudaError_t opt_in = opt_in_smem(kernel);
  if (opt_in != cudaSuccess) return opt_in;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gate_tile_kernel: the fused-gate LSTM product of both decoders,
//   gates[row, q * H + unit] = sum_k a[row, k] * w[q * H + unit, k]
// for q = 0..3 (i, f, g, o).  a [M, K] and w [4H, K] (K contiguous; rows of
// lda and ldw bytes, 16-byte aligned; K of kbytes bytes, a multiple of 16)
// of element type E are the row.col operands of mma.sync as they lie: int8
// (m16n8k32, int32 sums), bf16 (m16n8k16, float32 sums) or float32 (both
// decoders' float32 instances: m16n8k8 TF32 in three passes, warp_tf32x3,
// float32 sums).
//
// Block: 32 * WM rows x 16 hidden units, whose i, f, g, o weight rows it
// gathers while copying (64 gate columns); WM x 2 warps of 32 rows x 32
// columns, and in float32 at up to 64 rows two such groups of warps that
// take each stage's K in halves (KW), so that two warps share each
// scheduler.  K walks in stages of BK bytes through a GT_STAGES-deep
// cp.async ring: 128, and in float32 256 (64 values) at up to 64 rows;
// rows are padded by 16 bytes so that ldmatrix's eight row addresses fall
// in distinct banks.
// The gate tile goes back through shared memory (the K groups' tiles
// summed in group order), and the epilogue epi(row, unit, g) sees the four
// gate sums g[q] of each (row, unit) inside [0, M) x [0, H).
//
// In float32 a thread-block cluster of GT_F32_CL CTAs splits K, so that a
// small batch still fills the card (B=50: 64 unit blocks, each two CTAs):
// CTA `rank` streams its share of the stages, and the cluster's first CTA
// sums the partial gate tiles in rank order through distributed shared
// memory before its epilogue.  No atomics: a run repeats bit for bit.
// Every instance launches through launch_cluster (bf16 and int8 in
// clusters of one).  Bound on the H100 (B=50, the flagship's two LSTMs):
// 64 MB of float32 weights, 0.019 ms at 3.35 TB/s, against 3 x 1.6 GFLOP
// of TF32 passes, 0.010 ms at 495 TFLOP/s; at B=240 the passes, 0.047 ms.
// At B=240 it runs its passes at about 130 TFLOP/s, a quarter of that peak
// (PERF.md); the ring is the fastest of those timed
// (tools/torch_kernel_variants.py time gate_f32_stage_128), the rows and
// the cluster likewise (gate_tile_launch).
// ---------------------------------------------------------------------------
constexpr int GT_BN = 64, GT_STAGES = 4;
constexpr int GT_F32_CL = 2;        // CTAs a float32 cluster
constexpr int GT_CLD = GT_BN + 4;   // words a row of the epilogue tile

template <int WM, class E>
struct GateTile {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int BK = F32 && WM <= 2 ? 256 : 128;
  static constexpr int KW = F32 && WM <= 2 ? 2 : 1;   // warp groups along K
  static constexpr int CL = F32 ? GT_F32_CL : 1;       // CTAs a cluster
  static constexpr int LD = BK + 16;   // bytes a staged row
  static constexpr int ROW_CHUNKS = BK / 16;
  static constexpr int BM = 32 * WM, THREADS = 64 * WM * KW;
  static constexpr int STAGE = (BM + GT_BN) * LD;      // bytes
  static constexpr int SMEM = GT_STAGES * STAGE;       // dynamic
  // float32: as many CTAs an SM as the ring lets in, which holds the
  // registers to that (two at 128 rows: 0.2481 ms at B=240 with the 156
  // registers nvcc takes unbounded, one CTA an SM; 0.2036 with 126)
  static constexpr int MIN_CTAS = F32 ? 227 * 1024 / SMEM : 1;
  static constexpr int CHUNKS = (BM + GT_BN) * ROW_CHUNKS / THREADS;
  static_assert(KW * BM * GT_CLD * 4 <= SMEM,
                "the epilogue tiles fit the ring");
  static_assert(CHUNKS * THREADS == (BM + GT_BN) * ROW_CHUNKS,
                "whole 16-byte chunks a thread");
  static_assert(SMEM <= 227 * 1024, "the ring fits a block");
};

template <class E, int WM, class Epi>
__global__ void __launch_bounds__(GateTile<WM, E>::THREADS,
                                  GateTile<WM, E>::MIN_CTAS)
gate_tile_kernel(const uint8_t* __restrict__ a, int lda,
                 const uint8_t* __restrict__ w, int ldw, int kbytes, int M,
                 int H, Epi epi) {
  typedef GateTile<WM, E> T;
  constexpr bool INT8 = std::is_same<E, int8_t>::value;
  constexpr bool F32 = std::is_same<E, float>::value;
  typedef typename std::conditional<INT8, int, float>::type Acc;
  extern __shared__ __align__(16) uint8_t ring[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a cluster's CTAs are consecutive in x (float32 only): its rank, and
  // its share of the K stages
  const int rank = blockIdx.x % T::CL;
  const int unit0 = blockIdx.x / T::CL * (GT_BN / 4);
  const int row0 = blockIdx.y * T::BM;
  // the warp's K group, and its 32 x 32 of the block tile
  const int wk = warp / (2 * WM), wq = warp % (2 * WM);
  const int wm = (wq % WM) * 32, wn = (wq / WM) * 32;
  const int nk_all = (kbytes + T::BK - 1) / T::BK;
  const int kt0 = nk_all * rank / T::CL;
  const int nk = nk_all * (rank + 1) / T::CL - kt0;

  // stage s, K tile kt: BM row slices then GT_BN weight-row slices,
  // ROW_CHUNKS 16-byte chunks each; rows outside [0, M), units outside
  // [0, H) and bytes past K are zero-filled
  auto load = [&](int s, int kt) {
    uint8_t* base = ring + s * T::STAGE;
    const int kb = kt * T::BK;
#pragma unroll
    for (int j = 0; j < T::CHUNKS; ++j) {
      const int i = tid + j * T::THREADS;
      const int r = i / T::ROW_CHUNKS, c = (i % T::ROW_CHUNKS) * 16;
      const bool in_k = kb + c < kbytes;
      if (r < T::BM) {
        const int row = row0 + r;
        const bool ok = in_k && row < M;
        cp_async16(base + r * T::LD + c,
                   ok ? a + (size_t)row * lda + kb + c : a, ok ? 16 : 0);
      } else {
        const int n = r - T::BM, unit = unit0 + (n & 15);
        const bool ok = in_k && unit < H;
        cp_async16(base + r * T::LD + c,
                   ok ? w + (size_t)((n >> 4) * H + unit) * ldw + kb + c : w,
                   ok ? 16 : 0);
      }
    }
  };

  // mma.sync's fragments acc[mt][nt][4]; in float32 a stage's passes go
  // to stage_acc first (tf32x3_promote)
  Acc acc[2][4][4];
  float stage_acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] = 0;
        stage_acc[i][j][q] = 0.0f;
      }

#pragma unroll
  for (int s = 0; s < GT_STAGES - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GT_STAGES - 2>();
    __syncthreads();
    // the slot refilled now was read in the previous iteration, which
    // every thread has finished (the barrier above)
    const int nxt = kt + GT_STAGES - 1;
    if (nxt < nk) load(nxt % GT_STAGES, kt0 + nxt);
    cp_async_commit();
    const uint8_t* as = ring + (kt % GT_STAGES) * T::STAGE;
    const uint8_t* bs = as + T::BM * T::LD;
#pragma unroll
    for (int k32 = 0; k32 < T::BK / T::KW; k32 += 32) {
      const int kk = wk * (T::BK / T::KW) + k32;   // this group's slices
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], as + (wm + mt * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * T::LD +
                            kk + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, bs + (wn + np * 16 + (lane & 7) + (lane >> 4) * 8) * T::LD +
                       kk + ((lane >> 3) & 1) * 16);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
      if constexpr (F32) {
        warp_tf32x3(stage_acc, af, bf);
      } else {
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
    if constexpr (F32) tf32x3_promote(acc, stage_acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the gate tile through shared memory, so that one thread sees the four
  // gates of a (row, unit); each K group writes a tile of its own, and
  // the second's is added to the first's
  Acc* cs = reinterpret_cast<Acc*>(ring);
  Acc* cw = cs + wk * T::BM * GT_CLD;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wm + mt * 16 + (lane >> 2);
      const int c = wn + nt * 8 + 2 * (lane & 3);
      cw[r * GT_CLD + c] = acc[mt][nt][0];
      cw[r * GT_CLD + c + 1] = acc[mt][nt][1];
      cw[(r + 8) * GT_CLD + c] = acc[mt][nt][2];
      cw[(r + 8) * GT_CLD + c + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  if constexpr (T::KW > 1) {
    for (int i = tid; i < T::BM * GT_BN; i += T::THREADS) {
      const int at = (i >> 6) * GT_CLD + (i & 63);
      cs[at] += cs[T::BM * GT_CLD + at];
    }
    __syncthreads();
  }
  if constexpr (T::CL > 1) {
    // every CTA's partial tile is written: the first CTA adds its peers'
    // to its own, in rank order
    cluster_sync();
    if (rank == 0)
      for (int i = tid; i < T::BM * (GT_BN / 4); i += T::THREADS) {
        float4* p = reinterpret_cast<float4*>(cs + (i >> 4) * GT_CLD +
                                              (i & 15) * 4);
        float4 v = *p;
        for (int peer = 1; peer < T::CL; ++peer) {
          const float4 u = *cluster_peer(p, peer);
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        *p = v;
      }
    // the first CTA has read its peers' tiles: they may leave
    cluster_arrive();
    if (rank != 0) {
      cluster_wait();
      return;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < T::BM * (GT_BN / 4); idx += T::THREADS) {
    const int r = idx >> 4, uu = idx & 15;
    const int row = row0 + r, unit = unit0 + uu;
    if (row >= M || unit >= H) continue;
    Acc g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = cs[r * GT_CLD + q * 16 + uu];
    epi(row, unit, g);
  }
  if constexpr (T::CL > 1) cluster_wait();
}

template <class E, int WM, class Epi>
cudaError_t gate_tile_run(const void* a, int lda, const void* w, int ldw,
                          int kbytes, int M, int H, const Epi& epi,
                          cudaStream_t stream) {
  typedef GateTile<WM, E> T;
  const dim3 grid((H + GT_BN / 4 - 1) / (GT_BN / 4) * T::CL,
                  (M + T::BM - 1) / T::BM);
  return launch_cluster(gate_tile_kernel<E, WM, Epi>, grid, T::THREADS,
                        T::SMEM, T::CL, stream, (const uint8_t*)a, lda,
                        (const uint8_t*)w, ldw, kbytes, M, H, epi);
}

// Rows a block: 128 above 128 rows, 64 above 32, else 32.  At the main
// paths' batches each weight tile is read by two row blocks (B=240: 128
// blocks, about a wave of the H100's 132 SMs) or one (B=50: 64 blocks,
// faster on the H100 than 128 blocks that read it twice; in float32 two
// CTAs each, 128 CTAs).  The rows and the float32 cluster are the fastest
// of those timed (tools/torch_kernel_variants.py time gate_f32_cluster_1
// gate_f32_cluster_4 gate_rows_halved, PERF.md).
template <class E, class Epi>
cudaError_t gate_tile_launch(const void* a, int lda, const void* w, int ldw,
                             int kbytes, int M, int H, const Epi& epi,
                             cudaStream_t stream) {
  if (M <= 0 || H <= 0 || kbytes <= 0 || kbytes % 16 != 0 ||
      lda % 16 != 0 || ldw % 16 != 0 || (uintptr_t)a % 16 != 0 ||
      (uintptr_t)w % 16 != 0)
    return cudaErrorInvalidValue;
  if (M > 128)
    return gate_tile_run<E, 4>(a, lda, w, ldw, kbytes, M, H, epi, stream);
  if (M > 32)
    return gate_tile_run<E, 2>(a, lda, w, ldw, kbytes, M, H, epi, stream);
  return gate_tile_run<E, 1>(a, lda, w, ldw, kbytes, M, H, epi, stream);
}

// ---------------------------------------------------------------------------
// splitk_kernel: C = A @ B with bf16 operands and float32 sums, then an
// epilogue epi.put(row, col, value) per element.  Every product of the two
// decoders other than the fused-gate LSTM runs in it: the frame and stop
// head of both (HeadOut, below), and in fused_train_decoder.cu the
// attention query (RoundOut) and the backward's dgates @ W, dq @ Wq^T and
// dWq (SegOut).
// A is "MK" ([M, K], k contiguous) or "KM" ([K, M], m contiguous: dWq); B
// is "KN" ([K, N], n contiguous: h @ Wq, dgates @ W with W [4H, K_in]) or
// "NK" ([N, K]: the heads, dq @ Wq^T).
//
// Tiles are copied into shared memory as they lie, 16 bytes a thread with
// cp.async through an SK_STAGES-deep ring, each tile row padded by 16 bytes
// so that the eight row addresses of an ldmatrix fall in distinct banks.
// The fragments of the transposed layouts ("KM" A, "KN" B) come from
// ldmatrix.trans: no thread stores a transposed element.  The grid's z
// dimension splits K into S slices of kslice (a multiple of SK_BK) so that
// a product with few M x N tiles (the heads: 8 at B=240, 2 at B=50; M=50:
// 37 tiles for the generator's dgates @ W) still fills the card.  With S >
// 1 each block writes its float32 partial tile into scratch [S, M, N], and
// splitk_reduce sums the S partials in slice order and applies the
// epilogue; with S = 1 the block applies it itself.  No atomics: a run
// repeats bit for bit.  The wrapper reads the tile through splitk_tile (at
// the end, exported by each library) to choose S.
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int SK_BM = 64, SK_BN = 64, SK_BK = 32, SK_THREADS = 128;
constexpr int SK_STAGES = 4;
constexpr int SK_LD_K = SK_BK + 8;    // [64][32] tiles (k contiguous): 80 B
constexpr int SK_LD_MN = SK_BN + 8;   // [32][64] tiles (m or n contiguous)
constexpr int SK_TILE = 64 * SK_LD_K > SK_BK * SK_LD_MN ? 64 * SK_LD_K
                                                         : SK_BK * SK_LD_MN;

// rows of `ld` elements of `es` bytes (2: bf16, 4: float32) from p start
// 16-byte aligned
__host__ inline bool vec_ok(const void* p, int ld, int es = 2) {
  return ((uintptr_t)p % 16 == 0) && ((long long)ld * es % 16 == 0);
}

// fv = row @ W_head^T + b over the head row [h_gen | ctx]: columns < N-1
// are the frame (into the frame carry and, when not null, the spec
// stream), column N-1 the stop logit
struct HeadOut {
  const float* bias;
  float* spec;
  float* frame;
  float* stop;
  int n;
  __device__ __forceinline__ void put(int row, int col, float v) const {
    const float fv = v + bias[col];
    if (col < n - 1) {
      if (spec != nullptr) spec[(size_t)row * (n - 1) + col] = fv;
      frame[(size_t)row * (n - 1) + col] = fv;
    } else {
      stop[row] = fv;
    }
  }
};

// eight consecutive bf16 at base[i * ld + j ..] into shared memory at dst,
// zero outside [0, I) x [0, J); `vec` (base and ld 16-byte aligned) copies
// with cp.async, otherwise with plain loads and one 16-byte store
__device__ __forceinline__ void load8(bf16* dst, const bf16* __restrict__ base,
                                      int ld, int i, int j, int I, int J,
                                      bool vec) {
  const bool in = i < I && j < J;
  if (vec) {
    const int n = in ? min(J - j, 8) : 0;
    cp_async16(dst, in ? base + (size_t)i * ld + j : base, 2 * n);
    return;
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (in) {
    bf16* e = reinterpret_cast<bf16*>(&v);
    const bf16* p = base + (size_t)i * ld + j;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (j + q < J) e[q] = p[q];
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <bool A_KM, bool B_KN, class Epi>
__global__ void __launch_bounds__(SK_THREADS)
splitk_kernel(const bf16* __restrict__ A, int lda, int avec,
              const bf16* __restrict__ B, int ldb, int bvec, int M, int N,
              int K, int kslice, float* __restrict__ part, Epi epi) {
  __shared__ __align__(16) bf16 sm[SK_STAGES][2][SK_TILE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * SK_BM, col0 = blockIdx.x * SK_BN;
  const int k_lo = blockIdx.z * kslice;
  const int k_hi = min(K, k_lo + kslice);
  const int nk = (k_hi - k_lo + SK_BK - 1) / SK_BK;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // stage s <- K tile k0: 256 chunks of A and 256 of B, four per thread
  auto load = [&](int s, int k0) {
    bf16* as = sm[s][0];
    bf16* bs = sm[s][1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tid + h * SK_THREADS;
      if (A_KM)   // [32 k][64 m]
        load8(as + (p >> 3) * SK_LD_MN + (p & 7) * 8, A, lda, k0 + (p >> 3),
              row0 + (p & 7) * 8, k_hi, M, avec);
      else        // [64 m][32 k]
        load8(as + (p >> 2) * SK_LD_K + (p & 3) * 8, A, lda, row0 + (p >> 2),
              k0 + (p & 3) * 8, M, k_hi, avec);
      if (B_KN)   // [32 k][64 n]
        load8(bs + (p >> 3) * SK_LD_MN + (p & 7) * 8, B, ldb, k0 + (p >> 3),
              col0 + (p & 7) * 8, k_hi, N, bvec);
      else        // [64 n][32 k]
        load8(bs + (p >> 2) * SK_LD_K + (p & 3) * 8, B, ldb, col0 + (p >> 2),
              k0 + (p & 3) * 8, N, k_hi, bvec);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s, k_lo + s * SK_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    const int nxt = kt + SK_STAGES - 1;
    if (nxt < nk) load(nxt % SK_STAGES, k_lo + nxt * SK_BK);
    cp_async_commit();
    const bf16* as = sm[kt % SK_STAGES][0];
    const bf16* bs = sm[kt % SK_STAGES][1];
#pragma unroll
    for (int kk = 0; kk < SK_BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = wm + mt * 16;
        if (A_KM)
          ldsm_x4_trans(af[mt], as + (kk + (lane & 7) + (lane >> 4) * 8) *
                                         SK_LD_MN +
                                     m0 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[mt], as + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   SK_LD_K +
                               kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n0 = wn + np * 16;
        uint32_t r[4];
        if (B_KN)
          ldsm_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    SK_LD_MN +
                                n0 + (lane >> 4) * 8);
        else
          ldsm_x4(r, bs + (n0 + (lane & 7) + (lane >> 4) * 8) * SK_LD_K + kk +
                         ((lane >> 3) & 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();

  // the partials' stores and the epilogue in loops of their own: an
  // epilogue inlined between the stores (a cell backward is long) would
  // put its code between every two of them, to be fetched cold
  if (part != nullptr) {
    float* dst = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int col = col0 + wn + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (row < M && col < N) dst[(size_t)row * N + col] = acc[mt][nt][e];
        }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = col0 + wn + nt * 8 + 2 * (lane & 3) + (e & 1);
        if (row < M && col < N) epi.put(row, col, acc[mt][nt][e]);
      }
}

// an epilogue that reads operands of its own: `prefetch(row, col)` reads
// them and `put(row, col, v, ops)` takes them back (CellOut)
template <class E, class = void>
struct epi_prefetches : std::false_type {};
template <class E>
struct epi_prefetches<E, std::void_t<decltype(std::declval<const E&>()
                                                  .prefetch(0, 0))>>
    : std::true_type {};

// the S partials of each (row, col), summed in slice order; an epilogue's
// own operands are read before the partials, so that their latencies
// overlap
template <class Epi>
__global__ void splitk_reduce_kernel(const float* __restrict__ part, int S,
                                     int M, int N, Epi epi) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  const int row = (int)(idx / N), col = (int)(idx % N);
  if constexpr (epi_prefetches<Epi>::value) {
    const auto ops = epi.prefetch(row, col);
    float v = part[idx];
    for (int s = 1; s < S; ++s) v += part[(size_t)s * mn + idx];
    epi.put(row, col, v, ops);
  } else {
    float v = part[idx];
    for (int s = 1; s < S; ++s) v += part[(size_t)s * mn + idx];
    epi.put(row, col, v);
  }
}

// K is split into `slices` of `kslice`; with slices > 1, `scratch` holds
// slices * M * N floats and a second launch sums them
template <bool A_KM, bool B_KN, class Epi>
int splitk_launch(const void* A, int lda, const void* B, int ldb, int M,
                  int N, int K, int slices, int kslice, void* scratch,
                  const Epi& epi, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || slices < 1 || kslice % SK_BK != 0 ||
      (long long)kslice * slices < K ||
      (long long)kslice * (slices - 1) >= K ||
      (slices > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = slices > 1 ? (float*)scratch : nullptr;
  dim3 grid((N + SK_BN - 1) / SK_BN, (M + SK_BM - 1) / SK_BM, slices);
  splitk_kernel<A_KM, B_KN, Epi><<<grid, SK_THREADS, 0, st>>>(
      (const bf16*)A, lda, vec_ok(A, lda), (const bf16*)B, ldb,
      vec_ok(B, ldb), M, N, K, kslice, part, epi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<Epi><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      part, slices, M, N, epi);
  return (int)cudaGetLastError();
}

// splitk_f32_kernel: the float32 instance of splitk_kernel, for the
// float32 instances of both decoders (K1's head; K2's query and head, K3's
// backward products and dWq): the same 64 x 64 tiles, SK_BK-deep slices of
// K and grid, so the wrapper's split and splitk_reduce_kernel serve it
// unchanged.  A is "MK" or "KM", B "NK" or "KN", as splitk_kernel's (KM only
// with KN).  Each tile is staged as it lies, 16 bytes a thread through an
// SK_STAGES-deep cp.async ring, zero past M, N and the slice's end: a
// k-contiguous tile as [64][SKF_LD], an m- or n-contiguous one as
// [SK_BK][SKF_LD_MN]; rows whose start or stride is not 16-byte aligned are
// copied with plain loads (vec 0).  Each warp's 32 x 32 runs on the tensor
// cores in three TF32 passes (warp_tf32x3).  The k-contiguous fragments
// come from ldmatrix as the gate routine's; there is no 32-bit
// ldmatrix.trans, so those of the transposed tiles ("KN" B, "KM" A) are
// read word by word (frag_kmn), lane (g, t) at row t and column g, which
// falls in distinct banks because a row is 8 words mod 32.
constexpr int SKF_LD = SK_BK + 4;      // floats a row of a [64][SK_BK] tile
constexpr int SKF_LD_MN = SK_BN + 8;   // floats a row of a [SK_BK][64] tile
constexpr int SKF_TILE = 64 * SKF_LD > SK_BK * SKF_LD_MN ? 64 * SKF_LD
                                                         : SK_BK * SKF_LD_MN;
constexpr int SKF_SMEM = SK_STAGES * 2 * SKF_TILE * 4;   // dynamic, bytes

// the fragment words (k0 + t, mn0 + g) and (k0 + t + 4, mn0 + g) of a
// float32 tile of rows of `ld` words, [SK_BK][SKF_LD_MN] by default (g =
// lane / 4, t = lane % 4): a "KN" B fragment, or half of a "KM" A
// fragment; with ld 8 words mod 32 the lanes read 32 distinct banks
__device__ __forceinline__ void frag_kmn(uint32_t* f, const float* tile,
                                         int k0, int mn0, int lane,
                                         int ld = SKF_LD_MN) {
  const float* p = tile + (k0 + (lane & 3)) * ld + mn0 + (lane >> 2);
  f[0] = __float_as_uint(p[0]);
  f[1] = __float_as_uint(p[4 * ld]);
}

// four floats of row i of a matrix at base[i * ld + j ..] into shared
// memory at dst, zero outside [0, I) x [0, J) (see load4f)
__device__ __forceinline__ void load4f_2d(float* dst,
                                          const float* __restrict__ base,
                                          int ld, int i, int j, int I, int J,
                                          bool vec);

template <bool A_KM, bool B_KN, class Epi>
__global__ void __launch_bounds__(SK_THREADS)
splitk_f32_kernel(const float* __restrict__ A, int lda, int avec,
                  const float* __restrict__ B, int ldb, int bvec, int M,
                  int N, int K, int kslice, float* __restrict__ part,
                  Epi epi) {
  extern __shared__ __align__(16) float skf_ring[];   // [stage][A, B]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * SK_BM, col0 = blockIdx.x * SK_BN;
  const int k_lo = blockIdx.z * kslice;
  const int k_hi = min(K, k_lo + kslice);
  const int nk = (k_hi - k_lo + SK_BK - 1) / SK_BK;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  // stage s <- K tile k0: 512 chunks of 4 floats of each operand
  auto load = [&](int s, int k0) {
    float* as = skf_ring + (2 * s) * SKF_TILE;
    float* bs = as + SKF_TILE;
    for (int p = tid; p < 64 * (SK_BK / 4); p += SK_THREADS) {
      // k-contiguous: [64 rows][SK_BK]; m- or n-contiguous: [SK_BK][64]
      const int r = p / (SK_BK / 4), c = (p % (SK_BK / 4)) * 4;
      const int kr = p / (SK_BN / 4), mc = (p % (SK_BN / 4)) * 4;
      if (A_KM)
        load4f_2d(as + kr * SKF_LD_MN + mc, A, lda, k0 + kr, row0 + mc, k_hi,
                  M, avec);
      else
        load4f_2d(as + r * SKF_LD + c, A, lda, row0 + r, k0 + c, M, k_hi,
                  avec);
      if (B_KN)
        load4f_2d(bs + kr * SKF_LD_MN + mc, B, ldb, k0 + kr, col0 + mc, k_hi,
                  N, bvec);
      else
        load4f_2d(bs + r * SKF_LD + c, B, ldb, col0 + r, k0 + c, N, k_hi,
                  bvec);
    }
  };

  // the sums, and a stage's passes (tf32x3_promote)
  float acc[2][4][4], stage_acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = stage_acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < nk) load(s, k_lo + s * SK_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    // the slot refilled now was read in the previous iteration
    const int nxt = kt + SK_STAGES - 1;
    if (nxt < nk) load(nxt % SK_STAGES, k_lo + nxt * SK_BK);
    cp_async_commit();
    const float* as = skf_ring + (2 * (kt % SK_STAGES)) * SKF_TILE;
    const float* bs = as + SKF_TILE;
#pragma unroll
    for (int kk = 0; kk < SK_BK; kk += 8) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = wm + mt * 16;
        if (A_KM) {
          uint32_t r0[2], r8[2];   // rows g and g + 8
          frag_kmn(r0, as, kk, m0, lane);
          frag_kmn(r8, as, kk, m0 + 8, lane);
          af[mt][0] = r0[0];
          af[mt][1] = r8[0];
          af[mt][2] = r0[1];
          af[mt][3] = r8[1];
        } else {
          ldsm_x4(af[mt], as + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   SKF_LD +
                               kk + (lane >> 4) * 4);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n0 = wn + np * 16;
        if (B_KN) {
          frag_kmn(bfr[2 * np], bs, kk, n0, lane);
          frag_kmn(bfr[2 * np + 1], bs, kk, n0 + 8, lane);
        } else {
          uint32_t r[4];
          ldsm_x4(r, bs + (n0 + (lane & 7) + (lane >> 4) * 8) * SKF_LD + kk +
                         ((lane >> 3) & 1) * 4);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
      }
      warp_tf32x3(stage_acc, af, bfr);
    }
    tf32x3_promote(acc, stage_acc);
  }
  cp_async_wait<0>();

  // the partials' stores and the epilogue in loops of their own, as
  // splitk_kernel's
  if (part != nullptr) {
    float* dst = part + (size_t)blockIdx.z * M * N;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int col = col0 + wn + nt * 8 + 2 * (lane & 3) + (e & 1);
          if (row < M && col < N) dst[(size_t)row * N + col] = acc[mt][nt][e];
        }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = col0 + wn + nt * 8 + 2 * (lane & 3) + (e & 1);
        if (row < M && col < N) epi.put(row, col, acc[mt][nt][e]);
      }
}

// splitk_launch's float32 instance
template <bool A_KM = false, bool B_KN = false, class Epi>
int splitk_f32_launch(const void* A, int lda, const void* B, int ldb, int M,
                      int N, int K, int slices, int kslice, void* scratch,
                      const Epi& epi, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || slices < 1 || kslice % SK_BK != 0 ||
      (long long)kslice * slices < K ||
      (long long)kslice * (slices - 1) >= K ||
      (slices > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // the ring passes the 48 KB default: opt in once
  static const cudaError_t opt_in =
      allow_smem(splitk_f32_kernel<A_KM, B_KN, Epi>, SKF_SMEM);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const cudaStream_t st = (cudaStream_t)stream;
  float* part = slices > 1 ? (float*)scratch : nullptr;
  dim3 grid((N + SK_BN - 1) / SK_BN, (M + SK_BM - 1) / SK_BM, slices);
  splitk_f32_kernel<A_KM, B_KN, Epi><<<grid, SK_THREADS, SKF_SMEM, st>>>(
      (const float*)A, lda, vec_ok(A, lda, 4), (const float*)B, ldb,
      vec_ok(B, ldb, 4), M, N, K, kslice, part, epi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<Epi><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      part, slices, M, N, epi);
  return (int)cudaGetLastError();
}

// n rounded up to a multiple of 16 (bytes of a shared-memory region)
__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// ---------------------------------------------------------------------------
// prenet_tile_kernel: the forward prenet of both decoders (K1's prenet,
// replacing ops/pallas_decoder.py:513-519; K2's train_prenet, replacing
// ops/pallas_train_decoder.py:409-425): n layers of
//   y = relu(bf16(x) @ W_l + b_l), then the hashed dropout:
//   keep = rand_bits(row, col, P, seed0, seed1, salt0 + l) < thresh,
//   y = keep ? y * scale : 0
// with W_l [in, out] bf16 as it lies, float32 sums, and the next layer's
// input bf16(y), as the TPU kernels and the plain versions round.  The
// epilogue epi sees the input (raw: row, k, bf16(x)) and every layer's
// output (put: layer, row, col, y, keep) inside [0, B) x [0, P).  The
// element type T is bf16, or float32 for both decoders' float32
// instances: float32 weights, x and every
// layer's input unrounded, the products on the tensor cores in three TF32
// passes (tf32x3_kslices), float32 rows exchanged.
//
// One launch: a thread-block cluster of `cl` CTAs (<= 8; <= 16, a
// non-portable cluster, for the float32 instances' launches of few rows,
// prenet_split's `wide`) for each PN_ROWS = 16 rows (one mma row tile).  CTA `rank` owns the columns [rank * np,
// rank * np + np) of P in every layer (np a multiple of 8: ops/
// fused_decoder.py::prenet_split, shared with bwd_prenet).  At the start
// it copies, with cp.async, the 16 input rows (float32, or bf16 with
// x_bf16), its bias slices and its column slice of every layer's weight
// (W_l[:, cols], K zero-padded to a multiple of 16), so that every read is
// in flight at once.  Each layer is a warp per 8-column mma tile of its
// columns on mma.sync m16n8k16 (B fragments from ldmatrix.trans of the
// [K][np] slice) with the bias, ReLU and dropout in the epilogue; the CTA
// writes its columns in bf16 into its own shared slice, and after one
// cluster barrier gathers the full bf16 rows from its peers (16-byte reads
// of distributed shared memory).  Two slices alternate, so a layer costs
// one barrier.  Each CTA sums its own columns over the whole K: nothing is
// summed across CTAs and no float atomics are used, so a run repeats bit
// for bit.  The bf16 exchange is exact: the next layer rounds its input to
// bf16 anyway.  In float32 a warp takes an (n8 tile, K slice) pair of the
// CTA's 16 x np outputs (4 tiles x 2 slices at np = 32), the "KN" weight
// slice read two words a k pair (rows of np + 4 words: 32 distinct banks),
// and the warps' partials are summed in K order before the epilogue.
//
// Bound on the H100: 2 * B * (in * P + (n - 1) * P * P) operations (41 M
// at B=240, two layers of 256) and the weights, biases, input and output
// once (0.35 to 0.5 MB in bf16, about twice in float32): 0.1 to 0.3 us.
// What costs is latency, so each CTA reads only its 21 KB (float32: 43 KB)
// of weight slices (flagship widths), all at once, and a layer is one
// product chain over K (float32: at most 8 dependent mma.sync a chain) and
// one barrier.  float32 holds up to six layers of 256 over M = 80 in a
// CTA's shared memory (tests/test_torch_tf32x3.py).
// ---------------------------------------------------------------------------
constexpr int PN_ROWS = 16, PN_THREADS = 256, PN_WARPS = PN_THREADS / 32;

// the scalars of one prenet launch
struct PrenetArgs {
  const void* w;      // the layers' [in, out] weights (T), concatenated
  const float* b;     // the layers' biases, concatenated
  int B, in_dim, P, n_layers;
  uint32_t seed0, seed1, salt0, thresh;
  float scale;
  int drop;           // apply the dropout
  int cl, np;         // CTAs a cluster, columns a CTA
};

// shared-memory layout of prenet_tile_kernel (byte offsets) for elements of
// `es` bytes (2: bf16, 4: float32); rows padded by 16 bytes.  float32: the
// A tile's rows of 8 words mod 32 and the weight slices' of np + 4
// (tf32x3_kslices' conflict-free "KN" reads), and the warps' K partials in
// the input rows' place (dead once layer 0's A tile is built)
struct PnLayout {
  int kp0, kpp, lda, ldw, ldo, ldx;
  size_t w, bias, x, part, a, own, total;
  __host__ __device__ PnLayout(int in_dim, int P, int np, int n_layers,
                               int es) {
    const int pad = 16 / es;
    kp0 = (in_dim + 15) / 16 * 16;   // K of layer 0, zero-padded
    kpp = (P + 15) / 16 * 16;        // K of the layers above
    const int kmax = kp0 > kpp ? kp0 : kpp;
    // elements a row of the A tile (float32: 8 words mod 32)
    lda = es == 4 ? (kmax + 31) / 32 * 32 + 8 : kmax + pad;
    ldw = np + pad;                  // elements a row of a weight slice
    ldo = np + pad;                  // elements a row of an own slice
    ldx = (int)align16((size_t)in_dim * 4);   // bytes an input row
    w = 0;
    bias = w + align16((size_t)(kp0 + (n_layers - 1) * kpp) * ldw * es);
    x = part = bias + align16((size_t)n_layers * np * 4);
    const size_t parts =
        es == 4 ? (size_t)tf32x3_splits(np, PN_WARPS) * PN_ROWS * np * 4 : 0;
    a = x + align16((size_t)PN_ROWS * ldx > parts ? (size_t)PN_ROWS * ldx
                                                    : parts);
    own = a + align16((size_t)PN_ROWS * lda * es);
    total = own + 2 * align16((size_t)PN_ROWS * ldo * es);
  }
};

// four floats base[j .. j + 4) into shared memory at dst, zero past J;
// `vec` (base 16-byte aligned, j a multiple of 4) copies with cp.async
__device__ __forceinline__ void load4f(float* dst,
                                       const float* __restrict__ base, int j,
                                       int J, bool vec) {
  if (vec) {
    const int n = j < J ? min(J - j, 4) : 0;
    cp_async16(dst, n > 0 ? base + j : base, 4 * n);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) dst[q] = j + q < J ? base[j + q] : 0.0f;
}

__device__ __forceinline__ void load4f_2d(float* dst,
                                          const float* __restrict__ base,
                                          int ld, int i, int j, int I, int J,
                                          bool vec) {
  const bool in = i < I;
  load4f(dst, in ? base + (size_t)i * ld : base, j, in ? J : 0, vec);
}

// the 16 bytes of elements of type CT (8 bf16 or 4 floats) at base[i * ld +
// j ..] into shared memory at dst, zero outside [0, I) x [0, J): load8 or
// load4f_2d
template <class CT>
__device__ __forceinline__ void load16(CT* dst, const CT* __restrict__ base,
                                       int ld, int i, int j, int I, int J,
                                       bool vec) {
  if constexpr (sizeof(CT) == 2)
    load8(dst, base, ld, i, j, I, J, vec);
  else
    load4f_2d(dst, base, ld, i, j, I, J, vec);
}

template <class Epi, class T = bf16>
__global__ void __launch_bounds__(PN_THREADS)
prenet_tile_kernel(const void* __restrict__ x_in, int x_bf16, int xvec,
                   int wvec, int bvec, PrenetArgs args, Epi epi) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t pn_smem[];
  const int B = args.B, in_dim = args.in_dim, P = args.P;
  const int n_layers = args.n_layers, np = args.np, cl = args.cl;
  const PnLayout L(in_dim, P, np, n_layers, sizeof(T));
  const int lda = L.lda, ldw = L.ldw, ldo = L.ldo;
  T* s_w = reinterpret_cast<T*>(pn_smem + L.w);           // layers' slices
  float* s_b = reinterpret_cast<float*>(pn_smem + L.bias);  // [n][np]
  uint8_t* s_x = pn_smem + L.x;                           // input rows
  // float32: the warps' K partials [slice][ROWS][np], in s_x's place
  float* s_part = reinterpret_cast<float*>(pn_smem + L.part);
  T* s_a = reinterpret_cast<T*>(pn_smem + L.a);           // [ROWS][lda]
  T* s_own = reinterpret_cast<T*>(pn_smem + L.own);       // 2 x [ROWS][ldo]
  const size_t own_slot = align16((size_t)PN_ROWS * ldo * sizeof(T)) /
                          sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int row0 = (blockIdx.x / cl) * PN_ROWS;
  const int c_lo = rank * np;   // this CTA's columns of P

  // group 0: the input rows, the bias slices, layer 0's weight slice;
  // group 1: the other layers' weight slices.  Zero outside the matrices.
  if (x_bf16) {
    const int chunks = L.ldx / 16;   // 8 bf16 a chunk
    for (int i = tid; i < PN_ROWS * chunks; i += PN_THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      load8(reinterpret_cast<bf16*>(s_x + (size_t)r * L.ldx) + c,
            (const bf16*)x_in, in_dim, row0 + r, c, B, in_dim, xvec);
    }
  } else {
    const int chunks = L.ldx / 16;   // 4 floats a chunk
    const float* xf = (const float*)x_in;
    for (int i = tid; i < PN_ROWS * chunks; i += PN_THREADS) {
      const int r = i / chunks, c = (i % chunks) * 4, row = row0 + r;
      float* dst = reinterpret_cast<float*>(s_x + (size_t)r * L.ldx) + c;
      if (row < B)
        load4f(dst, xf + (size_t)row * in_dim, c, in_dim, xvec);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int i = tid; i < n_layers * (np / 4); i += PN_THREADS) {
    const int l = i / (np / 4), c = (i % (np / 4)) * 4;
    load4f(s_b + l * np + c, args.b + (size_t)l * P, c_lo + c, P, bvec);
  }
  const int chunks_n = np / V;
  for (int l = 0, row_off = 0; l < n_layers; ++l) {
    const int k_l = l == 0 ? in_dim : P, kp = l == 0 ? L.kp0 : L.kpp;
    const T* w_l = reinterpret_cast<const T*>(args.w) +
                   (l == 0 ? 0
                           : (size_t)in_dim * P + (size_t)(l - 1) * P * P);
    for (int i = tid; i < kp * chunks_n; i += PN_THREADS) {
      const int k = i / chunks_n, c = (i % chunks_n) * V;
      T* dst = s_w + (size_t)(row_off + k) * ldw + c;
      if constexpr (F32)
        load4f(dst, w_l + (size_t)k * P, c_lo + c, k < k_l ? P : 0, wvec);
      else
        load8(dst, w_l, P, k, c_lo + c, k_l, P, wvec);
    }
    row_off += kp;
    if (l == 0) cp_async_commit();
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // layer 0's A tile: the input rows in T (bf16: rounded), zero past
  // in_dim; the cluster's first CTA hands the rows to the epilogue
  for (int i = tid; i < PN_ROWS * L.kp0; i += PN_THREADS) {
    const int r = i / L.kp0, k = i % L.kp0, row = row0 + r;
    const uint8_t* xr = s_x + (size_t)r * L.ldx;
    T v = from_float<T>(0.0f);
    if (k < in_dim) {
      if constexpr (F32)
        v = reinterpret_cast<const float*>(xr)[k];
      else
        v = x_bf16
                ? reinterpret_cast<const bf16*>(xr)[k]
                : __float2bfloat16_rn(reinterpret_cast<const float*>(xr)[k]);
    }
    s_a[(size_t)r * lda + k] = v;
    if (rank == 0 && row < B && k < in_dim) epi.raw(row, k, v);
  }
  __syncthreads();

  for (int l = 0, row_off = 0; l < n_layers; ++l) {
    const int kp = l == 0 ? L.kp0 : L.kpp;
    const bool last = l == n_layers - 1;
    const T* w_l = s_w + (size_t)row_off * ldw;
    T* own = s_own + (l & 1) * own_slot;
    const uint32_t salt = args.salt0 + (uint32_t)l;
    // the bias, ReLU and dropout of output (r, c) of this CTA's columns
    auto finish = [&](int r, int c, float acc) {
      const int row = row0 + r, col = c_lo + c;
      float y = fmaxf(acc + s_b[l * np + c], 0.0f);
      bool keep = true;
      if (args.drop) {
        keep = rand_bits((uint32_t)row, (uint32_t)col, (uint32_t)P,
                         args.seed0, args.seed1, salt) < args.thresh;
        y = keep ? y * args.scale : 0.0f;
      }
      const bool in = row < B && col < P;
      if (!last) own[(size_t)r * ldo + c] = from_float<T>(in ? y : 0.0f);
      if (in) epi.put(l, row, col, y, keep);
    };
    if constexpr (F32) {
      // this CTA's columns of y in three TF32 passes: a warp per (n8 tile,
      // K slice) of the "KN" weight slice, then the partials in K order
      tf32x3_kslices<true>(s_part, s_a, lda, w_l, ldw, np, kp, warp,
                           PN_WARPS, lane);
      __syncthreads();
      for (int o = tid; o < PN_ROWS * np; o += PN_THREADS)
        finish(o / np, o % np, tf32x3_kslice_sum(s_part, np, PN_WARPS, o));
    } else {
      // this CTA's columns of y: a warp per 8-column mma tile, K in steps
      // of 32 (16 in the last step when kp is an odd multiple of 16)
      for (int nt = warp; nt < np / 8; nt += PN_WARPS) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const bf16* ar = s_a + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) *
                                   lda + (lane >> 4) * 8;
        for (int kk = 0; kk < kp; kk += 32) {
          const bool two = kk + 16 < kp;   // the same in every lane
          uint32_t a0[4], a1[4], bw[4];
          ldsm_x4(a0, ar + kk);
          if (two) ldsm_x4(a1, ar + kk + 16);
          ldsm_x4_trans(bw, w_l + (size_t)(kk + (two ? lane : lane & 15)) *
                                      ldw + nt * 8);
          mma_bf16(acc, a0, bw);
          if (two) mma_bf16(acc, a1, bw + 2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          finish(g + 8 * (e >> 1), nt * 8 + 2 * qd + (e & 1), acc[e]);
      }
    }
    if (last) break;
    row_off += kp;

    // every slice of this layer is written: gather the full rows
    cluster_sync();
    cluster_gather_rows(s_a, lda, own, ldo, np, cl, PN_ROWS, L.kpp,
                        PN_THREADS);
    // after the last gather from the peers, this CTA's reads of their
    // shared memory are done: arrive now, wait before leaving
    if (l == n_layers - 2) cluster_arrive();
    if (l == 0) cp_async_wait<0>();   // the weights of the layers above
    __syncthreads();
  }
  // no CTA leaves while its peers may still read its shared memory
  if (n_layers > 1) cluster_wait();
}

// the forward prenet of a decoder over B rows: the input x (float32, or
// bf16 with x_bf16; rows of in_dim), the layers' weights (T) and biases in
// args, the columns of P in args.cl shares of args.np (prenet_split)
template <class Epi, class T = bf16>
cudaError_t prenet_tile_launch(const void* x, int x_bf16,
                               const PrenetArgs& args, const Epi& epi,
                               cudaStream_t stream) {
  const int B = args.B, in_dim = args.in_dim, P = args.P;
  if (B <= 0 || in_dim <= 0 || P <= 0 || args.n_layers < 1 || args.cl < 1 ||
      args.cl > 16 || args.np <= 0 || args.np % 8 != 0 ||
      (long long)args.cl * args.np < P ||
      (long long)(args.cl - 1) * args.np >= P ||
      (std::is_same<T, float>::value && x_bf16))
    return cudaErrorInvalidValue;
  const PnLayout L(in_dim, P, args.np, args.n_layers, sizeof(T));
  const int xvec = (uintptr_t)x % 16 == 0 &&
                   in_dim % (x_bf16 ? 8 : 4) == 0;
  const int wvec = (uintptr_t)args.w % 16 == 0 &&
                   P % (int)(16 / sizeof(T)) == 0;
  const int bvec = (uintptr_t)args.b % 16 == 0 && P % 4 == 0;
  return launch_cluster(prenet_tile_kernel<Epi, T>,
                        (B + PN_ROWS - 1) / PN_ROWS * args.cl, PN_THREADS,
                        L.total, args.cl, stream, x, x_bf16, xvec, wvec, bvec,
                        args, epi);
}

// ---------------------------------------------------------------------------
// The location-conv band routine of both attention kernels (K1's
// lsa_attention, K3's att_bwd; the JAX kernels' `loc = cum @ Band`,
// ops/pallas_decoder.py:572-575, ops/pallas_train_decoder.py:779-926).
// The conv of the bf16 cum row with the folded filter lc [K, A] (K <= 32
// taps, padded to BAND_K = 32 with zero taps) is a product with the band
// matrix of cum, band(cum)[t][k] = cum[t + k - half] (zero outside
// [0, T)):
//   loc      = band(cum) @ lc              [T, 32] x [32, A]
//   dlc      = band(cum)^T @ bf16(dz)      [32, T] x [T, A]
//   P        = bf16(dz) @ lc^T             [T, A] x [A, 32]
//   dcum[t'] = sum_k P[t' - k + half][k]   (15 rows of P on each side)
// all on mma.sync bf16 m16n8k16 with float32 sums.  A tile of positions
// from t0 keeps cum in shared memory as bf16 with its halo, s_cum[i] =
// cum[t0 + i - half] (band_stage_cum), so band(cum)[t0 + r][k] =
// s_cum[r + k]: a Hankel matrix, equal to its transpose, whose A fragments
// come straight from s_cum (band_frag) for band and band^T alike.  lc lies
// in shared memory as [BAND_K][ld] bf16 rows (band_stage_lc): its B
// fragments come from ldmatrix.trans for loc and from ldmatrix for P;
// those of bf16(dz) ([rows][ld] bf16) from ldmatrix.trans for dlc.  Every
// ld is a multiple of 8 elements, and A a multiple of 16 (8 for loc).
// ---------------------------------------------------------------------------
constexpr int BAND_K = 32;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the A fragment (16 x 16) of the Hankel matrix M[r][c] = p[r + c]; rows
// g + 8 and columns c + 8 meet on one anti-diagonal, so a[1] == a[2]
__device__ __forceinline__ void band_frag(uint32_t* a, const bf16* p,
                                          int lane) {
  const int i = (lane >> 2) + 2 * (lane & 3);
  a[0] = pack_bf16(p[i], p[i + 1]);
  a[1] = pack_bf16(p[i + 8], p[i + 9]);
  a[2] = pack_bf16(p[i + 8], p[i + 9]);
  a[3] = pack_bf16(p[i + 16], p[i + 17]);
}

// both k halves of band(cum)[r0 .. r0 + 16)[0 .. 32), p = s_cum + r0
__device__ __forceinline__ void band_frags(uint32_t (*a)[4], const bf16* p,
                                           int lane) {
  band_frag(a[0], p, lane);
  band_frag(a[1], p + 16, lane);
}

// lc [K, A] into s_lc [BAND_K][ld] (bf16, or float32 for the float32
// instances), taps K.. zero
template <class CT>
__device__ void band_stage_lc(CT* s_lc, int ld, const CT* lc, int K, int A) {
  for (int i = threadIdx.x; i < BAND_K * A; i += blockDim.x) {
    const int k = i / A, a = i - k * A;
    s_lc[k * ld + a] = k < K ? lc[(size_t)k * A + a] : from_float<CT>(0.0f);
  }
}

// the same with cp.async (the caller commits and waits); lc and its rows
// 16-byte aligned (A a multiple of 16 bytes' elements, ld of 16 bytes')
template <class CT>
__device__ void band_copy_lc(CT* s_lc, int ld, const CT* lc, int K, int A) {
  constexpr int V = 16 / sizeof(CT);
  const int chunks = A / V;
  for (int i = threadIdx.x; i < BAND_K * chunks; i += blockDim.x) {
    const int k = i / chunks, c = (i - k * chunks) * V;
    cp_async16(s_lc + k * ld + c, k < K ? lc + (size_t)k * A + c : lc,
               k < K ? 16 : 0);
  }
}

// s_cum[i] = cum[t0 + i - half] for i < n, zero outside [0, T), rounded to
// the element type of s_cum (bf16 for the band product; float32 unrounded)
template <class CT, class Src>
__device__ void band_stage_cum(CT* s_cum, int n, const Src* cum, int t0,
                               int half, int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = t0 + i - half;
    s_cum[i] = from_float<CT>(t >= 0 && t < T ? to_float(cum[t]) : 0.0f);
  }
}

// acc += band(cum)[r0 .. r0 + 16) @ lc[:, n0 .. n0 + 8) (a: band_frags)
__device__ __forceinline__ void band_loc(float* acc, const uint32_t (*a)[4],
                                         const bf16* s_lc, int ld, int n0,
                                         int lane) {
  uint32_t b[4];
  ldsm_x4_trans(b, s_lc + lane * ld + n0);
  mma_bf16(acc, a[0], b);
  mma_bf16(acc, a[1], b + 2);
}

// acc[j] += band(cum)^T[m0 .. m0 + 16) over 16 positions @ dz[those
// positions][n0 + 8j .. n0 + 8j + 8), j = 0, 1; p = s_cum + (the first
// position's offset) + m0, s_dz at the first position's row
__device__ __forceinline__ void band_dlc(float (*acc)[4], const bf16* p,
                                         const bf16* s_dz, int ld, int n0,
                                         int lane) {
  uint32_t a[4], b[4];
  band_frag(a, p, lane);
  ldsm_x4_trans(b, s_dz + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                       (lane >> 4) * 8);
  mma_bf16(acc[0], a, b);
  mma_bf16(acc[1], a, b + 2);
}

// acc[j] += dz[16 rows from s_dz][0 .. A) @ lc[n0 + 8j .. n0 + 8j + 8)^T
__device__ __forceinline__ void band_p(float (*acc)[4], const bf16* s_dz,
                                       const bf16* s_lc, int ld, int n0,
                                       int A, int lane) {
  for (int kk = 0; kk < A; kk += 16) {
    uint32_t a[4], b[4];
    ldsm_x4(a, s_dz + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk +
                   (lane >> 4) * 8);
    ldsm_x4(b, s_lc + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + kk +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(acc[0], a, b);
    mma_bf16(acc[1], a, b + 2);
  }
}

// the energy term of one (t, a) from its loc sum, as the TPU kernels round
// at their compute type CT: bf16(tanh(bf16(bf16(bf16(loc) + q) + mtb))),
// and in float32 tanh((loc + q) + mtb)
template <class CT = bf16>
__device__ __forceinline__ float band_energy_tanh(float loc, float q,
                                                  float mtb) {
  return round_to<CT>(tanhf(
      round_to<CT>(round_to<CT>(round_to<CT>(loc) + q) + mtb)));
}

// the attention kinds of the attention kernels' template parameter:
// location-sensitive, forward, forward with the transition agent
constexpr int ATT_LS = 0, ATT_FWD = 1, ATT_FWD_TRANS = 2;

// the forward family's energy term of one (t, a), which has no location
// conv: bf16(tanh(bf16(q + mtb))), in float32 tanh(q + mtb)
template <class CT = bf16>
__device__ __forceinline__ float fwd_energy_tanh(float q, float mtb) {
  return round_to<CT>(tanhf(round_to<CT>(q + mtb)));
}

// ---------------------------------------------------------------------------
// The band routine's float32 instance (K3's att_bwd_kernel<ATT_LS, float>;
// the TPU kernel's band products take full float32, precision None,
// ops/pallas_train_decoder.py:904-925; also loc in K2's and K1's float32
// location-sensitive attention): the same three products on the tensor
// cores in three TF32 passes (mma_tf32x3, m16n8k8).  cum and lc are split
// into their TF32 halves once, when staged; dz, which only the two
// products after it read, is split in registers where it is read.
//
// The float32 operand tiles (lc [BAND_K][A], dz [rows][A]) lie in shared
// memory as unpadded rows of ld words, swizzled: word (row, col) at
// band_swz(row, col, ld), which permutes the 16-byte chunks of each
// aligned 128-byte span by the row (a bijection on a region of whole spans
// when ld is a multiple of 16; chunks stay whole for cp.async and
// ldmatrix).  At ld = 128 (the flagship's A) a "KN" fragment's word reads
// (lane (g, t) at row k0 + t and k0 + t + 4, column n0 + g) and
// ldmatrix's 8 rows of one 16-byte chunk (the "MK" and "NK" fragments)
// each fall in 32 distinct banks, so one layout serves both reads of lc
// (KN for loc, NK for P) and of dz (KN for dlc, MK for P); a padded row of
// A + 8 or A + 4 words leaves a two-way conflict on one of them.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int band_swz(int row, int col, int ld) {
  return (row * ld + col) ^ (((row & 3) << 3) | (((row >> 2) & 1) << 2));
}

// the m16n8k8 TF32 A fragment (16 x 8) of the Hankel matrix M[r][c] =
// p[r + c] (a[0..3] = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)): the
// band's rows r0.. and taps c0.. for loc, or the transposed band's taps
// r0.. and positions c0.. for dlc, p = s_cum + r0 + c0 either way
__device__ __forceinline__ void band_frag_tf32(uint32_t* a, const float* p,
                                               int lane) {
  const int i = (lane >> 2) + (lane & 3);
  a[0] = __float_as_uint(p[i]);
  a[1] = __float_as_uint(p[i + 8]);
  a[2] = __float_as_uint(p[i + 4]);
  a[3] = __float_as_uint(p[i + 12]);
}

// a "KN" B fragment, (k0 + t, n0 + g) and (k0 + t + 4, n0 + g), of a
// swizzled float32 tile
__device__ __forceinline__ void band_frag_kn(uint32_t* b, const float* s,
                                             int ld, int k0, int n0,
                                             int lane) {
  const int k = k0 + (lane & 3), n = n0 + (lane >> 2);
  b[0] = __float_as_uint(s[band_swz(k, n, ld)]);
  b[1] = __float_as_uint(s[band_swz(k + 4, n, ld)]);
}

// x into its TF32 halves at hi and lo
__device__ __forceinline__ void tf32_split_store(float* hi, float* lo,
                                                 float x) {
  const float h = __uint_as_float(tf32_rna(x));
  *hi = h;
  *lo = __uint_as_float(tf32_rna(x - h));
}

// lc [K, A] float32 into s_lc [BAND_K][A] swizzled, taps K.. zero, with
// cp.async (the caller commits and waits); lc 16-byte aligned
__device__ void band_copy_lc_tf32(float* s_lc, const float* lc, int K,
                                  int A) {
  const int chunks = A / 4;
  for (int i = threadIdx.x; i < BAND_K * chunks; i += blockDim.x) {
    const int k = i / chunks, c = (i - k * chunks) * 4;
    cp_async16(s_lc + band_swz(k, c, A), k < K ? lc + (size_t)k * A + c : lc,
               k < K ? 16 : 0);
  }
}

// the n words at s split in place into their TF32 halves: s keeps hi, the
// n words after it get lo (a swizzled tile keeps its swizzle)
__device__ void tf32_split_words(float* s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    tf32_split_store(s + i, s + n + i, s[i]);
}

// band_stage_cum's float32 instance split once: hi[i] + lo[i] = cum[t0 + i
// - half] for i < n, zero outside [0, T)
__device__ void band_stage_cum_tf32(float* hi, float* lo, int n,
                                    const float* cum, int t0, int half,
                                    int T) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = t0 + i - half;
    tf32_split_store(hi + i, lo + i, t >= 0 && t < T ? cum[t] : 0.0f);
  }
}

// ---------------------------------------------------------------------------
// The context sum of both forward attention kernels over a block of `rows`
// consecutive memory rows of M elements of type ST (K1's lsa_attention: a
// batch row; K2's train_attention: a tile of one):
//   ctx[m] = sum_r round(mem[r, m] * w[r])      (w: compute-type values)
// with ST bf16 (round: to bf16), or, in the serving decoder's float32 and
// int8-stream instances, float32 or int8 (round: to the compute type,
// ROUND; float32 rounds nothing; int8 codes are exact in either type, and
// the caller multiplies the sum by the channel's scale).  A row of M
// elements is 16-byte aligned only every `period` rows (V = 16 / sizeof(ST)
// elements a 16-byte chunk, period = V / gcd(M, V): bf16 M = 292 is 584
// bytes, period 2; int8 M = 292 or 548, period 4), so the block is read as
// a flat array of 16-byte chunks, `chunks` of them a period: the thread of
// slot (group, chunk column c) walks the periods group, group + groups,
// ... with 16-byte loads (`vec`: the block starts 16-byte aligned), summing
// V float32 for its chunk column into the scratch [groups][period * M]
// (ctx_partials); the sum of column m over the groups and the period's
// rows is then taken in a fixed order (ctx_column).  The last period's
// chunks past rows * M elements read nothing.
// ---------------------------------------------------------------------------
struct CtxScheme {
  int period, chunks, groups;
  __host__ __device__ CtxScheme(int M, int threads, int V = 8) {
    int g = V;   // gcd(M, V), V a power of two
    while (M % g != 0) g >>= 1;
    period = V / g;
    chunks = period * M / V;
    groups = threads / chunks > 0 ? threads / chunks : 1;
  }
  __host__ __device__ size_t scratch_floats(int M) const {
    return (size_t)groups * period * M;
  }
};

// the V elements of a 16-byte chunk as float
__device__ __forceinline__ void chunk_floats(float* x, const uint4& u,
                                             const __nv_bfloat16*) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __low2float(h2[j]);
    x[2 * j + 1] = __high2float(h2[j]);
  }
}
__device__ __forceinline__ void chunk_floats(float* x, const uint4& u,
                                             const float*) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void chunk_floats(float* x, const uint4& u,
                                             const int8_t*) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j] = (float)c[j];
}

// ROUND: round each product to bf16 (ST bf16, and int8 streams of a bf16
// decoder); otherwise float32 products.  BATCH > 1: a slot reads that many
// of its periods' chunks at once before it adds any (the same sums in the
// same order), so that as many reads are in flight (the forward family's
// float32 instances)
template <bool ROUND = true, int BATCH = 1, class ST>
__device__ __forceinline__ void ctx_partials(
    const CtxScheme& S, float* __restrict__ scratch,
    const ST* __restrict__ mem, const float* __restrict__ w, int rows,
    int M, int vec, int threads) {
  constexpr int V = 16 / sizeof(ST);
  const int P = S.period, C = S.chunks, G = S.groups, PM = P * M;
  const int n_per = (rows + P - 1) / P;
  const long long n_el = (long long)rows * M;
  for (int slot = threadIdx.x; slot < G * C; slot += threads) {
    const int c = slot % C, grp = slot / C;
    int rr[V];
#pragma unroll
    for (int j = 0; j < V; ++j) rr[j] = (V * c + j) / M;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    // the chunk of period p as floats, zero past the rows
    auto chunk = [&](float* x, int p) {
      const long long base = (long long)p * PM + V * c;
      if (vec && base + V <= n_el) {
        chunk_floats(x, *reinterpret_cast<const uint4*>(mem + base), mem);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          x[j] = base + j < n_el ? to_float(mem[base + j]) : 0.0f;
      }
    };
    auto add = [&](const float* x, int p) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int r = p * P + rr[j];
        const float wt = r < rows ? w[r] : 0.0f;
        acc[j] += ROUND ? round_bf16(x[j] * wt) : x[j] * wt;
      }
    };
    if constexpr (BATCH == 1) {
#pragma unroll 2
      for (int p = grp; p < n_per; p += G) {
        float x[V];
        chunk(x, p);
        add(x, p);
      }
    } else {
      // the chunks held as they lie (16 bytes each) until they are added;
      // a chunk past the rows or not 16-byte aligned is read as elements
      // when it is added
      for (int p0 = grp; p0 < n_per; p0 += G * BATCH) {
        uint4 raw[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const long long base = (long long)(p0 + u * G) * PM + V * c;
          raw[u] = p0 + u * G < n_per && vec && base + V <= n_el
                       ? *reinterpret_cast<const uint4*>(mem + base)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int p = p0 + u * G;
          if (p >= n_per) continue;
          const long long base = (long long)p * PM + V * c;
          float x[V];
          if (vec && base + V <= n_el)
            chunk_floats(x, raw[u], mem);
          else
            chunk(x, p);
          add(x, p);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) scratch[grp * PM + V * c + j] = acc[j];
  }
}

// column m of the context from ctx_partials' scratch (after a barrier)
__device__ __forceinline__ float ctx_column(const CtxScheme& S,
                                            const float* scratch, int M,
                                            int m) {
  const int PM = S.period * M;
  float acc = 0.0f;
  for (int grp = 0; grp < S.groups; ++grp)
    for (int r = 0; r < S.period; ++r) acc += scratch[grp * PM + r * M + m];
  return acc;
}

}  // namespace

extern "C" {

// the splitk_kernel tile, {SK_BM, SK_BN, SK_BK}, from which the wrapper
// chooses the slices of K
void splitk_tile(int* out) {
  out[0] = SK_BM;
  out[1] = SK_BN;
  out[2] = SK_BK;
}

}  // extern "C"
