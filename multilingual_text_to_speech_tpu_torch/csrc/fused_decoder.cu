// Hopper kernels of one free-running Tacotron 2 decoder step.
//
// Replaces the JAX package's TPU kernel ops/pallas_decoder.py::_build_kernel
// (one pallas_call running a whole chunk of decoder steps).  The Python
// wrapper (ops/fused_decoder.py) launches the kernels of a step: prenet,
// gate_lstm (gate_rows and gate_mma, once per LSTM), lsa_attention and
// head (the split-K product and its ordered reduction).  The compute type
// is bfloat16 or float32, each kernel a template instance on it (the TPU
// kernel's `dtype`); carries and sums are float32.  In bfloat16, values are
// rounded at the points where the TPU kernel rounds them, so the plain
// PyTorch version in ops/fused_decoder.py can repeat the arithmetic; in
// float32 nothing is rounded and every product is float32-accurate (the
// prenet, the exact gates, the head and the attention's query and location
// conv on the tensor cores in three TF32 passes, csrc/tile.cuh mma_tf32x3;
// the rest in FFMA on the CUDA cores), but W8A8's int8 gate product, which
// float32 keeps.  The attention kernels
// also read the memory and the memory transform as int8 streams with
// per-channel scales (the TPU kernel's q_streams, pallas_decoder.py:
// 985-1003), dequantized where the TPU kernel dequantizes them.
//
// Bound on the H100: the two gate products dominate (2*B*(K_att+K_gen)*4H
// int8 operations a step, 7.7 G at B=240: 3.9 us at 1,979 TOP/s; their 16
// MB of int8 weights, 4.8 us at 3.35 TB/s).  The TPU kernel quantizes each
// row once into scratch and runs one int8 dot (pallas_decoder.py:495-511);
// so does gate_lstm here: a row pass per LSTM builds the int8 (or bf16) row
// once, and the product runs on the int8 (or bf16) tensor cores with
// mma.sync from a cp.async ring of shared-memory tiles fed to ldmatrix, 128
// rows by 64 gate columns a block (128 blocks at B=240, about one wave on
// 132 SMs, each weight tile read twice), with the LSTM step in its
// epilogue: csrc/tile.cuh's gate_tile_kernel, which the training decoder's
// gate product shares.  The frame and stop head (pallas_decoder.py:659-665,
// fv = [bf16(h_gen) | ctx] @ W_head + b: 2*B*(H+Mem)*(M+1) operations, 51 M
// at B=240, against 0.2 MB of weights) reads its bf16 row
// [bf16(h_gen) | bf16(ctx)] from a per-chunk buffer that the generator
// LSTM's epilogue and lsa_attention write as they finish, so the row costs
// no launch; the product is csrc/tile.cuh's splitk_kernel, which the
// training decoder's head shares: 8 output tiles at B=240 split K = 1344
// into 14 slices of 96 (112 blocks, one per SM; each weight tile read four
// times, once per row tile) and a second launch sums the partials in slice
// order.
// lsa_attention (2 * B * T * A * 32 operations of its location conv, the
// rest a few per element of the 32 KB of mtb and 73 KB of memory a row
// reads: bound by those bytes, 7.7 us at B=240, T=128) runs one CTA per
// row in clusters of 8 rows that share the query product, the location
// conv on the tensor cores as a band product (csrc/tile.cuh, shared with
// the training backward's att_bwd) and the context over 16-byte loads;
// on int8 streams, and in the forward family, with the row's streams
// copied into shared memory by bulk copies while the query runs.
// prenet (2*B*(M*P + (n-1)*P*P) operations, 41 M at B=240, against 0.5 MB
// of weights, input and output: a bound of 0.15 us, so its time is
// latency) is csrc/tile.cuh's prenet_tile_kernel, which the training
// decoder's train_prenet shares: a cluster of 8 CTAs for each 16 rows, each
// a column slice of every layer with all its weight reads issued at the
// start, the layers on mma.sync and the bf16 rows exchanged over
// distributed shared memory.
//
// Interface: plain extern "C" launchers taking device pointers and a
// cudaStream_t as void*, each returning cudaGetLastError().  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and never with --use_fast_math: the W8A8 row quantization relies on IEEE
// division and rintf to match the plain version bit for bit.

#include "common.cuh"
#include "tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// prenet: csrc/tile.cuh's prenet_tile_kernel (shared with the training
// decoder's train_prenet) with the serving epilogue: the last layer's
// float32 output and, when asked, every layer's uint8 keep mask.
// ---------------------------------------------------------------------------
struct PrenetOut {
  float* out;        // [B, P]
  uint8_t* keep;     // [n_layers, B, P], or null
  int B, P, n_layers;
  template <class T>
  __device__ __forceinline__ void raw(int, int, T) const {}
  __device__ __forceinline__ void put(int layer, int row, int col, float y,
                                      bool kept) const {
    if (keep != nullptr)
      keep[((size_t)layer * B + row) * P + col] = kept ? 1 : 0;
    if (layer == n_layers - 1) out[(size_t)row * P + col] = y;
  }
};

// ---------------------------------------------------------------------------
// gate_lstm, two launches per LSTM:
//   gate_rows: the concat row [s0 | s1 | s2] in the compute type CT, built
//     once per batch row.  W8A8: rs = max(amax, 1e-6) * (1/127), inv = 1/rs
//     (IEEE), q = clip(rint(x * inv)) -> the int8 row [B, Kp] and rs [B]
//     (in float32 from the unrounded row, as the TPU kernel quantizes its
//     float32 row, pallas_decoder.py:501-505); otherwise the CT row
//     [B, Kp].  Zero padded to Kp.
//   gate_mma: gates = row @ W^T (gate_tile_kernel of csrc/tile.cuh, which
//     the training decoder's gate product runs too: int8, bf16 or float32
//     (three TF32 passes, K split over a cluster of CTAs) on the tensor
//     cores), then the W8A8 dequant, the LSTM pointwise step and eval
//     zoneout in the epilogue, EvalLstm.
// W is [4H, Kp] (one row per gate column, K contiguous, Kp a multiple of
// 64), so the row and W are the row.col operands of mma.sync as they lie.
// ---------------------------------------------------------------------------
template <class CT>
struct Segments {
  const float* s0;
  const float* s1;
  const float* s2;
  int k0, k1, k2;
  __device__ __forceinline__ float at(int row, int k) const {
    float v;
    if (k < k0)
      v = s0[(size_t)row * k0 + k];
    else if (k < k0 + k1)
      v = s1[(size_t)row * k1 + (k - k0)];
    else if (k < k0 + k1 + k2)
      v = s2[(size_t)row * k2 + (k - k0 - k1)];
    else
      v = 0.0f;
    return round_to<CT>(v);
  }
};

constexpr int ROW_THREADS = 256;

// one block per batch row; dynamic shared memory holds the row (K floats)
template <bool INT8, class CT>
__global__ void __launch_bounds__(ROW_THREADS)
gate_rows_kernel(Segments<CT> seg, int kp, uint32_t* __restrict__ row_out,
                 float* __restrict__ rs_out, int8_t* __restrict__ q_out) {
  extern __shared__ float s_x[];
  __shared__ float s_red[32];
  const int row = blockIdx.x;
  const int K = seg.k0 + seg.k1 + seg.k2;
  float m = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = seg.at(row, k);
    s_x[k] = v;
    m = fmaxf(m, fabsf(v));
  }
  if (INT8) {
    // block_reduce synchronizes before it returns, so s_x is complete
    m = block_reduce<true>(m, s_red);
    const float rs = __fmul_rn(fmaxf(m, 1e-6f), (float)(1.0 / 127.0));
    const float inv = __fdiv_rn(1.0f, rs);
    if (threadIdx.x == 0) rs_out[row] = rs;
    uint32_t* dst = row_out + (size_t)row * (kp / 4);
    for (int wd = threadIdx.x; wd < kp / 4; wd += blockDim.x) {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * wd + j;
        int q = 0;
        if (k < K) {
          const float qf = rintf(__fmul_rn(s_x[k], inv));
          q = (int)fminf(fmaxf(qf, -127.0f), 127.0f);
          if (q_out != nullptr) q_out[(size_t)row * K + k] = (int8_t)q;
        }
        packed |= ((uint32_t)(uint8_t)(int8_t)q) << (8 * j);
      }
      dst[wd] = packed;
    }
  } else if constexpr (sizeof(CT) == 4) {
    __syncthreads();
    float* dst = reinterpret_cast<float*>(row_out) + (size_t)row * kp;
    for (int k = threadIdx.x; k < kp; k += blockDim.x)
      dst[k] = k < K ? s_x[k] : 0.0f;
  } else {
    __syncthreads();
    uint32_t* dst = row_out + (size_t)row * (kp / 2);
    for (int wd = threadIdx.x; wd < kp / 2; wd += blockDim.x) {
      const int k = 2 * wd;
      __nv_bfloat162 p = __floats2bfloat162_rn(k < K ? s_x[k] : 0.0f,
                                               k + 1 < K ? s_x[k + 1] : 0.0f);
      dst[wd] = *reinterpret_cast<uint32_t*>(&p);
    }
  }
}

// gate_mma's epilogue (gate_tile_kernel, csrc/tile.cuh): the W8A8 dequant
// in the TPU kernel's order, ((acc * rs) * ws) + b, or the bias of float32
// sums; the LSTM pointwise step and eval zoneout; with ROW (the generator
// LSTM in a chunk) also h in the compute type CT into the head row.  ROW is
// a template argument because the store alone changes the compiled gate
// kernel: at B=240 in W8A8 it drops from 121 to 97 registers and runs about
// 5 % slower on the H100, which the attention LSTM need not pay.
template <bool INT8, bool ROW, class CT>
struct EvalLstm {
  const float* rs;
  const float* ws;
  const float* bias;
  const float* h_old;
  const float* c_old;
  float* h_new;
  float* c_new;
  CT* h_row;              // CT(h_new) into the head row (ROW)
  int ld_row;
  int H;
  float zh, zc;
  template <class Acc>
  __device__ void operator()(int row, int unit, const Acc* g) const {
    float gt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * H + unit;
      if constexpr (INT8)
        gt[q] = __fadd_rn(__fmul_rn(__fmul_rn((float)g[q], rs[row]), ws[n]),
                          bias[n]);
      else
        gt[q] = g[q] + bias[n];
    }
    const size_t o = (size_t)row * H + unit;
    const float c_prev = c_old[o], h_prev = h_old[o];
    const float cn = sigmoid(gt[1]) * c_prev + sigmoid(gt[0]) * tanhf(gt[2]);
    const float hn = sigmoid(gt[3]) * tanhf(cn);
    const float ho = zh == 0.0f ? hn : zh * h_prev + (1.0f - zh) * hn;
    h_new[o] = ho;
    c_new[o] = zc == 0.0f ? cn : zc * c_prev + (1.0f - zc) * cn;
    if constexpr (ROW)
      h_row[(size_t)row * ld_row + unit] = from_float<CT>(ho);
  }
};

// ---------------------------------------------------------------------------
// lsa_attention: one CTA per batch row, in clusters of LSA_ROWS CTAs that
// share the query product.
//   q = bf16(h_att @ Wq); loc = bf16(band(bf16(cum)) @ lc)
//   z = bf16(bf16(loc + q) + mtb); e[t] = sum_a v[a] bf16(tanh(z)) + mask
//   w = softmax(e); cum' = cum + w; ctx[m] = sum_t bf16(mem[t,m] bf16(w[t]))
// and bf16(ctx) into the head row, when one is given.
// 1. Query: CTA `rank` of a cluster multiplies the cluster's LSA_ROWS rows
//    of bf16(h_att) by its slice of kq rows of Wq on the tensor cores (rows
//    8..15 of the m16 tile are zero); after a cluster barrier each CTA sums
//    its row's LSA_ROWS partials from its peers' shared memory in rank
//    order.  Wq is read once a cluster, not once a row.
// 2. Energy: the location conv is csrc/tile.cuh's band product, one warp
//    per 16 positions; the epilogue rounds, adds q and mtb (read as bf16
//    pairs in the accumulator layout), takes tanh and the v reduction.
// 3. Masked softmax and cum over the block.
// 4. Context: the row's memory [T, Mem] is read as 16-byte chunks of
//    `period` rows at a time (period * Mem a multiple of 8 elements, so
//    every chunk is aligned when T * Mem is), each thread one fixed chunk
//    column, `groups` threads down the periods; the groups' partial sums
//    are added in a fixed order.
//
// fwd_attention, the same kernel at KIND ATT_FWD or ATT_FWD_TRANS: the
// forward family's step (ops/pallas_decoder.py:573-643), which has no
// location conv:
//   e[t] = sum_a v[a] bf16(tanh(bf16(q + mtb)))       (no mask)
//   energy = softmax(e) over the row's T positions
//   comb = prev + bf16(prev[t-1])    or, with the transition agent,
//   comb = (1 - tp) prev + tp bf16(prev[t-1])     (prev[-1] = 0)
//   w = mask ? comb * energy : 0; w = max(w, 1e-6); w /= sum_t w
//   the state out is w (not cum + w); the context as above; and with the
//   agent tp' = sigmoid(sum bf16(ctx) wc + sum bf16(h_att) wq
//                       + sum bf16(x) wx + b)
// for x the prenet output of the same step.  The 1e-6 floor and the
// softmax run over the row's T positions only: the kernel's own padding
// (tpad) takes part in neither, as the TPU kernel leaves its padding past
// t_in out (pallas_decoder.py:602-604, :620-622).  Steps 1 and 4 are
// lsa_attention's; the shift reads prev[t-1] beside prev[t].  Bound on the
// H100: the bytes of memory and mtb a row reads, as lsa_attention's (8.3 us
// at B=240, T=128); without the band product it does strictly less work.
//
// The compute type CT and the stream type ST: every instance above is CT =
// ST = bf16.  CT = float32 (the TPU kernel at dtype float32) rounds none of
// the "bf16(...)" above.  Its query product runs on the tensor cores in
// three TF32 passes (mma.sync m16n8k8; csrc/tile.cuh warp_tf32x3_kslice
// with k taken in pairs on the float32 rows of h_att, rows 8..15 zero, and
// Wq's "KN" rows, a warp per n8 tile over the CTA's whole K slice, K in
// order).  The location-sensitive instances run the location conv as K2's
// float32 band routine (csrc/fused_train_decoder.cu train_attention; A a
// multiple of 16): lc copied into swizzled rows of A words (band_copy_lc_tf32, split in
// registers where read), cum's TF32 halves staged once
// (band_stage_cum_tf32), band(cum) @ lc on mma.sync m16n8k8 TF32 in three
// passes (mma_tf32x3), a warp per 16 channels down the row's 16-position
// mma tiles with its lc fragments held in registers, mtb read as float2
// pairs in the accumulator layout, each warp's partial energies summed in
// warp order (in chunks of LSA_EP_ROWS positions).  Before, both products
// ran on the CUDA cores (the band as 32 FFMA with two shared loads each a
// (t, a): about 18 us of the 72 a call at B=240, T=128, PERF.md).  The
// forward family's float32 instances run the family's energy loop
// (fam_energies, as its staged bf16 instances do) on the batch row in
// global memory: a lane four consecutive channels of a float32 mtb row
// (one 16-byte read) or eight int8 codes (one 8-byte read), their q, v
// and scales in registers, each lane reading FE32_UNROLL positions'
// groups before it computes any, the positions' lane partials then summed
// by shuffles; they copy
// prev beside Wq's slice, take the transition agent's h_att and x terms
// in the prologue, the softmax's max and sum in one reduction
// (block_softmax_stats), read the context's chunks 8 (float32) or 4
// (int8) periods at a time (ctx32_batch), and are declared two CTAs an
// SM.  ST = int8 (the TPU kernel's
// q_streams, pallas_decoder.py:571-572, :626-634): mtb is read as int8 and
// dequantized in the compute type, mtb = CT(q * mts[a]) with the scale row
// already in CT; the context sums CT(q * w[t]) in float32 and multiplies
// the channel's float32 scale after the sum.  An int8 memory row (292 or
// 548 bytes) is not a multiple of 16 bytes: the context's chunk scheme
// reads it as a flat array (period 4, csrc/tile.cuh CtxScheme).  Bound on
// the H100: the streams' bytes, 2x in float32 (51.6 MB a step at B=240,
// T=128: beyond the 50 MB L2), 1/2 in int8.
//
// The bf16 instances on int8 streams and the forward family's bf16
// instances are staged: their streams copied into shared memory while the
// query runs (lsa_staged_step below); the flagship's bf16
// location-sensitive instance and the float32 ones run as above.
// ---------------------------------------------------------------------------
constexpr int LSA_THREADS = 256, LSA_WARPS = LSA_THREADS / 32;
constexpr int LSA_ROWS = 8;   // CTAs (batch rows) a cluster
// positions a chunk of the float32 band's partial energies
constexpr int LSA_EP_ROWS = 256;

// the forward family's extra operands (all null for location-sensitive)
template <class CT>
struct FwdArgs {
  const float* tp_in;    // [B] the transition probability of the last step
  float* tp_out;         // [B]
  const float* x;        // [B, P] float32 prenet output of this step
  const CT* wc;          // [Mem] the agent's weights in the compute type
  const CT* wq;          // [H]
  const CT* wx;          // [P]
  const float* bias;     // [1]
  int P;
};

// the int8 streams' dequant rows (ST = int8; null otherwise)
template <class CT>
struct StreamScales {
  const float* mem;      // [Mem] float32, applied to the context
  const CT* mt;          // [A] in the compute type
};

// shared-memory layout of lsa_attention_kernel (byte offsets) for a
// compute type of `es` bytes, streams of `ss` and the location-sensitive
// kind (`ls`).  float32: h_att's rows 8..15 are zero rows of the query's
// m16 tile (rows of kq + 8 words: the k pairs of a half-warp in distinct
// banks), and the location-sensitive instances keep lc in swizzled rows of
// A words (band_swz), cum's TF32 lo halves beside its hi, and each warp's
// partial energies of a chunk of LSA_EP_ROWS positions
struct LsaLayout {
  int kq, ldh, ld, ldl, tpad, ep_rows;
  CtxScheme cs;   // the context's chunk scheme (csrc/tile.cuh)
  size_t wq, h, qp, q, v, mts, lc, cum, cum_lo, ep, e, red, cpart, total;
  __host__ __device__ LsaLayout(int T, int H, int A, int M, int es, int ss,
                                bool ls)
      : cs(M, LSA_THREADS, 16 / ss) {
    const int pad = 16 / es;
    const bool f32 = es == 4, tf32 = f32 && ls;
    kq = ((H + LSA_ROWS - 1) / LSA_ROWS + 31) / 32 * 32;
    ldh = kq + 8;
    ld = A + pad;           // rows of Wq
    ldl = tf32 ? A : ld;    // rows of lc
    tpad = (T + 15) / 16 * 16;
    ep_rows = tf32 ? min(tpad, LSA_EP_ROWS) : 0;
    wq = 0;
    h = wq + align16((size_t)kq * ld * es);
    qp = h + align16((size_t)(f32 ? 16 : LSA_ROWS) * ldh * es);
    q = qp + align16((size_t)LSA_ROWS * A * 4);
    v = q + align16((size_t)A * 4);
    mts = v + align16((size_t)A * 4);
    lc = mts + align16((size_t)A * 4);
    cum = lc + (ls ? align16((size_t)BAND_K * ldl * es) : 0);
    cum_lo = cum + align16((size_t)(tpad + BAND_K) * es);
    ep = cum_lo + (tf32 ? align16((size_t)(tpad + BAND_K) * 4) : 0);
    e = ep + align16((size_t)LSA_WARPS * ep_rows * 4);
    red = e + align16((size_t)tpad * 4);
    cpart = red + 32 * 4;
    total = cpart + align16(cs.scratch_floats(M) * 4);
  }
};

// the memory transform (plus bias) at i and i + 1, as the energy reads
// it: the compute type's value, or int8 * the channel's scale rounded to
// it (s_mts: the scale row, float of CT)
template <class CT>
__device__ __forceinline__ float2 mt_pair(const __nv_bfloat16* p, size_t i,
                                          const float*) {
  const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(p + i);
  return make_float2(__low2float(m), __high2float(m));
}
template <class CT>
__device__ __forceinline__ float2 mt_pair(const float* p, size_t i,
                                          const float*) {
  return *reinterpret_cast<const float2*>(p + i);
}
template <class CT>
__device__ __forceinline__ float2 mt_pair(const int8_t* p, size_t i,
                                          const float* s_mts) {
  const char2 c = *reinterpret_cast<const char2*>(p + i);
  return make_float2(round_to<CT>((float)c.x * s_mts[0]),
                     round_to<CT>((float)c.y * s_mts[1]));
}

// The float32 location-sensitive energies of one batch row: e[t] = sum_a
// v[a] tanh((loc[t][a] + q[a]) + mtb[t][a]) + mask[t] for t < T, loc =
// band(cum) @ lc in three TF32 passes (K2's float32 band routine): warp w
// takes the channels [16 w, 16 w + 16) (and every 128th group past them),
// holds their lc fragments in registers (split there), and walks the row's
// 16-position mma tiles in chunks of ep_rows positions; s_ep[w][row] takes
// the warp's partial, and the chunk's energies sum the partials in warp
// order.  s_cum / s_cum_lo: cum's TF32 halves (s_cum[i] = cum[i - half]),
// s_lc: lc [BAND_K][A] swizzled; mtb (float32 or int8 codes scaled by
// s_mts) is read as pairs in the accumulator layout, zero past T.
template <class CT, class ST>
__device__ __forceinline__ void lsa_band_energies_f32(
    float* s_e, float* s_ep, const float* s_cum, const float* s_cum_lo,
    const float* s_lc, const float* s_q, const float* s_v,
    const float* s_mts, const ST* mtb_b, const float* mask, int T, int A,
    int tpad, int ep_rows) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  for (int c0 = 0; c0 < tpad; c0 += ep_rows) {
    const int rows = min(ep_rows, tpad - c0);
    for (int n0 = warp * 16; n0 < A; n0 += LSA_WARPS * 16) {
      uint32_t bh[4][2][2], bl[4][2][2];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          band_frag_kn(bh[ks][h], s_lc, A, 8 * ks, n0 + 8 * h, lane);
          tf32_split<2>(bh[ks][h], bl[ks][h], bh[ks][h]);
        }
      // two mma tiles' mtb reads in flight
#pragma unroll 2
      for (int mt = 0; mt < rows / 16; ++mt) {
        const int r0 = c0 + mt * 16, ta = r0 + g, tb = ta + 8;
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ah[4], al[4];
          band_frag_tf32(ah, s_cum + r0 + 8 * ks, lane);
          band_frag_tf32(al, s_cum_lo + r0 + 8 * ks, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_tf32x3(acc[h], ah, al, bh[ks][h], bl[ks][h]);
        }
        float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = n0 + 8 * h + 2 * qd;
          const float2 zero2 = make_float2(0.0f, 0.0f);
          const float2 m0 =
              ta < T ? mt_pair<CT>(mtb_b, (size_t)ta * A + a, s_mts + a)
                     : zero2;
          const float2 m1 =
              tb < T ? mt_pair<CT>(mtb_b, (size_t)tb * A + a, s_mts + a)
                     : zero2;
          const float q0 = s_q[a], q1 = s_q[a + 1];
          const float v0 = s_v[a], v1 = s_v[a + 1];
          e0 = fmaf(v0, band_energy_tanh<float>(acc[h][0], q0, m0.x), e0);
          e0 = fmaf(v1, band_energy_tanh<float>(acc[h][1], q1, m0.y), e0);
          e1 = fmaf(v0, band_energy_tanh<float>(acc[h][2], q0, m1.x), e1);
          e1 = fmaf(v1, band_energy_tanh<float>(acc[h][3], q1, m1.y), e1);
        }
        e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
        e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
        if (qd == 0) {
          float* ep = s_ep + warp * ep_rows + mt * 16 + g;
          // a warp's later channel groups add to its own partial
          ep[0] = n0 == warp * 16 ? e0 : ep[0] + e0;
          ep[8] = n0 == warp * 16 ? e1 : ep[8] + e1;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < rows; i += LSA_THREADS) {
      const int t = c0 + i;
      if (t >= T) continue;
      float e = 0.0f;
      for (int w = 0; w < LSA_WARPS; ++w)
        e += w * 16 < A ? s_ep[w * ep_rows + i] : 0.0f;
      s_e[t] = e + mask[t];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The staged instances: bf16 compute on int8 streams (location-sensitive
// and the forward family) and the forward family on bf16 streams.  A row's
// streams do not depend on anything the step computes, so they are copied
// into shared memory while the query runs: once Wq's slice has landed
// warp 0 issues Hopper's bulk asynchronous copies (csrc/tile.cuh
// bulk_copy_g2s) of the memory transform's first tiles into a ring of
// slots (issued at the kernel's start, they delayed Wq's fetch, which the
// query waits on: PERF.md); once the query product has run, the memory's
// first tiles into a second ring over Wq's slice and h_att's rows, which
// are dead from then on, so that they land during the cluster exchange,
// the energies and the softmax.  Each ring
// takes the row's positions in tiles (StreamPlan, chosen on the host by
// ops/fused_decoder.py att_stream_tiles: any T runs), a slot refilled once
// the block has read it.  A tile's bytes are contiguous in device memory:
// its 16-byte-aligned span goes in one bulk copy, its ragged head and tail
// (an int8 row of 292 bytes at T = 1, say) by warp 0's lanes, and the slot
// keeps the tile's offset within 16 bytes, so the slot's chunks line up as
// the device memory's do.
//   Location-sensitive on int8 streams: the band product as the flagship's
// (a warp per 16 positions, band_loc), with lc's columns permuted within
// each group of 32 channels (band_stage_lc_grouped) so that a lane's
// channels over a group's four n8 tiles are 8 contiguous ones: one 8-byte
// read of staged codes a row and group, the scales, q and v read as float2
// pairs once a tile.  The forward family: a lane owns 8 contiguous
// channels (one 16-byte read of staged bf16 mtb, or 8 bytes of codes), their
// q, v and scales in registers; the shift reads a staged copy of prev; the
// transition agent's h_att and x terms run in the prologue, ctx . wc in the
// context's column loop.  Both: the softmax's max and sum in one block
// reduction of (max, sum) pairs (block_softmax_stats), and the context
// summed from the staged tiles in CtxScheme's chunks (its scratch over the
// memory transform's ring, which is dead by then).  Bound on the H100: the
// streams' bytes (4.4 us for int8 streams, 8.3 us for bf16 at B=240,
// T=128).
// ---------------------------------------------------------------------------
template <int KIND, class CT, class ST>
__host__ __device__ constexpr bool lsa_staged() {
  return std::is_same<CT, bf16>::value &&
         (std::is_same<ST, int8_t>::value || KIND != ATT_LS);
}

// the rings' mbarriers: LSA_RING slots at most in each ring
constexpr int LSA_RING = 4;

// the bf16 bit patterns of 2^-8 and 4, the bounds of the tanh table
// (tanh_table_fill), and its entries
constexpr uint32_t TANH_LO = 0x3B80u, TANH_HI = 0x4080u;
constexpr int TANH_N = (int)(TANH_HI - TANH_LO);

// positions a tile and slots, of the memory transform's ring and of the
// memory's
struct StreamPlan {
  int mt_tile, mt_stages, mem_tile, mem_stages;
};

// a ring of slots of tiles of a row's stream (T positions of `row` bytes):
// slot s at byte `off + s * slot` of the shared memory, a tile's bytes
// rounded up to 16 and 16 more for its offset within 16 bytes
struct StreamRing {
  size_t off;
  int slot, stages, tile, row;
  __host__ __device__ StreamRing() : off(0), slot(0), stages(0), tile(0),
                                     row(0) {}
  __host__ __device__ StreamRing(size_t o, int tile_, int stages_, int row_)
      : off(o), slot((int)align16((size_t)tile_ * row_) + 16),
        stages(stages_), tile(tile_), row(row_) {}
  __host__ __device__ size_t bytes() const { return (size_t)slot * stages; }
  __host__ __device__ int tiles(int T) const {
    return (T + tile - 1) / tile;
  }
};

// tile j of the stream `src` in its slot: the address of its first byte
__device__ __forceinline__ uint8_t* ring_tile(uint8_t* smem,
                                              const StreamRing& R,
                                              const uint8_t* src, int j) {
  const uint8_t* s = src + (size_t)j * R.tile * R.row;
  return smem + R.off + (size_t)(j % R.stages) * R.slot +
         ((uintptr_t)s & 15);
}

// warp 0: tile j of `src` into its slot, counted on the slot's mbarrier
// (32 arrivals a phase): the ragged head and tail by the lanes, then the
// aligned span in one bulk copy
__device__ void ring_issue(uint8_t* smem, uint64_t* bars,
                           const StreamRing& R, const uint8_t* src, int T,
                           int j, int lane) {
  const int t0 = j * R.tile, n = min(R.tile, T - t0) * R.row;
  const uint8_t* s = src + (size_t)t0 * R.row;
  uint8_t* d = ring_tile(smem, R, src, j);
  uint64_t* bar = bars + j % R.stages;
  const uintptr_t u = (uintptr_t)s, a = (u + 15) & ~(uintptr_t)15,
                  z = (u + n) & ~(uintptr_t)15;
  const int bulk = a < z ? (int)(z - a) : 0;
  const int head = bulk ? (int)(a - u) : n;
  const int tail = bulk ? (int)(u + n - z) : 0;
  for (int i = lane; i < head + tail; i += 32) {
    const int o = i < head ? i : (int)(z - u) + i - head;
    d[o] = s[o];
  }
  if (lane == 0 && bulk) {
    fence_proxy_async();
    mbar_arrive_expect(bar, bulk);
    bulk_copy_g2s(d + (a - u), reinterpret_cast<const void*>(a), bulk, bar);
  } else {
    mbar_arrive(bar);
  }
}

// tile j landed
__device__ __forceinline__ void ring_wait(uint64_t* bars,
                                          const StreamRing& R, int j) {
  mbar_wait_parity(bars + j % R.stages, (j / R.stages) & 1);
}

// shared-memory layout of the staged instances (byte offsets; bf16
// compute, streams of `ss` bytes): the mbarriers; Wq's slice and h_att's
// rows, then the memory's ring over them; the query's partials, q, v, the
// mt scales; lc (location-sensitive); cum with its halo (bf16,
// location-sensitive) or prev (float32, the family); the energies; the
// reductions' scratch; the memory transform's ring, then the context's
// scratch over it
struct LsaStagedLayout {
  int kq, ldh, ld, tpad;
  CtxScheme cs;
  StreamRing mt, mem;
  size_t bars, wq, h, qp, q, v, mts, lc, cum, e, red, tanh_tab, cpart,
      total;
  __host__ __device__ LsaStagedLayout(int T, int H, int A, int M, int ss,
                                      bool ls, const StreamPlan& p)
      : cs(M, LSA_THREADS, 16 / ss) {
    kq = ((H + LSA_ROWS - 1) / LSA_ROWS + 31) / 32 * 32;
    ldh = kq + 8;
    ld = A + 8;
    tpad = (T + 15) / 16 * 16;
    bars = 0;
    wq = align16(2 * LSA_RING * sizeof(uint64_t));
    h = wq + align16((size_t)kq * ld * 2);
    const size_t query = h + align16((size_t)LSA_ROWS * ldh * 2) - wq;
    mem = StreamRing(wq, p.mem_tile, p.mem_stages, M * ss);
    qp = wq + (query > mem.bytes() ? query : mem.bytes());
    q = qp + align16((size_t)LSA_ROWS * A * 4);
    v = q + align16((size_t)A * 4);
    mts = v + align16((size_t)A * 4);
    lc = mts + align16((size_t)A * 4);
    cum = lc + (ls ? align16((size_t)BAND_K * ld * 2) : 0);
    e = cum + align16(ls ? (size_t)(tpad + BAND_K) * 2 : (size_t)T * 4);
    red = e + align16((size_t)tpad * 4);
    tanh_tab = red + 64 * 4;
    mt = StreamRing(tanh_tab + (size_t)TANH_N * 4, p.mt_tile, p.mt_stages,
                    A * ss);
    cpart = mt.off;
    const size_t scratch = align16(cs.scratch_floats(M) * 4);
    total = cpart + (mt.bytes() > scratch ? mt.bytes() : scratch);
  }
  // the plan's tiles: the memory transform's whole 16-position mma tiles,
  // the memory's whole periods of the context's chunks, 1 to LSA_RING
  // slots each, all within a CTA's shared memory
  __host__ bool ok(const StreamPlan& p) const {
    return p.mt_tile > 0 && p.mt_tile % 16 == 0 && p.mt_stages >= 1 &&
           p.mt_stages <= LSA_RING && p.mem_tile > 0 &&
           p.mem_tile % cs.period == 0 && p.mem_stages >= 1 &&
           p.mem_stages <= LSA_RING && total <= 227 * 1024;
  }
};

// lc [K, A] into s_lc [BAND_K][ld] (bf16, taps K.. zero) with the columns
// of each whole group of 32 channels permuted: column 8 k + 2 qd + e of a
// group (its n8 tile k, the lane quad qd's pair e of the accumulator
// layout) holds channel 8 qd + 2 k + e, so that lane quad qd's channels
// over the group's four tiles are 8 contiguous ones; the channels past the
// last whole group as they are
__device__ void band_stage_lc_grouped(bf16* s_lc, int ld, const bf16* lc,
                                      int K, int A) {
  const int a32 = A / 32 * 32;
#pragma unroll 4
  for (int i = threadIdx.x; i < BAND_K * A; i += blockDim.x) {
    const int k = i / A, n = i - k * A, r = n & 31;
    const int a = n < a32 ? (n - r) + 8 * ((r & 7) >> 1) + 2 * (r >> 3) +
                                (r & 1)
                          : n;
    s_lc[k * ld + n] = k < K ? lc[(size_t)k * A + a] : __float2bfloat16(0.0f);
  }
}

// 8 consecutive stream elements at p as compute-type values: bf16 (one
// 16-byte read where p is aligned), or int8 codes (one 8-byte read where
// aligned) times their channels' scales s rounded to bf16
__device__ __forceinline__ void stream8(float* x, const bf16* p,
                                        const float*, bool aligned) {
  if (aligned) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    chunk_floats(x, u, p);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(p[i]);
  }
}
__device__ __forceinline__ void stream8(float* x, const int8_t* p,
                                        const float* s, bool aligned) {
  uint2 w = make_uint2(0u, 0u);
  if (aligned) {
    w = *reinterpret_cast<const uint2*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w.x |= (uint32_t)(uint8_t)p[i] << (8 * i);
      w.y |= (uint32_t)(uint8_t)p[4 + i] << (8 * i);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int8_t c = (int8_t)((i < 4 ? w.x : w.y) >> (8 * (i & 3)));
    x[i] = round_bf16((float)c * s[i]);
  }
}

// bf16(tanh(z)) for a bf16 z as a table in shared memory: the energy's
// tanh takes a bf16 value and is rounded to bf16, so its 1,280 values over
// [2^-8, 4) in magnitude are filled once a CTA (tanhf, as the unstaged
// instances compute each term) and read back; below 2^-8 tanh(z) rounds to
// z (z^3 / 3 is under a quarter of z's half ulp), from 4 on to 1 (tanh(4)
// is past 1 - 2^-9), and tanh is odd.  A term then costs a table read in
// place of tanhf's instructions, with the same bits

__device__ void tanh_table_fill(float* s_tanh) {
  for (int i = threadIdx.x; i < TANH_N; i += blockDim.x)
    s_tanh[i] = round_bf16(tanhf(
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(TANH_LO + i)))));
}

// bf16(tanh(bf16(x)))
__device__ __forceinline__ float tanh_bf16(float x, const float* s_tanh) {
  const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  const uint32_t t = bits & 0x7fffu;
  const float a = t >= TANH_HI  ? 1.0f
                  : t < TANH_LO ? __uint_as_float(t << 16)
                                : s_tanh[t - TANH_LO];
  return __uint_as_float(__float_as_uint(a) | ((bits & 0x8000u) << 16));
}

// band_energy_tanh's term through the table:
// bf16(tanh(bf16(bf16(bf16(loc) + q) + mtb)))
__device__ __forceinline__ float band_tanh(float loc, float q, float mtb,
                                           const float* s_tanh) {
  return tanh_bf16(round_bf16(round_bf16(loc) + q) + mtb, s_tanh);
}

// the staged location-sensitive energies of the tile [lo, lo + mt_tile)
// (its rows of A elements at `tile`, positions from lo): a warp per 16
// positions, lane quad qd's channels of a 32-channel group 8 contiguous
// ones (band_stage_lc_grouped), the scales, q and v as float2 pairs
template <class ST>
__device__ __forceinline__ void staged_band_energies(
    float* s_e, const ST* tile, int lo, int hi_pad, const bf16* s_cum,
    const bf16* s_lc, int ld, const float* s_q, const float* s_v,
    const float* s_mts, const float* s_tanh, const float* mask, int T,
    int A) {
  constexpr bool Q8 = std::is_same<ST, int8_t>::value;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3, a32 = A / 32 * 32;
  const bool aligned = ((uintptr_t)tile & (Q8 ? 7 : 15)) == 0;
  for (int t0 = lo + warp * 16; t0 < hi_pad; t0 += LSA_WARPS * 16) {
    uint32_t af[2][4];
    band_frags(af, s_cum + t0, lane);
    const int ta = t0 + g, tb = ta + 8;
    const ST* ra = tile + (size_t)(ta - lo) * A;
    const ST* rb = tile + (size_t)(tb - lo) * A;
    float e0 = 0.0f, e1 = 0.0f;
    for (int n0 = 0; n0 < a32; n0 += 32) {
      const int c0 = n0 + 8 * qd;
      float s8[8], m0[8], m1[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 s = Q8 ? *reinterpret_cast<const float2*>(s_mts + c0 +
                                                              2 * k)
                            : make_float2(1.0f, 1.0f);
        s8[2 * k] = s.x;
        s8[2 * k + 1] = s.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) m0[i] = m1[i] = 0.0f;
      if (ta < T) stream8(m0, ra + c0, s8, aligned);
      if (tb < T) stream8(m1, rb + c0, s8, aligned);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int a = c0 + 2 * k;
        const float2 q = *reinterpret_cast<const float2*>(s_q + a);
        const float2 v = *reinterpret_cast<const float2*>(s_v + a);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        band_loc(acc, af, s_lc, ld, n0 + 8 * k, lane);
        e0 = fmaf(v.x, band_tanh(acc[0], q.x, m0[2 * k], s_tanh), e0);
        e0 = fmaf(v.y, band_tanh(acc[1], q.y, m0[2 * k + 1], s_tanh), e0);
        e1 = fmaf(v.x, band_tanh(acc[2], q.x, m1[2 * k], s_tanh), e1);
        e1 = fmaf(v.y, band_tanh(acc[3], q.y, m1[2 * k + 1], s_tanh), e1);
      }
    }
    // the channels past the last whole group, a pair a lane and n8 tile
    for (int n0 = a32; n0 < A; n0 += 8) {
      const int a = n0 + 2 * qd;
      float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float s = Q8 ? s_mts[a + i] : 1.0f;
        if (ta < T) m[i] = round_bf16(to_float(ra[a + i]) * s);
        if (tb < T) m[2 + i] = round_bf16(to_float(rb[a + i]) * s);
      }
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      band_loc(acc, af, s_lc, ld, n0, lane);
      e0 = fmaf(s_v[a], band_tanh(acc[0], s_q[a], m[0], s_tanh), e0);
      e0 = fmaf(s_v[a + 1], band_tanh(acc[1], s_q[a + 1], m[1], s_tanh), e0);
      e1 = fmaf(s_v[a], band_tanh(acc[2], s_q[a], m[2], s_tanh), e1);
      e1 = fmaf(s_v[a + 1], band_tanh(acc[3], s_q[a + 1], m[3], s_tanh), e1);
    }
    e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
    e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
    e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
    if (qd == 0) {
      if (ta < T) s_e[ta] = e0 + mask[ta];
      if (tb < T) s_e[tb] = e1 + mask[tb];
    }
  }
}

// positions a lane of the forward family's energy loop takes at a time:
// the staged bf16 instances, whose rows lie in shared memory, and the
// float32 instances, which read theirs from global memory
constexpr int FE_UNROLL = 4;
constexpr int FE32_UNROLL = 8;

// a group of consecutive channels of a row of the memory transform at p
// as it lies: four float32 or eight bf16 in one 16-byte read, eight int8
// codes in one 8-byte read (`aligned`: p is aligned to the group's size),
// and its channel i as float: int8 codes times their channel's scale s,
// rounded to bf16 where ROUND (a bf16 decoder; float32 the plain
// version's mt = q * scale)
__device__ __forceinline__ float4 mt_group(const float* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ uint4 mt_group(const bf16* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(p[2 * i]) |
           (uint32_t)__bfloat16_as_ushort(p[2 * i + 1]) << 16;
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint2 mt_group(const int8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint2*>(p);
  uint2 w = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w.x |= (uint32_t)(uint8_t)p[i] << (8 * i);
    w.y |= (uint32_t)(uint8_t)p[4 + i] << (8 * i);
  }
  return w;
}
template <bool ROUND>
__device__ __forceinline__ float mt_channel(const float4& g, int i, float) {
  return i == 0 ? g.x : i == 1 ? g.y : i == 2 ? g.z : g.w;
}
template <bool ROUND>
__device__ __forceinline__ float mt_channel(const uint4& g, int i, float) {
  const uint32_t w = i < 2 ? g.x : i < 4 ? g.y : i < 6 ? g.z : g.w;
  return __uint_as_float(i & 1 ? w & 0xFFFF0000u : w << 16);
}
template <bool ROUND>
__device__ __forceinline__ float mt_channel(const uint2& g, int i, float s) {
  const float x = (float)(int8_t)((i < 4 ? g.x : g.y) >> (8 * (i & 3))) * s;
  return ROUND ? round_bf16(x) : x;
}

// the channels of a group (mt_group) of the stream type
template <class ST>
__host__ __device__ constexpr int fam_width() {
  return sizeof(ST) == 4 ? 4 : 8;
}
// the lanes that take a position of the family's energy loop: the least
// power of two at least its ng groups, at most 32
__device__ __forceinline__ int fam_lanes(int ng) {
  int lpr = 1;
  while (lpr < ng && lpr < 32) lpr <<= 1;
  return lpr;
}
// the q, v and scales of lane `sub`'s own group in registers (zero where
// the lane owns none)
template <int FW>
__device__ __forceinline__ void fam_lane_regs(float* qr, float* vr,
                                              float* sr, bool own, int sub,
                                              const float* s_q,
                                              const float* s_v,
                                              const float* s_mts, bool q8) {
#pragma unroll
  for (int i = 0; i < FW; ++i) {
    const int a = FW * sub + i;
    qr[i] = own ? s_q[a] : 0.0f;
    vr[i] = own ? s_v[a] : 0.0f;
    sr[i] = own && q8 ? s_mts[a] : 1.0f;
  }
}

// The forward family's energies e[t] = sum_a v[a] tanh(q[a] + mt[t][a])
// of the positions [lo, hi) (unmasked), position t's row of the memory
// transform at rows + (t - lo) A (a staged tile, or the batch row in
// global memory); A a multiple of 8 (att_dispatch).  `lpr` lanes take a
// position (fam_lanes), lane `sub` of them the FW consecutive channels
// [FW sub, FW sub + FW) with their q, v and scales in registers (qr, vr,
// sr: fam_lane_regs), and every lpr-th group past them from shared
// memory.  A lane reads U positions' own groups before it computes any,
// so that a warp has that many rows' reads in flight; each position's sum
// runs in channel order within a lane, then over the lanes by xor
// shuffles, the same order on every run.  The compute type CT rounds
// int8 streams' values to bf16 (bf16) or not (float); tanh_fn is the
// energy's tanh (the bf16 table, or tanhf)
template <int U, class CT, class ST, class Tanh>
__device__ __forceinline__ void fam_energies(
    float* s_e, const ST* __restrict__ rows, int lo, int hi, int A,
    int lpr, const float* qr, const float* vr, const float* sr,
    const float* s_q, const float* s_v, const float* s_mts,
    Tanh tanh_fn) {
  constexpr bool Q8 = std::is_same<ST, int8_t>::value;
  constexpr bool ROUND = std::is_same<CT, bf16>::value;
  constexpr int FW = fam_width<ST>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ng = A / FW;
  const int rpw = 32 / lpr, sub = lane & (lpr - 1), rr = lane / lpr;
  const bool own = sub < ng;
  const bool aligned = ((uintptr_t)rows & (FW * sizeof(ST) - 1)) == 0;
  using Group = decltype(mt_group(rows, true));
  for (int t0 = lo + warp * rpw * U; t0 < hi; t0 += LSA_WARPS * rpw * U) {
    Group m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * rpw + rr;
      m[u] = {};
      if (t < hi && own)
        m[u] = mt_group(rows + (size_t)(t - lo) * A + FW * sub, aligned);
    }
    float e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      e[u] = 0.0f;
#pragma unroll
      for (int i = 0; i < FW; ++i)
        e[u] = fmaf(vr[i],
                    tanh_fn(qr[i] + mt_channel<ROUND>(m[u], i, sr[i])), e[u]);
    }
    if (ng > lpr) {
      // the groups past the lanes' own
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * rpw + rr;
        if (t >= hi) continue;
        const ST* row = rows + (size_t)(t - lo) * A;
        for (int c = sub + lpr; c < ng; c += lpr) {
          const Group x = mt_group(row + FW * c, aligned);
#pragma unroll
          for (int i = 0; i < FW; ++i) {
            const int a = FW * c + i;
            e[u] = fmaf(s_v[a],
                        tanh_fn(s_q[a] + mt_channel<ROUND>(
                                             x, i, Q8 ? s_mts[a] : 1.0f)),
                        e[u]);
          }
        }
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
        e[u] += __shfl_xor_sync(0xffffffffu, e[u], off);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * rpw + rr;
      if (sub == 0 && t < hi) s_e[t] = e[u];
    }
  }
}

// the softmax's statistics over the block in one reduction of each
// thread's (max, sum of exp(e - max)) pair: the warp's maximum, each
// lane's sum rescaled to it by exp(m - M) and the warp's sum, by shuffles;
// then every thread takes the warps' pairs in warp order (the block's
// maximum, the warps' sums rescaled to it), so every thread returns the
// same (M, S).  A sum of nothing (maximum -inf) adds nothing
__device__ __forceinline__ void block_softmax_stats(float& m, float& s,
                                                    float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wm = m;
  for (int off = 16; off > 0; off >>= 1)
    wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
  float ws = m == -CUDART_INF_F ? 0.0f : s * expf(m - wm);
  for (int off = 16; off > 0; off >>= 1)
    ws += __shfl_xor_sync(0xffffffffu, ws, off);
  __syncthreads();
  if (lane == 0) {
    scratch[2 * warp] = wm;
    scratch[2 * warp + 1] = ws;
  }
  __syncthreads();
  m = -CUDART_INF_F;
  for (int w = 0; w < LSA_WARPS; ++w) m = fmaxf(m, scratch[2 * w]);
  s = 0.0f;
  for (int w = 0; w < LSA_WARPS; ++w) {
    const float mw = scratch[2 * w];
    s += mw == -CUDART_INF_F ? 0.0f : scratch[2 * w + 1] * expf(mw - m);
  }
}

// periods of the memory a slot of its context reads at once: 8 chunks of
// float32, 4 of int8 codes (PERF.md: 16 of either, and 4 of float32, read
// slower)
template <class ST>
__host__ __device__ constexpr int ctx32_batch() {
  return std::is_same<ST, int8_t>::value ? 4 : 8;
}

// a thread's slot of CtxScheme's chunks (group, chunk column c) over a
// period of P memory rows: with M >= V a chunk's V elements lie in at most
// two rows, its first `split` in row r0 and the rest in r0 + 1, so a
// period reads two weights; with M < V each element finds its own row
struct CtxSlot {
  int c, grp, r0, split;
  __device__ CtxSlot(int slot, int C, int M, int V)
      : c(slot % C), grp(slot / C), r0(V * c / M),
        split(M >= V ? (V * c / M + 1) * M - V * c : 0) {}
};

// the slot's chunks over one staged tile of `rows` memory rows (w: their
// weights), added to acc in period order: acc[i] += bf16(mem * w)
template <class ST>
__device__ __forceinline__ void staged_ctx_tile(float* acc, const ST* tile,
                                                const float* w, int rows,
                                                int M, int P, int G,
                                                const CtxSlot& s, bool vec) {
  constexpr int V = 16 / sizeof(ST);
  const int PM = P * M;
  const long long n_el = (long long)rows * M;
#pragma unroll 2
  for (int p = s.grp; p < (rows + P - 1) / P; p += G) {
    const long long base = (long long)p * PM + V * s.c;
    if (vec && s.split > 0 && base + V <= n_el) {
      // bf16(mem * w) as bf16x2 products (the exact product rounded once,
      // as round_bf16 of the float product): the weights are bf16 values,
      // and so are int8 codes
      const uint4 u = *reinterpret_cast<const uint4*>(tile + base);
      const int ra = p * P + s.r0;
      const __nv_bfloat16 wa = __float2bfloat16_rn(ra < rows ? w[ra] : 0.0f);
      const __nv_bfloat16 wb =
          __float2bfloat16_rn(ra + 1 < rows ? w[ra + 1] : 0.0f);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        __nv_bfloat162 xk;
        if constexpr (sizeof(ST) == 2) {
          xk = reinterpret_cast<const __nv_bfloat162*>(&u)[k];
        } else {
          const uint32_t word = reinterpret_cast<const uint32_t*>(&u)[k / 2];
          xk = __floats2bfloat162_rn(
              (float)(int8_t)(word >> (16 * (k & 1))),
              (float)(int8_t)(word >> (16 * (k & 1) + 8)));
        }
        const __nv_bfloat162 pr = __hmul2(
            xk, __halves2bfloat162(2 * k < s.split ? wa : wb,
                                   2 * k + 1 < s.split ? wa : wb));
        acc[2 * k] += __low2float(pr);
        acc[2 * k + 1] += __high2float(pr);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float x = base + i < n_el ? to_float(tile[base + i]) : 0.0f;
        const int r = p * P + (V * s.c + i) / M;
        acc[i] += round_bf16(x * (r < rows ? w[r] : 0.0f));
      }
    }
  }
}

template <int KIND, class ST>
__device__ __forceinline__ void lsa_staged_step(
    const float* __restrict__ h_att, const float* __restrict__ cum,
    const ST* __restrict__ memory, const ST* __restrict__ mtb,
    const float* __restrict__ mask_add, const bf16* __restrict__ wq,
    const bf16* __restrict__ lc, const float* __restrict__ v,
    float* __restrict__ ctx_out, float* __restrict__ cum_out,
    bf16* __restrict__ ctx_row, int ld_row, int B, int T, int H, int A,
    int M, int K, const FwdArgs<bf16>& fa, const StreamScales<bf16>& sc,
    const StreamPlan& plan) {
  constexpr bool Q8 = std::is_same<ST, int8_t>::value, LS = KIND == ATT_LS;
  extern __shared__ __align__(16) uint8_t lsa_smem[];
  const LsaStagedLayout L(T, H, A, M, sizeof(ST), LS, plan);
  uint64_t* mt_bars = reinterpret_cast<uint64_t*>(lsa_smem + L.bars);
  uint64_t* mem_bars = mt_bars + LSA_RING;
  bf16* s_wq = reinterpret_cast<bf16*>(lsa_smem + L.wq);      // [kq][ld]
  bf16* s_h = reinterpret_cast<bf16*>(lsa_smem + L.h);        // [ROWS][ldh]
  float* s_qp = reinterpret_cast<float*>(lsa_smem + L.qp);    // [ROWS][A]
  float* s_q = reinterpret_cast<float*>(lsa_smem + L.q);      // [A]
  float* s_v = reinterpret_cast<float*>(lsa_smem + L.v);      // [A]
  float* s_mts = reinterpret_cast<float*>(lsa_smem + L.mts);  // [A]
  bf16* s_lc = reinterpret_cast<bf16*>(lsa_smem + L.lc);      // [32][ld]
  bf16* s_cum = reinterpret_cast<bf16*>(lsa_smem + L.cum);    // [tpad + 32]
  float* s_prev = reinterpret_cast<float*>(lsa_smem + L.cum); // [T]
  float* s_e = reinterpret_cast<float*>(lsa_smem + L.e);      // [tpad]
  float* s_red = reinterpret_cast<float*>(lsa_smem + L.red);  // [64]
  float* s_tanh = reinterpret_cast<float*>(lsa_smem + L.tanh_tab);
  float* s_cpart = reinterpret_cast<float*>(lsa_smem + L.cpart);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x, row0 = b - rank;
  const bool live = b < B;
  const int half = (K - 1) / 2;
  const uint8_t* mem_b =
      reinterpret_cast<const uint8_t*>(memory + (size_t)b * T * M);
  const uint8_t* mtb_b =
      reinterpret_cast<const uint8_t*>(mtb + (size_t)b * T * A);
  const int n_mt = L.mt.tiles(T), n_mem = L.mem.tiles(T);

  // 0. the rings' mbarriers
  if (warp == 0 && live) {
    if (lane == 0) {
      for (int i = 0; i < 2 * LSA_RING; ++i) mbar_init(mt_bars + i, 32);
      mbar_init_fence();
      fence_proxy_async();
    }
    __syncwarp();
  }
  // this CTA's kq rows of Wq (zero past H) and the cluster's rows of
  // bf16(h_att) over them (zero past B); lc, cum or prev; v and the scales
  const int k_lo = rank * L.kq, a_chunks = A / 8;
  for (int i = tid; i < L.kq * a_chunks; i += LSA_THREADS) {
    const int r = i / a_chunks, c = (i - r * a_chunks) * 8, k = k_lo + r;
    cp_async16(s_wq + r * L.ld + c, k < H ? wq + (size_t)k * A + c : wq,
               k < H ? 16 : 0);
  }
  if (!LS && live)
    for (int t = tid; t < T; t += LSA_THREADS)
      cp_async4(s_prev + t, cum + (size_t)b * T + t);
  cp_async_commit();
#pragma unroll 4
  for (int i = tid; i < LSA_ROWS * L.kq; i += LSA_THREADS) {
    const int r = i / L.kq, k = i - r * L.kq;
    const int row = row0 + r, kk = k_lo + k;
    s_h[r * L.ldh + k] = __float2bfloat16(
        row < B && kk < H ? h_att[(size_t)row * H + kk] : 0.0f);
  }
  if (LS && live) {
    band_stage_lc_grouped(s_lc, L.ld, lc, K, A);
    band_stage_cum(s_cum, L.tpad + BAND_K, cum + (size_t)b * T, 0, half, T);
  }
  for (int a = tid; a < A; a += LSA_THREADS) {
    s_v[a] = v[a];
    if (Q8) s_mts[a] = to_float(sc.mt[a]);
  }
  if (live) tanh_table_fill(s_tanh);
  // the transition agent's h_att and x terms, which need nothing the step
  // computes (ctx . wc follows in the context's column loop)
  float lin = 0.0f;
  if (KIND == ATT_FWD_TRANS && live) {
#pragma unroll 4
    for (int k = tid; k < H; k += LSA_THREADS)
      lin = fmaf(round_bf16(h_att[(size_t)b * H + k]), to_float(fa.wq[k]),
                 lin);
    for (int p = tid; p < fa.P; p += LSA_THREADS)
      lin = fmaf(round_bf16(fa.x[(size_t)b * fa.P + p]), to_float(fa.wx[p]),
                 lin);
  }
  cp_async_wait<0>();
  __syncthreads();
  // the memory transform's first tiles on their way while the query and
  // the cluster exchange run; issued once Wq's slice has landed (issued
  // ahead of it, they delayed its fetch: PERF.md)
  if (warp == 0 && live)
    for (int j = 0; j < min(L.mt.stages, n_mt); ++j)
      ring_issue(lsa_smem, mt_bars, L.mt, mtb_b, T, j, lane);

  // 1. the query's partial over this CTA's slice of H, rows g < 8
  for (int n0 = warp * 8; n0 < A; n0 += LSA_WARPS * 8) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kk = 0; kk < L.kq; kk += 32) {
      uint32_t bq[4], a[4];
      ldsm_x4_trans(bq, s_wq + (kk + lane) * L.ld + n0);
      const bf16* hr = s_h + g * L.ldh + kk + 2 * qd;
      a[1] = a[3] = 0u;
      a[0] = *reinterpret_cast<const uint32_t*>(hr);
      a[2] = *reinterpret_cast<const uint32_t*>(hr + 8);
      mma_bf16(acc, a, bq);
      a[0] = *reinterpret_cast<const uint32_t*>(hr + 16);
      a[2] = *reinterpret_cast<const uint32_t*>(hr + 24);
      mma_bf16(acc, a, bq + 2);
    }
    s_qp[g * A + n0 + 2 * qd] = acc[0];
    s_qp[g * A + n0 + 2 * qd + 1] = acc[1];
  }
  // Wq's slice and h_att's rows are read: the memory's first tiles over them
  __syncthreads();
  if (warp == 0 && live)
    for (int j = 0; j < min(L.mem.stages, n_mem); ++j)
      ring_issue(lsa_smem, mem_bars, L.mem, mem_b, T, j, lane);
  cluster_sync();
  for (int a = tid; a < A; a += LSA_THREADS) {
    float sum = 0.0f;
    for (int j = 0; j < LSA_ROWS; ++j)
      sum += cluster_peer(s_qp, j)[rank * A + a];
    s_q[a] = round_bf16(sum);
  }
  // the peers' partials are read: they may exit once this CTA has too
  cluster_arrive();
  __syncthreads();

  if (live) {
    // 2. energies, a tile of the memory transform's ring at a time
    const int lpr = fam_lanes(A / 8), sub = lane & (lpr - 1);
    float qr[8], vr[8], sr[8];
    fam_lane_regs<8>(qr, vr, sr, !LS && sub < A / 8, sub, s_q, s_v, s_mts,
                     Q8);
    const float* mk = mask_add + (size_t)b * T;
    for (int j = 0; j < n_mt; ++j) {
      ring_wait(mt_bars, L.mt, j);
      const ST* tile =
          reinterpret_cast<const ST*>(ring_tile(lsa_smem, L.mt, mtb_b, j));
      const int lo = j * L.mt.tile;
      if constexpr (LS)
        staged_band_energies(s_e, tile, lo, min(L.tpad, lo + L.mt.tile),
                             s_cum, s_lc, L.ld, s_q, s_v, s_mts, s_tanh, mk,
                             T, A);
      else
        fam_energies<FE_UNROLL, bf16>(
            s_e, tile, lo, min(T, lo + L.mt.tile), A, lpr, qr, vr, sr, s_q,
            s_v, s_mts, [s_tanh](float z) { return tanh_bf16(z, s_tanh); });
      __syncthreads();
      if (warp == 0 && j + L.mt.stages < n_mt)
        ring_issue(lsa_smem, mt_bars, L.mt, mtb_b, T, j + L.mt.stages,
                   lane);
    }

    // 3. softmax, its max and sum in one block reduction; ls: cum' = cum
    // + w; the forward family: the recurrence, the mask, the floor and the
    // renorm, state w.  s_e <- bf16(w)
    float mx = -CUDART_INF_F, sum = 0.0f;
    for (int t = tid; t < T; t += LSA_THREADS) mx = fmaxf(mx, s_e[t]);
    if (mx != -CUDART_INF_F)
      for (int t = tid; t < T; t += LSA_THREADS) sum += expf(s_e[t] - mx);
    block_softmax_stats(mx, sum, s_red);
    const float* cum_b = cum + (size_t)b * T;
    if (LS) {
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float wt = expf(s_e[t] - mx) / sum;
        cum_out[(size_t)b * T + t] = cum_b[t] + wt;
        s_e[t] = round_bf16(wt);
      }
    } else {
      const float tp = KIND == ATT_FWD_TRANS ? fa.tp_in[b] : 0.0f;
      float wsum = 0.0f;
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float energy = expf(s_e[t] - mx) / sum;
        const float prev = s_prev[t];
        const float sh = t > 0 ? round_bf16(s_prev[t - 1]) : 0.0f;
        const float comb = KIND == ATT_FWD_TRANS
                               ? (1.0f - tp) * prev + tp * sh
                               : prev + sh;
        float wt = mk[t] > -0.5f ? comb * energy : 0.0f;
        wt = fmaxf(wt, 1e-6f);
        s_e[t] = wt;
        wsum += wt;
      }
      wsum = block_reduce<false>(wsum, s_red);
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float wt = s_e[t] / wsum;
        cum_out[(size_t)b * T + t] = wt;
        s_e[t] = round_bf16(wt);
      }
    }
    __syncthreads();

    // 4. context from the memory's ring: CtxScheme's slots (group, chunk
    // column) over the chunks of a tile (whole periods), each slot's sums
    // over the tiles in order, then the groups' and the period's rows in a
    // fixed order (ctx_column); int8 streams scaled after the sum.  A
    // thread holds its slot's sums in registers; past LSA_THREADS slots (a
    // memory row of more than LSA_THREADS chunks) a thread's further slots
    // keep theirs in the scratch between tiles
    constexpr int V = 16 / sizeof(ST);
    const int P = L.cs.period, C = L.cs.chunks, G = L.cs.groups, PM = P * M;
    const CtxSlot own(tid, C, M, V);
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int j = 0; j < n_mem; ++j) {
      ring_wait(mem_bars, L.mem, j);
      const ST* tile =
          reinterpret_cast<const ST*>(ring_tile(lsa_smem, L.mem, mem_b, j));
      const int lo = j * L.mem.tile, rows = min(L.mem.tile, T - lo);
      const bool vec = ((uintptr_t)tile & 15) == 0;
      if (tid < G * C)
        staged_ctx_tile<ST>(acc, tile, s_e + lo, rows, M, P, G, own, vec);
      for (int slot = tid + LSA_THREADS; slot < G * C;
           slot += LSA_THREADS) {
        float* part = s_cpart + (slot / C) * PM + V * (slot % C);
        float more[V];
#pragma unroll
        for (int i = 0; i < V; ++i) more[i] = j > 0 ? part[i] : 0.0f;
        staged_ctx_tile<ST>(more, tile, s_e + lo, rows, M, P, G,
                            CtxSlot(slot, C, M, V), vec);
#pragma unroll
        for (int i = 0; i < V; ++i) part[i] = more[i];
      }
      __syncthreads();
      if (warp == 0 && j + L.mem.stages < n_mem)
        ring_issue(lsa_smem, mem_bars, L.mem, mem_b, T, j + L.mem.stages,
                   lane);
    }
    if (tid < G * C) {
      float* part = s_cpart + (tid / C) * PM + V * (tid % C);
#pragma unroll
      for (int i = 0; i < V; ++i) part[i] = acc[i];
    }
    __syncthreads();
    for (int m = tid; m < M; m += LSA_THREADS) {
      float ctx = ctx_column(L.cs, s_cpart, M, m);
      if (Q8) ctx *= sc.mem[m];
      ctx_out[(size_t)b * M + m] = ctx;
      if (ctx_row != nullptr)
        ctx_row[(size_t)b * ld_row + m] = __float2bfloat16(ctx);
      if (KIND == ATT_FWD_TRANS)
        lin = fmaf(round_bf16(ctx), to_float(fa.wc[m]), lin);
    }
    if (KIND == ATT_FWD_TRANS) {
      // 5. the agent's one block sum over [bf16(ctx) | bf16(h_att) |
      // bf16(x)] . [wc | wq | wx]
      lin = block_reduce<false>(lin, s_red);
      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + fa.bias[0])));
    }
  }
  cluster_wait();
}

#define LSA_PARAMS(CT, ST)                                                  \
  const float* __restrict__ h_att, const float* __restrict__ cum,           \
      const ST* __restrict__ memory, const ST* __restrict__ mtb,            \
      const float* __restrict__ mask_add, const CT* __restrict__ wq,        \
      const CT* __restrict__ lc, const float* __restrict__ v,               \
      float* __restrict__ ctx_out, float* __restrict__ cum_out,             \
      CT* __restrict__ ctx_row, int ld_row, int B, int T, int H, int A,     \
      int M, int K, int vec, FwdArgs<CT> fa, StreamScales<CT> sc,           \
      StreamPlan plan
#define LSA_ARGS                                                            \
  h_att, cum, memory, mtb, mask_add, wq, lc, v, ctx_out, cum_out, ctx_row,  \
      ld_row, B, T, H, A, M, K, vec, fa, sc, plan
#define LSA_STAGED_ARGS                                                     \
  h_att, cum, memory, mtb, mask_add, wq, lc, v, ctx_out, cum_out, ctx_row,  \
      ld_row, B, T, H, A, M, K, fa, sc, plan

// the unstaged step: the flagship's bf16 location-sensitive instance and
// every float32 one (the forward family's bf16 instances are staged)
template <int KIND, class CT, class ST>
__device__ __forceinline__ void lsa_unstaged_step(LSA_PARAMS(CT, ST)) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  constexpr bool Q8 = std::is_same<ST, int8_t>::value;
  static_assert(F32 || KIND == ATT_LS, "the bf16 family runs staged");
  constexpr int VC = 16 / sizeof(CT);   // CT elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t lsa_smem[];
  const LsaLayout L(T, H, A, M, sizeof(CT), sizeof(ST), KIND == ATT_LS);
  CT* s_wq = reinterpret_cast<CT*>(lsa_smem + L.wq);         // [kq][ld]
  CT* s_h = reinterpret_cast<CT*>(lsa_smem + L.h);  // [ROWS or 16][ldh]
  float* s_qp = reinterpret_cast<float*>(lsa_smem + L.qp);   // [ROWS][A]
  float* s_q = reinterpret_cast<float*>(lsa_smem + L.q);     // [A]
  float* s_v = reinterpret_cast<float*>(lsa_smem + L.v);     // [A]
  float* s_mts = reinterpret_cast<float*>(lsa_smem + L.mts); // [A]
  CT* s_lc = reinterpret_cast<CT*>(lsa_smem + L.lc);         // [32][ldl]
  CT* s_cum = reinterpret_cast<CT*>(lsa_smem + L.cum);       // [tpad + 32]
  // float32 band: cum's TF32 lo halves, the warps' partial energies
  float* s_cum_lo = reinterpret_cast<float*>(lsa_smem + L.cum_lo);
  float* s_ep = reinterpret_cast<float*>(lsa_smem + L.ep);   // [WARPS][ep_rows]
  float* s_e = reinterpret_cast<float*>(lsa_smem + L.e);     // [tpad]
  float* s_red = reinterpret_cast<float*>(lsa_smem + L.red); // [32]
  float* s_cpart = reinterpret_cast<float*>(lsa_smem + L.cpart);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x, row0 = b - rank;
  const bool live = b < B;
  const int half = (K - 1) / 2;
  const ST* mem_b = memory + (size_t)b * T * M;
  const ST* mtb_b = mtb + (size_t)b * T * A;

  // this CTA's kq rows of Wq (zero past H) and the cluster's rows of
  // CT(h_att) over them (zero past B)
  const int k_lo = rank * L.kq, a_chunks = A / VC;
  for (int i = tid; i < L.kq * a_chunks; i += LSA_THREADS) {
    const int r = i / a_chunks, c = (i - r * a_chunks) * VC, k = k_lo + r;
    cp_async16(s_wq + r * L.ld + c, k < H ? wq + (size_t)k * A + c : wq,
               k < H ? 16 : 0);
  }
  if constexpr (F32)
    if (KIND == ATT_LS && live) band_copy_lc_tf32(s_lc, lc, K, A);
  // the forward family: prev (the state) copied beside Wq's slice
  float* s_prev = reinterpret_cast<float*>(s_cum);
  if (KIND != ATT_LS && live)
    for (int t = tid; t < T; t += LSA_THREADS)
      cp_async4(s_prev + t, cum + (size_t)b * T + t);
  cp_async_commit();
  // float32: rows 8..15 of the query's m16 tile are zero
  for (int i = tid; i < (F32 ? 16 : LSA_ROWS) * L.kq; i += LSA_THREADS) {
    const int r = i / L.kq, k = i - r * L.kq;
    const int row = row0 + r, kk = k_lo + k;
    s_h[r * L.ldh + k] = from_float<CT>(
        r < LSA_ROWS && row < B && kk < H ? h_att[(size_t)row * H + kk]
                                          : 0.0f);
  }
  if (KIND == ATT_LS && live) {
    if constexpr (F32) {
      band_stage_cum_tf32(s_cum, s_cum_lo, L.tpad + BAND_K,
                          cum + (size_t)b * T, 0, half, T);
    } else {
      band_stage_lc(s_lc, L.ld, lc, K, A);
      band_stage_cum(s_cum, L.tpad + BAND_K,
                     cum + (size_t)b * T, 0, half, T);
    }
  }
  if (Q8)
    for (int a = tid; a < A; a += LSA_THREADS) s_mts[a] = to_float(sc.mt[a]);
  // the transition agent's h_att and x terms, which need nothing the step
  // computes, while the copies land (ctx . wc follows in the context's
  // column loop)
  float lin = 0.0f;
  if (KIND == ATT_FWD_TRANS && live) {
#pragma unroll 4
    for (int k = tid; k < H; k += LSA_THREADS)
      lin = fmaf(h_att[(size_t)b * H + k], to_float(fa.wq[k]), lin);
    for (int p = tid; p < fa.P; p += LSA_THREADS)
      lin = fmaf(fa.x[(size_t)b * fa.P + p], to_float(fa.wx[p]), lin);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 1. the query's partial over this CTA's slice of H, rows g < 8
  if constexpr (F32) {
    // three TF32 passes, a warp per n8 tile over the slice's K in order
    for (int n0 = warp * 8; n0 < A; n0 += LSA_WARPS * 8) {
      float sum[4];
      warp_tf32x3_kslice<true>(sum, s_h, L.ldh, s_wq, L.ld, n0, 0, L.kq,
                               lane);
      *reinterpret_cast<float2*>(s_qp + g * A + n0 + 2 * qd) =
          make_float2(sum[0], sum[1]);
    }
  } else {
    for (int n0 = warp * 8; n0 < A; n0 += LSA_WARPS * 8) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kk = 0; kk < L.kq; kk += 32) {
        uint32_t bq[4], a[4];
        ldsm_x4_trans(bq, s_wq + (kk + lane) * L.ld + n0);
        const bf16* hr = s_h + g * L.ldh + kk + 2 * qd;
        a[1] = a[3] = 0u;
        a[0] = *reinterpret_cast<const uint32_t*>(hr);
        a[2] = *reinterpret_cast<const uint32_t*>(hr + 8);
        mma_bf16(acc, a, bq);
        a[0] = *reinterpret_cast<const uint32_t*>(hr + 16);
        a[2] = *reinterpret_cast<const uint32_t*>(hr + 24);
        mma_bf16(acc, a, bq + 2);
      }
      s_qp[g * A + n0 + 2 * qd] = acc[0];
      s_qp[g * A + n0 + 2 * qd + 1] = acc[1];
    }
  }
  cluster_sync();
  for (int a = tid; a < A; a += LSA_THREADS) {
    float sum = 0.0f;
    for (int j = 0; j < LSA_ROWS; ++j)
      sum += cluster_peer(s_qp, j)[rank * A + a];
    s_q[a] = round_to<CT>(sum);
    s_v[a] = v[a];
  }
  // the peers' partials are read: they may exit once this CTA has too
  cluster_arrive();
  __syncthreads();

  if (live) {
    // 2. energies
    if constexpr (F32 && KIND == ATT_LS) {
      lsa_band_energies_f32<CT>(s_e, s_ep, s_cum, s_cum_lo, s_lc, s_q, s_v,
                                s_mts, mtb_b, mask_add + (size_t)b * T, T,
                                A, L.tpad, L.ep_rows);
    } else if constexpr (F32) {
      constexpr int FW = fam_width<ST>();
      const int lpr = fam_lanes(A / FW), sub = lane & (lpr - 1);
      float qr[FW], vr[FW], sr[FW];
      fam_lane_regs<FW>(qr, vr, sr, sub < A / FW, sub, s_q, s_v, s_mts, Q8);
      fam_energies<FE32_UNROLL, float>(s_e, mtb_b, 0, T, A, lpr, qr, vr, sr,
                                       s_q, s_v, s_mts,
                                       [](float z) { return tanhf(z); });
    } else {
      // bf16 location-sensitive: one warp per 16 positions
      for (int t0 = warp * 16; t0 < L.tpad; t0 += LSA_WARPS * 16) {
        uint32_t af[2][4];
        band_frags(af, s_cum + t0, lane);
        const int ta = t0 + g, tb = ta + 8;
        float e0 = 0.0f, e1 = 0.0f;
#pragma unroll 4
        for (int n0 = 0; n0 < A; n0 += 8) {
          const int a = n0 + 2 * qd;
          const float2 zero2 = make_float2(0.0f, 0.0f);
          const float2 m0 =
              ta < T ? mt_pair<CT>(mtb_b, (size_t)ta * A + a, s_mts + a)
                     : zero2;
          const float2 m1 =
              tb < T ? mt_pair<CT>(mtb_b, (size_t)tb * A + a, s_mts + a)
                     : zero2;
          const float q0 = s_q[a], q1 = s_q[a + 1];
          const float v0 = s_v[a], v1 = s_v[a + 1];
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          band_loc(acc, af, s_lc, L.ld, n0, lane);
          e0 = fmaf(v0, band_energy_tanh(acc[0], q0, m0.x), e0);
          e0 = fmaf(v1, band_energy_tanh(acc[1], q1, m0.y), e0);
          e1 = fmaf(v0, band_energy_tanh(acc[2], q0, m1.x), e1);
          e1 = fmaf(v1, band_energy_tanh(acc[3], q1, m1.y), e1);
        }
        e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
        e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
        e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
        if (qd == 0) {
          const float* mk = mask_add + (size_t)b * T;
          if (ta < T) s_e[ta] = e0 + mk[ta];
          if (tb < T) s_e[tb] = e1 + mk[tb];
        }
      }
    }
    __syncthreads();

    // 3. softmax; ls: cum' = cum + w; the forward family: the recurrence,
    // the mask, the floor and the renorm, state w.  s_e <- CT(w).  The
    // forward family takes the softmax's max and sum in one block
    // reduction (block_softmax_stats) and leaves s_e = e
    float mx = -CUDART_INF_F, sum = 0.0f;
    for (int t = tid; t < T; t += LSA_THREADS) mx = fmaxf(mx, s_e[t]);
    if constexpr (KIND != ATT_LS) {
      if (mx != -CUDART_INF_F)
        for (int t = tid; t < T; t += LSA_THREADS) sum += expf(s_e[t] - mx);
      block_softmax_stats(mx, sum, s_red);
    } else {
      mx = block_reduce<true>(mx, s_red);
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float p = expf(s_e[t] - mx);
        s_e[t] = p;
        sum += p;
      }
      sum = block_reduce<false>(sum, s_red);
    }
    if (KIND == ATT_LS) {
      const float* cum_b = cum + (size_t)b * T;
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float wt = s_e[t] / sum;
        cum_out[(size_t)b * T + t] = cum_b[t] + wt;
        s_e[t] = round_to<CT>(wt);
      }
    } else {
      const float tp = KIND == ATT_FWD_TRANS ? fa.tp_in[b] : 0.0f;
      float wsum = 0.0f;
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float energy = expf(s_e[t] - mx) / sum;
        const float prev = s_prev[t];
        const float sh = t > 0 ? s_prev[t - 1] : 0.0f;
        const float comb = KIND == ATT_FWD_TRANS
                               ? (1.0f - tp) * prev + tp * sh
                               : prev + sh;
        float wt = mask_add[(size_t)b * T + t] > -0.5f ? comb * energy : 0.0f;
        wt = fmaxf(wt, 1e-6f);
        s_e[t] = wt;
        wsum += wt;
      }
      wsum = block_reduce<false>(wsum, s_red);
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float wt = s_e[t] / wsum;
        cum_out[(size_t)b * T + t] = wt;
        s_e[t] = round_to<CT>(wt);
      }
    }
    __syncthreads();

    // 4. context (csrc/tile.cuh: ctx_partials, ctx_column), int8 streams
    // scaled after the sum; the agent's context term on the way
    ctx_partials<!F32, KIND != ATT_LS ? ctx32_batch<ST>() : 1>(
        L.cs, s_cpart, mem_b, s_e, T, M, vec, LSA_THREADS);
    __syncthreads();
    for (int m = tid; m < M; m += LSA_THREADS) {
      float acc = ctx_column(L.cs, s_cpart, M, m);
      if (Q8) acc *= sc.mem[m];
      ctx_out[(size_t)b * M + m] = acc;
      if (ctx_row != nullptr)
        ctx_row[(size_t)b * ld_row + m] = from_float<CT>(acc);
      if (KIND == ATT_FWD_TRANS)
        lin = fmaf(round_to<CT>(acc), to_float(fa.wc[m]), lin);
    }
    if (KIND == ATT_FWD_TRANS) {
      // 5. the transition agent over [ctx | h_att | x] (the h_att and x
      // terms taken in the prologue)
      lin = block_reduce<false>(lin, s_red);
      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + fa.bias[0])));
    }
  }
  cluster_wait();
}

template <int KIND, class CT, class ST>
__global__ void __launch_bounds__(LSA_THREADS)
lsa_attention_kernel(LSA_PARAMS(CT, ST)) {
  if constexpr (lsa_staged<KIND, CT, ST>())
    lsa_staged_step<KIND, ST>(LSA_STAGED_ARGS);
  else
    lsa_unstaged_step<KIND, CT, ST>(LSA_ARGS);
}

// the forward family's staged instances on bf16 streams, and its float32
// instances, declared at two CTAs an SM (at most 128 registers a thread):
// under the template's bound alone ptxas held the staged ones to 64
// registers and spilled, and gave the float32 ones more than 128 (one CTA
// an SM: half of B=240's 30 clusters at once)
#define LSA_INSTANCE_2(KIND, CT, ST, STEP)                                   \
  template <>                                                               \
  __global__ void __launch_bounds__(LSA_THREADS, 2)                         \
      lsa_attention_kernel<KIND, CT, ST>(LSA_PARAMS(CT, ST)) {              \
    STEP;                                                                   \
  }
LSA_INSTANCE_2(ATT_FWD, bf16, bf16,
               (lsa_staged_step<ATT_FWD, bf16>(LSA_STAGED_ARGS)))
LSA_INSTANCE_2(ATT_FWD_TRANS, bf16, bf16,
               (lsa_staged_step<ATT_FWD_TRANS, bf16>(LSA_STAGED_ARGS)))
LSA_INSTANCE_2(ATT_FWD, float, float,
               (lsa_unstaged_step<ATT_FWD, float, float>(LSA_ARGS)))
LSA_INSTANCE_2(ATT_FWD_TRANS, float, float,
               (lsa_unstaged_step<ATT_FWD_TRANS, float, float>(LSA_ARGS)))
LSA_INSTANCE_2(ATT_FWD, float, int8_t,
               (lsa_unstaged_step<ATT_FWD, float, int8_t>(LSA_ARGS)))
LSA_INSTANCE_2(ATT_FWD_TRANS, float, int8_t,
               (lsa_unstaged_step<ATT_FWD_TRANS, float, int8_t>(LSA_ARGS)))

// the operands of one attention launch, untyped
struct AttCall {
  const void *h_att, *cum, *memory, *mtb, *mask_add, *wq, *lc, *v;
  void *ctx_out, *cum_out, *ctx_row;
  int ld_row, B, T, H, A, M, K;
  const void *tp_in;
  void* tp_out;
  const void *x, *wc, *wq_t, *wx, *bias;
  int P;
  const void *mem_scale, *mt_scale;
  StreamPlan plan;
  cudaStream_t stream;
};

// the dynamic shared memory of the instance's launch; 0 for a plan the
// staged instances do not take
template <int KIND, class CT, class ST>
size_t att_smem(const AttCall& c) {
  if constexpr (lsa_staged<KIND, CT, ST>()) {
    const LsaStagedLayout L(c.T, c.H, c.A, c.M, sizeof(ST), KIND == ATT_LS,
                            c.plan);
    return L.ok(c.plan) ? L.total : 0;
  }
  return LsaLayout(c.T, c.H, c.A, c.M, sizeof(CT), sizeof(ST),
                   KIND == ATT_LS).total;
}

template <int KIND, class CT, class ST>
cudaError_t att_run(const AttCall& c) {
  const size_t smem = att_smem<KIND, CT, ST>(c);
  if (smem == 0) return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(ST);
  const int vec = (uintptr_t)c.memory % 16 == 0 &&
                  ((long long)c.T * c.M) % V == 0;
  const int grid = (c.B + LSA_ROWS - 1) / LSA_ROWS * LSA_ROWS;
  const FwdArgs<CT> fa{(const float*)c.tp_in, (float*)c.tp_out,
                       (const float*)c.x, (const CT*)c.wc, (const CT*)c.wq_t,
                       (const CT*)c.wx, (const float*)c.bias, c.P};
  const StreamScales<CT> sc{(const float*)c.mem_scale, (const CT*)c.mt_scale};
  return launch_cluster(
      lsa_attention_kernel<KIND, CT, ST>, grid, LSA_THREADS, smem,
      LSA_ROWS, c.stream, (const float*)c.h_att, (const float*)c.cum,
      (const ST*)c.memory, (const ST*)c.mtb, (const float*)c.mask_add,
      (const CT*)c.wq, (const CT*)c.lc, (const float*)c.v,
      (float*)c.ctx_out, (float*)c.cum_out, (CT*)c.ctx_row, c.ld_row, c.B,
      c.T, c.H, c.A, c.M, c.K, vec, fa, sc, c.plan);
}

// the launch's clusters that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error
template <int KIND, class CT, class ST>
int att_clusters(const AttCall& c) {
  const size_t smem = att_smem<KIND, CT, ST>(c);
  if (smem == 0) return -(int)cudaErrorInvalidValue;
  const cudaError_t opt_in = opt_in_smem(lsa_attention_kernel<KIND, CT, ST>);
  if (opt_in != cudaSuccess) return -(int)opt_in;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = LSA_ROWS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((c.B + LSA_ROWS - 1) / LSA_ROWS * LSA_ROWS);
  cfg.blockDim = dim3(LSA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, (void*)lsa_attention_kernel<KIND, CT, ST>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <int KIND, class CT, class ST>
int att_call(const AttCall& c, bool clusters) {
  return clusters ? att_clusters<KIND, CT, ST>(c)
                  : (int)att_run<KIND, CT, ST>(c);
}

// the instance of KIND for the compute type (f32) and the streams (int8
// when the scales are given)
template <int KIND>
int att_dispatch(const AttCall& c, int f32, bool clusters = false) {
  const bool q8 = c.mem_scale != nullptr;
  // the float32 location-sensitive instances read float32 mtb in pairs and
  // copy lc in 16-byte chunks into swizzled rows (A a multiple of 16)
  const bool f32_ls = f32 && KIND == ATT_LS;
  if (q8 != (c.mt_scale != nullptr) || c.B <= 0 || c.T <= 0 || c.H <= 0 ||
      c.M <= 0 || c.A <= 0 || c.A % 8 != 0 || (uintptr_t)c.wq % 16 != 0 ||
      (uintptr_t)c.mtb % (q8 ? 2 : f32_ls ? 8 : 4) != 0 ||
      (f32_ls && (c.A % 16 != 0 || (uintptr_t)c.lc % 16 != 0)))
    return clusters ? -(int)cudaErrorInvalidValue
                    : (int)cudaErrorInvalidValue;
  if (f32)
    return q8 ? att_call<KIND, float, int8_t>(c, clusters)
              : att_call<KIND, float, float>(c, clusters);
  return q8 ? att_call<KIND, bf16, int8_t>(c, clusters)
            : att_call<KIND, bf16, bf16>(c, clusters);
}

struct GateArgs {
  const void* w;
  const void* ws;
  const void* bias;
  int kp;
  void* row_buf;
  void* rs_buf;
  const void* h_old;
  const void* c_old;
  void* h_new;
  void* c_new;
  void* h_row;
  int ld_row;
  void* q_out;
  int B, H;
  float zh, zc;
  cudaStream_t stream;
};

// the product on the W8A8 int8 row, or on the CT row (bf16 or float32)
template <bool INT8, bool ROW, class CT>
int gate_mma(const GateArgs& g) {
  typedef typename std::conditional<INT8, int8_t, CT>::type E;
  const EvalLstm<INT8, ROW, CT> epi{
      (const float*)g.rs_buf, (const float*)g.ws, (const float*)g.bias,
      (const float*)g.h_old, (const float*)g.c_old, (float*)g.h_new,
      (float*)g.c_new, (CT*)g.h_row, g.ld_row, g.H, g.zh, g.zc};
  const int kbytes = g.kp * (int)sizeof(E);
  return (int)gate_tile_launch<E>(g.row_buf, kbytes, g.w, kbytes, kbytes,
                                  g.B, g.H, epi, g.stream);
}

template <bool INT8, class CT>
int gate_lstm_run(const Segments<CT>& seg, const GateArgs& g) {
  const size_t row_smem = (size_t)(seg.k0 + seg.k1 + seg.k2) * sizeof(float);
  cudaError_t err = allow_smem(gate_rows_kernel<INT8, CT>, row_smem);
  if (err != cudaSuccess) return (int)err;
  gate_rows_kernel<INT8, CT><<<g.B, ROW_THREADS, row_smem, g.stream>>>(
      seg, g.kp, (uint32_t*)g.row_buf, (float*)g.rs_buf, (int8_t*)g.q_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return g.h_row != nullptr ? gate_mma<INT8, true, CT>(g)
                            : gate_mma<INT8, false, CT>(g);
}

template <class CT>
int gate_lstm_typed(const void* s0, int k0, const void* s1, int k1,
                    const void* s2, int k2, int quantized,
                    const GateArgs& args) {
  const Segments<CT> seg{(const float*)s0, (const float*)s1, (const float*)s2,
                         k0, k1, k2};
  return quantized ? gate_lstm_run<true, CT>(seg, args)
                   : gate_lstm_run<false, CT>(seg, args);
}

}  // namespace

extern "C" {

// the columns of P in `cl` shares of np (prenet_split); layer i draws its
// dropout at salt step * n_layers + i + 1 (pallas_decoder.py:518); keep_out
// (uint8 [n_layers, B, P]) is written only with the dropout on; the weights
// are bf16, or float32 with f32
int prenet_launch(const void* frame, const void* w_all, const void* b_all,
                  void* out, void* keep_out, int B, int in_dim, int P,
                  int n_layers, unsigned seed0, unsigned seed1, int step,
                  unsigned thresh, float scale, int apply_dropout, int cl,
                  int np, int f32, void* stream) {
  const PrenetArgs args{w_all, (const float*)b_all, B, in_dim,
                        P, n_layers, seed0, seed1,
                        (uint32_t)(step * n_layers + 1), thresh, scale,
                        apply_dropout, cl, np};
  const PrenetOut epi{(float*)out,
                      apply_dropout ? (uint8_t*)keep_out : nullptr, B, P,
                      n_layers};
  if (f32)
    return (int)prenet_tile_launch<PrenetOut, float>(frame, 0, args, epi,
                                                     (cudaStream_t)stream);
  return (int)prenet_tile_launch(frame, 0, args, epi, (cudaStream_t)stream);
}

// row_buf: scratch of B * Kp bytes (W8A8) or B * Kp elements of the
// compute type (bf16, or float32 with f32); rs_buf: B floats (W8A8 only);
// h_row: null, or rows of ld_row in the compute type that receive h_new.
// Launches gate_rows, then gate_mma.
int gate_lstm_launch(const void* s0, int k0, const void* s1, int k1,
                     const void* s2, int k2, const void* w, const void* ws,
                     const void* bias, int kp, int quantized, int f32,
                     void* row_buf, void* rs_buf, const void* h_old,
                     const void* c_old, void* h_new, void* c_new,
                     void* h_row, int ld_row, void* q_out, int B, int H,
                     float zh, float zc, void* stream) {
  if (kp % 64 != 0 || kp < k0 + k1 + k2 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const GateArgs args{w, ws, bias, kp, row_buf, rs_buf, h_old, c_old,
                      h_new, c_new, h_row, ld_row, q_out, B, H, zh, zc,
                      (cudaStream_t)stream};
  return f32 ? gate_lstm_typed<float>(s0, k0, s1, k1, s2, k2, quantized,
                                      args)
             : gate_lstm_typed<bf16>(s0, k0, s1, k1, s2, k2, quantized,
                                     args);
}

// ctx_row: null, or rows of ld_row in the compute type that receive the
// context.  A multiple of 8, K <= 32 taps, Wq 16-byte aligned.  f32: the
// float32 instance (h_att, cum as ever; Wq, lc in float32); mem_scale and
// mt_scale given: int8 memory and mtb, mem_scale [M] float32, mt_scale [A]
// in the compute type.  mt_tile, mt_stages, mem_tile, mem_stages: the
// staged instances' rings (StreamPlan; ops/fused_decoder.py
// att_stream_tiles), which the others ignore.
int lsa_attention_launch(const void* h_att, const void* cum,
                         const void* memory, const void* mtb,
                         const void* mask_add, const void* wq, const void* lc,
                         const void* v, void* ctx_out, void* cum_out,
                         void* ctx_row, int ld_row, int B, int T, int H,
                         int A, int M, int K, int f32, const void* mem_scale,
                         const void* mt_scale, int mt_tile, int mt_stages,
                         int mem_tile, int mem_stages, void* stream) {
  if (K < 1 || K > BAND_K) return (int)cudaErrorInvalidValue;
  const AttCall c{h_att, cum, memory, mtb, mask_add, wq, lc, v, ctx_out,
                  cum_out, ctx_row, ld_row, B, T, H, A, M, K, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                  mem_scale, mt_scale,
                  {mt_tile, mt_stages, mem_tile, mem_stages},
                  (cudaStream_t)stream};
  return att_dispatch<ATT_LS>(c, f32);
}

// the forward family's step: prev [B, T] the last step's weights, w_out
// the new ones (not in place); with the transition agent (trans = 1) tp_in
// and tp_out [B] (not in place), x [B, P] the prenet output, the agent's
// weight parts wc [Mem], wq_t [H], wx [P] in the compute type and its
// bias [1].  ctx_row, the alignments, f32, the int8 streams and the rings
// as lsa_attention_launch's.
int fwd_attention_launch(const void* h_att, const void* prev,
                         const void* tp_in, const void* memory,
                         const void* mtb, const void* mask_add,
                         const void* x, const void* wq, const void* v,
                         const void* wc, const void* wq_t, const void* wx,
                         const void* bias, void* ctx_out, void* w_out,
                         void* tp_out, void* ctx_row, int ld_row, int B,
                         int T, int H, int A, int M, int P, int trans,
                         int f32, const void* mem_scale, const void* mt_scale,
                         int mt_tile, int mt_stages, int mem_tile,
                         int mem_stages, void* stream) {
  if (trans && (P <= 0 || tp_in == nullptr || tp_out == nullptr ||
                x == nullptr || wc == nullptr || wq_t == nullptr ||
                wx == nullptr || bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttCall c{h_att, prev, memory, mtb, mask_add, wq, nullptr, v,
                  ctx_out, w_out, ctx_row, ld_row, B, T, H, A, M, 1, tp_in,
                  tp_out, x, wc, wq_t, wx, bias, P, mem_scale, mt_scale,
                  {mt_tile, mt_stages, mem_tile, mem_stages},
                  (cudaStream_t)stream};
  return trans ? att_dispatch<ATT_FWD_TRANS>(c, f32)
               : att_dispatch<ATT_FWD>(c, f32);
}

// the clusters of one attention launch (kind 0 location-sensitive, 1
// forward, 2 with the transition agent; f32, q8 and the rings as the
// launchers take them) that the card holds at once, or minus a CUDA error
int attention_clusters(int kind, int f32, int q8, int B, int T, int H,
                       int A, int M, int mt_tile, int mt_stages,
                       int mem_tile, int mem_stages) {
  // null operands pass the launchers' checks; the scales only mark q8
  static const float mark = 0.0f;
  const void* scale = q8 ? &mark : nullptr;
  const AttCall c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, 0, B, T, H,
                  A, M, 1, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0, scale, scale,
                  {mt_tile, mt_stages, mem_tile, mem_stages}, nullptr};
  return kind == ATT_LS  ? att_dispatch<ATT_LS>(c, f32, true)
         : kind == ATT_FWD ? att_dispatch<ATT_FWD>(c, f32, true)
                           : att_dispatch<ATT_FWD_TRANS>(c, f32, true);
}

// the head row [B, K] (rows of ld_row in the compute type) against the head
// weight [N, K] (N = M + 1): frame [B, M] and stop [B].  K is split into
// `slices` of `kslice`; with more than one, `scratch` holds slices * B * N
// floats.  f32: float32 row and weight (splitk_f32_kernel).
int head_launch(const void* row, int ld_row, const void* w, int K,
                const void* bias, int B, int N, void* frame, void* stop,
                int slices, int kslice, void* scratch, int f32,
                void* stream) {
  const HeadOut epi{(const float*)bias, nullptr, (float*)frame, (float*)stop,
                    N};
  if (f32)
    return splitk_f32_launch(row, ld_row, w, K, B, N, K, slices, kslice,
                             scratch, epi, stream);
  return splitk_launch<false, false>(row, ld_row, w, K, B, N, K, slices,
                                     kslice, scratch, epi, stream);
}

}  // extern "C"
