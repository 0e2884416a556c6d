// Hopper kernels of one free-running Tacotron 2 decoder step.
//
// Replaces the JAX package's TPU kernel ops/pallas_decoder.py::_build_kernel
// (one pallas_call running a whole chunk of decoder steps).  The Python
// wrapper (ops/fused_decoder.py) launches the kernels of a step: prenet,
// gate_lstm (gate_rows and gate_mma, once per LSTM), lsa_attention and
// head (the split-K product and its ordered reduction).  The compute type
// is bfloat16; carries and sums are float32.  Values are rounded to
// bfloat16 at the points where the TPU kernel rounds them, so the plain
// PyTorch version in ops/fused_decoder.py can repeat the arithmetic.
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
// the training backward's att_bwd) and the context over 16-byte loads.
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
  __device__ __forceinline__ void raw(int, int, bf16) const {}
  __device__ __forceinline__ void put(int layer, int row, int col, float y,
                                      bool kept) const {
    if (keep != nullptr)
      keep[((size_t)layer * B + row) * P + col] = kept ? 1 : 0;
    if (layer == n_layers - 1) out[(size_t)row * P + col] = y;
  }
};

// ---------------------------------------------------------------------------
// gate_lstm, two launches per LSTM:
//   gate_rows: the concat row [s0 | s1 | s2] in the compute type, built once
//     per batch row.  W8A8: rs = max(amax, 1e-6) * (1/127), inv = 1/rs
//     (IEEE), q = clip(rint(x * inv)) -> the int8 row [B, Kp] and rs [B];
//     bf16: the bf16 row [B, Kp].  Zero padded to Kp.
//   gate_mma: gates = row @ W^T on the tensor cores (gate_tile_kernel of
//     csrc/tile.cuh, which the training decoder's gate product runs too),
//     then the W8A8 dequant, the LSTM pointwise step and eval zoneout in
//     the epilogue, EvalLstm.
// W is [4H, Kp] (one row per gate column, K contiguous, Kp a multiple of
// 64), so the row and W are the row.col operands of mma.sync as they lie.
// ---------------------------------------------------------------------------
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
    return round_bf16(v);
  }
};

constexpr int ROW_THREADS = 256;

// one block per batch row; dynamic shared memory holds the row (K floats)
template <bool INT8>
__global__ void __launch_bounds__(ROW_THREADS)
gate_rows_kernel(Segments seg, int kp, uint32_t* __restrict__ row_out,
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
// in the TPU kernel's order, ((acc * rs) * ws) + b, or the bias of bf16
// sums; the LSTM pointwise step and eval zoneout; with ROW (the generator
// LSTM in a chunk) also h in bf16 into the head row.  ROW is a template
// argument because the store alone changes the compiled gate kernel: at
// B=240 in W8A8 it drops from 121 to 97 registers and runs about 5 % slower
// on the H100, which the attention LSTM need not pay.
template <bool INT8, bool ROW>
struct EvalLstm {
  const float* rs;
  const float* ws;
  const float* bias;
  const float* h_old;
  const float* c_old;
  float* h_new;
  float* c_new;
  __nv_bfloat16* h_row;   // bf16(h_new) into the head row (ROW)
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
      h_row[(size_t)row * ld_row + unit] = __float2bfloat16_rn(ho);
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
// ---------------------------------------------------------------------------
constexpr int LSA_THREADS = 256, LSA_WARPS = LSA_THREADS / 32;
constexpr int LSA_ROWS = 8;   // CTAs (batch rows) a cluster

// the forward family's extra operands (all null for location-sensitive)
struct FwdArgs {
  const float* tp_in;    // [B] the transition probability of the last step
  float* tp_out;         // [B]
  const float* x;        // [B, P] float32 prenet output of this step
  const __nv_bfloat16* wc;   // [Mem] the agent's weights, bf16
  const __nv_bfloat16* wq;   // [H]
  const __nv_bfloat16* wx;   // [P]
  const float* bias;     // [1]
  int P;
};

// shared-memory layout of lsa_attention_kernel (byte offsets)
struct LsaLayout {
  int kq, ldh, ld, tpad;
  CtxScheme cs;   // the context's chunk scheme (csrc/tile.cuh)
  size_t wq, h, qp, q, v, lc, cum, e, red, cpart, total;
  __host__ __device__ LsaLayout(int T, int H, int A, int M)
      : cs(M, LSA_THREADS) {
    kq = ((H + LSA_ROWS - 1) / LSA_ROWS + 31) / 32 * 32;
    ldh = kq + 8;
    ld = A + 8;   // rows of Wq and of lc
    tpad = (T + 15) / 16 * 16;
    wq = 0;
    h = wq + align16((size_t)kq * ld * 2);
    qp = h + align16((size_t)LSA_ROWS * ldh * 2);
    q = qp + align16((size_t)LSA_ROWS * A * 4);
    v = q + align16((size_t)A * 4);
    lc = v + align16((size_t)A * 4);
    cum = lc + align16((size_t)BAND_K * ld * 2);
    e = cum + align16((size_t)(tpad + BAND_K) * 2);
    red = e + align16((size_t)tpad * 4);
    cpart = red + 32 * 4;
    total = cpart + align16(cs.scratch_floats(M) * 4);
  }
};

template <int KIND>
__global__ void __launch_bounds__(LSA_THREADS)
lsa_attention_kernel(const float* __restrict__ h_att,
                     const float* __restrict__ cum,
                     const __nv_bfloat16* __restrict__ memory,
                     const __nv_bfloat16* __restrict__ mtb,
                     const float* __restrict__ mask_add,
                     const __nv_bfloat16* __restrict__ wq,
                     const __nv_bfloat16* __restrict__ lc,
                     const float* __restrict__ v, float* __restrict__ ctx_out,
                     float* __restrict__ cum_out,
                     __nv_bfloat16* __restrict__ ctx_row, int ld_row, int B,
                     int T, int H, int A, int M, int K, int vec, FwdArgs fa) {
  extern __shared__ __align__(16) uint8_t lsa_smem[];
  const LsaLayout L(T, H, A, M);
  bf16* s_wq = reinterpret_cast<bf16*>(lsa_smem + L.wq);     // [kq][ld]
  bf16* s_h = reinterpret_cast<bf16*>(lsa_smem + L.h);       // [ROWS][ldh]
  float* s_qp = reinterpret_cast<float*>(lsa_smem + L.qp);   // [ROWS][A]
  float* s_q = reinterpret_cast<float*>(lsa_smem + L.q);     // [A]
  float* s_v = reinterpret_cast<float*>(lsa_smem + L.v);     // [A]
  bf16* s_lc = reinterpret_cast<bf16*>(lsa_smem + L.lc);     // [32][ld]
  bf16* s_cum = reinterpret_cast<bf16*>(lsa_smem + L.cum);   // [tpad + 32]
  float* s_e = reinterpret_cast<float*>(lsa_smem + L.e);     // [tpad]
  float* s_red = reinterpret_cast<float*>(lsa_smem + L.red); // [32]
  float* s_cpart = reinterpret_cast<float*>(lsa_smem + L.cpart);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x, row0 = b - rank;
  const bool live = b < B;
  const int half = (K - 1) / 2;
  const __nv_bfloat16* mem_b = memory + (size_t)b * T * M;
  const __nv_bfloat16* mtb_b = mtb + (size_t)b * T * A;

  // this CTA's kq rows of Wq (zero past H) and the cluster's rows of
  // bf16(h_att) over them (zero past B)
  const int k_lo = rank * L.kq, a_chunks = A / 8;
  for (int i = tid; i < L.kq * a_chunks; i += LSA_THREADS) {
    const int r = i / a_chunks, c = (i - r * a_chunks) * 8, k = k_lo + r;
    cp_async16(s_wq + r * L.ld + c, k < H ? wq + (size_t)k * A + c : wq,
               k < H ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < LSA_ROWS * L.kq; i += LSA_THREADS) {
    const int r = i / L.kq, k = i - r * L.kq;
    const int row = row0 + r, kk = k_lo + k;
    s_h[r * L.ldh + k] = __float2bfloat16_rn(
        row < B && kk < H ? h_att[(size_t)row * H + kk] : 0.0f);
  }
  if (KIND == ATT_LS && live) {
    band_stage_lc(s_lc, L.ld, lc, K, A);
    band_stage_cum(s_cum, L.tpad + BAND_K, cum + (size_t)b * T, 0, half, T);
  }
  cp_async_wait<0>();
  __syncthreads();

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
  cluster_sync();
  for (int a = tid; a < A; a += LSA_THREADS) {
    float sum = 0.0f;
    for (int j = 0; j < LSA_ROWS; ++j)
      sum += cluster_peer(s_qp, j)[rank * A + a];
    s_q[a] = round_bf16(sum);
    s_v[a] = v[a];
  }
  // the peers' partials are read: they may exit once this CTA has too
  cluster_arrive();
  __syncthreads();

  if (live) {
    // 2. energies, one warp per 16 positions
    for (int t0 = warp * 16; t0 < L.tpad; t0 += LSA_WARPS * 16) {
      uint32_t af[2][4];
      if (KIND == ATT_LS) band_frags(af, s_cum + t0, lane);
      const int ta = t0 + g, tb = ta + 8;
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll 4
      for (int n0 = 0; n0 < A; n0 += 8) {
        const int a = n0 + 2 * qd;
        const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
        const __nv_bfloat162 m0 =
            ta < T ? *reinterpret_cast<const __nv_bfloat162*>(
                         mtb_b + (size_t)ta * A + a)
                   : zero2;
        const __nv_bfloat162 m1 =
            tb < T ? *reinterpret_cast<const __nv_bfloat162*>(
                         mtb_b + (size_t)tb * A + a)
                   : zero2;
        const float q0 = s_q[a], q1 = s_q[a + 1];
        const float v0 = s_v[a], v1 = s_v[a + 1];
        if (KIND == ATT_LS) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          band_loc(acc, af, s_lc, L.ld, n0, lane);
          e0 = fmaf(v0, band_energy_tanh(acc[0], q0, __low2float(m0)), e0);
          e0 = fmaf(v1, band_energy_tanh(acc[1], q1, __high2float(m0)), e0);
          e1 = fmaf(v0, band_energy_tanh(acc[2], q0, __low2float(m1)), e1);
          e1 = fmaf(v1, band_energy_tanh(acc[3], q1, __high2float(m1)), e1);
        } else {
          e0 = fmaf(v0, fwd_energy_tanh(q0, __low2float(m0)), e0);
          e0 = fmaf(v1, fwd_energy_tanh(q1, __high2float(m0)), e0);
          e1 = fmaf(v0, fwd_energy_tanh(q0, __low2float(m1)), e1);
          e1 = fmaf(v1, fwd_energy_tanh(q1, __high2float(m1)), e1);
        }
      }
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      if (qd == 0) {
        // the forward family's softmax is unmasked
        const float* mk = mask_add + (size_t)b * T;
        if (ta < T) s_e[ta] = KIND == ATT_LS ? e0 + mk[ta] : e0;
        if (tb < T) s_e[tb] = KIND == ATT_LS ? e1 + mk[tb] : e1;
      }
    }
    __syncthreads();

    // 3. softmax; ls: cum' = cum + w; the forward family: the recurrence,
    // the mask, the floor and the renorm, state w.  s_e <- bf16(w)
    float mx = -CUDART_INF_F;
    for (int t = tid; t < T; t += LSA_THREADS) mx = fmaxf(mx, s_e[t]);
    mx = block_reduce<true>(mx, s_red);
    float sum = 0.0f;
    for (int t = tid; t < T; t += LSA_THREADS) {
      const float p = expf(s_e[t] - mx);
      s_e[t] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, s_red);
    const float* cum_b = cum + (size_t)b * T;
    if (KIND == ATT_LS) {
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float wt = s_e[t] / sum;
        cum_out[(size_t)b * T + t] = cum_b[t] + wt;
        s_e[t] = round_bf16(wt);
      }
    } else {
      const float tp = KIND == ATT_FWD_TRANS ? fa.tp_in[b] : 0.0f;
      float wsum = 0.0f;
      for (int t = tid; t < T; t += LSA_THREADS) {
        const float energy = s_e[t] / sum;
        const float prev = cum_b[t];
        const float sh = t > 0 ? round_bf16(cum_b[t - 1]) : 0.0f;
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
        s_e[t] = round_bf16(wt);
      }
    }
    __syncthreads();

    // 4. context (csrc/tile.cuh: ctx_partials, ctx_column); the agent's
    // context term on the way
    ctx_partials(L.cs, s_cpart, mem_b, s_e, T, M, vec, LSA_THREADS);
    __syncthreads();
    float lin = 0.0f;
    for (int m = tid; m < M; m += LSA_THREADS) {
      const float acc = ctx_column(L.cs, s_cpart, M, m);
      ctx_out[(size_t)b * M + m] = acc;
      if (ctx_row != nullptr)
        ctx_row[(size_t)b * ld_row + m] = __float2bfloat16_rn(acc);
      if (KIND == ATT_FWD_TRANS)
        lin = fmaf(round_bf16(acc), __bfloat162float(fa.wc[m]), lin);
    }
    if (KIND == ATT_FWD_TRANS) {
      // 5. the transition agent over [bf16(ctx) | bf16(h_att) | bf16(x)]
      for (int k = tid; k < H; k += LSA_THREADS)
        lin = fmaf(round_bf16(h_att[(size_t)b * H + k]),
                   __bfloat162float(fa.wq[k]), lin);
      for (int p = tid; p < fa.P; p += LSA_THREADS)
        lin = fmaf(round_bf16(fa.x[(size_t)b * fa.P + p]),
                   __bfloat162float(fa.wx[p]), lin);
      lin = block_reduce<false>(lin, s_red);
      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + fa.bias[0])));
    }
  }
  cluster_wait();
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

template <bool INT8, bool ROW>
int gate_mma(const GateArgs& g) {
  const EvalLstm<INT8, ROW> epi{(const float*)g.rs_buf, (const float*)g.ws,
                                (const float*)g.bias, (const float*)g.h_old,
                                (const float*)g.c_old, (float*)g.h_new,
                                (float*)g.c_new, (__nv_bfloat16*)g.h_row,
                                g.ld_row, g.H, g.zh, g.zc};
  const int kbytes = g.kp * (INT8 ? 1 : 2);
  return (int)gate_tile_launch<INT8>(g.row_buf, kbytes, g.w, kbytes, kbytes,
                                     g.B, g.H, epi, g.stream);
}

template <bool INT8>
int gate_lstm_run(const Segments& seg, const GateArgs& g) {
  const size_t row_smem = (size_t)(seg.k0 + seg.k1 + seg.k2) * sizeof(float);
  cudaError_t err = allow_smem(gate_rows_kernel<INT8>, row_smem);
  if (err != cudaSuccess) return (int)err;
  gate_rows_kernel<INT8><<<g.B, ROW_THREADS, row_smem, g.stream>>>(
      seg, g.kp, (uint32_t*)g.row_buf, (float*)g.rs_buf, (int8_t*)g.q_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return g.h_row != nullptr ? gate_mma<INT8, true>(g)
                            : gate_mma<INT8, false>(g);
}

}  // namespace

extern "C" {

// the columns of P in `cl` shares of np (prenet_split); layer i draws its
// dropout at salt step * n_layers + i + 1 (pallas_decoder.py:518); keep_out
// (uint8 [n_layers, B, P]) is written only with the dropout on
int prenet_launch(const void* frame, const void* w_all, const void* b_all,
                  void* out, void* keep_out, int B, int in_dim, int P,
                  int n_layers, unsigned seed0, unsigned seed1, int step,
                  unsigned thresh, float scale, int apply_dropout, int cl,
                  int np, void* stream) {
  const PrenetArgs args{(const bf16*)w_all, (const float*)b_all, B, in_dim,
                        P, n_layers, seed0, seed1,
                        (uint32_t)(step * n_layers + 1), thresh, scale,
                        apply_dropout, cl, np};
  const PrenetOut epi{(float*)out,
                      apply_dropout ? (uint8_t*)keep_out : nullptr, B, P,
                      n_layers};
  return (int)prenet_tile_launch(frame, 0, args, epi, (cudaStream_t)stream);
}

// row_buf: scratch of B * Kp bytes (W8A8) or B * Kp bf16; rs_buf: B floats
// (W8A8 only); h_row: null, or bf16 rows of ld_row that receive bf16(h_new).
// Launches gate_rows, then gate_mma.
int gate_lstm_launch(const void* s0, int k0, const void* s1, int k1,
                     const void* s2, int k2, const void* w, const void* ws,
                     const void* bias, int kp, int quantized, void* row_buf,
                     void* rs_buf, const void* h_old, const void* c_old,
                     void* h_new, void* c_new, void* h_row, int ld_row,
                     void* q_out, int B, int H, float zh, float zc,
                     void* stream) {
  if (kp % 64 != 0 || kp < k0 + k1 + k2 || B <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  Segments seg{(const float*)s0, (const float*)s1, (const float*)s2,
               k0, k1, k2};
  const GateArgs args{w, ws, bias, kp, row_buf, rs_buf, h_old, c_old,
                      h_new, c_new, h_row, ld_row, q_out, B, H, zh, zc,
                      (cudaStream_t)stream};
  return quantized ? gate_lstm_run<true>(seg, args)
                   : gate_lstm_run<false>(seg, args);
}

// ctx_row: null, or bf16 rows of ld_row that receive bf16(ctx).  A
// multiple of 8, K <= 32 taps, Wq 16-byte aligned.
int lsa_attention_launch(const void* h_att, const void* cum,
                         const void* memory, const void* mtb,
                         const void* mask_add, const void* wq, const void* lc,
                         const void* v, void* ctx_out, void* cum_out,
                         void* ctx_row, int ld_row, int B, int T, int H,
                         int A, int M, int K, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || M <= 0 || A <= 0 || A % 8 != 0 ||
      K < 1 || K > BAND_K || (uintptr_t)wq % 16 != 0 ||
      (uintptr_t)mtb % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const LsaLayout L(T, H, A, M);
  const int vec = (uintptr_t)memory % 16 == 0 && ((long long)T * M) % 8 == 0;
  const int grid = (B + LSA_ROWS - 1) / LSA_ROWS * LSA_ROWS;
  return (int)launch_cluster(
      lsa_attention_kernel<ATT_LS>, grid, LSA_THREADS, L.total, LSA_ROWS,
      (cudaStream_t)stream, (const float*)h_att, (const float*)cum,
      (const __nv_bfloat16*)memory, (const __nv_bfloat16*)mtb,
      (const float*)mask_add, (const __nv_bfloat16*)wq,
      (const __nv_bfloat16*)lc, (const float*)v, (float*)ctx_out,
      (float*)cum_out, (__nv_bfloat16*)ctx_row, ld_row, B, T, H, A, M, K,
      vec, FwdArgs{});
}

// the forward family's step: prev [B, T] the last step's weights, w_out
// the new ones (not in place); with the transition agent (trans = 1) tp_in
// and tp_out [B] (not in place), x [B, P] the prenet output, the agent's
// bf16 weight parts wc [Mem], wq_t [H], wx [P] and its bias [1].  ctx_row
// and the alignments as lsa_attention_launch's.
int fwd_attention_launch(const void* h_att, const void* prev,
                         const void* tp_in, const void* memory,
                         const void* mtb, const void* mask_add,
                         const void* x, const void* wq, const void* v,
                         const void* wc, const void* wq_t, const void* wx,
                         const void* bias, void* ctx_out, void* w_out,
                         void* tp_out, void* ctx_row, int ld_row, int B,
                         int T, int H, int A, int M, int P, int trans,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || M <= 0 || A <= 0 || A % 8 != 0 ||
      (uintptr_t)wq % 16 != 0 || (uintptr_t)mtb % 4 != 0 ||
      (trans && (P <= 0 || tp_in == nullptr || tp_out == nullptr ||
                 x == nullptr || wc == nullptr || wq_t == nullptr ||
                 wx == nullptr || bias == nullptr)))
    return (int)cudaErrorInvalidValue;
  const LsaLayout L(T, H, A, M);
  const int vec = (uintptr_t)memory % 16 == 0 && ((long long)T * M) % 8 == 0;
  const int grid = (B + LSA_ROWS - 1) / LSA_ROWS * LSA_ROWS;
  const FwdArgs fa{(const float*)tp_in, (float*)tp_out, (const float*)x,
                   (const __nv_bfloat16*)wc, (const __nv_bfloat16*)wq_t,
                   (const __nv_bfloat16*)wx, (const float*)bias, P};
  return (int)launch_cluster(
      trans ? &lsa_attention_kernel<ATT_FWD_TRANS>
            : &lsa_attention_kernel<ATT_FWD>,
      grid, LSA_THREADS, L.total, LSA_ROWS, (cudaStream_t)stream,
      (const float*)h_att, (const float*)prev, (const __nv_bfloat16*)memory,
      (const __nv_bfloat16*)mtb, (const float*)mask_add,
      (const __nv_bfloat16*)wq, (const __nv_bfloat16*)nullptr,
      (const float*)v, (float*)ctx_out, (float*)w_out,
      (__nv_bfloat16*)ctx_row, ld_row, B, T, H, A, M, 1, vec, fa);
}

// the head row [B, K] (bf16 rows of ld_row) against the head weight [N, K]
// (N = M + 1): frame [B, M] and stop [B].  K is split into `slices` of
// `kslice`; with more than one, `scratch` holds slices * B * N floats.
int head_launch(const void* row, int ld_row, const void* w, int K,
                const void* bias, int B, int N, void* frame, void* stop,
                int slices, int kslice, void* scratch, void* stream) {
  const HeadOut epi{(const float*)bias, nullptr, (float*)frame, (float*)stop,
                    N};
  return splitk_launch<false, false>(row, ld_row, w, K, B, N, K, slices,
                                     kslice, scratch, epi, stream);
}

}  // extern "C"
