// Hopper kernels of the teacher-forced Tacotron 2 decoder in training: the
// forward step (K2) and its reverse-time backward step (K3).
//
// Replaces the JAX package's TPU kernels
//   ops/pallas_train_decoder.py::_build_fwd_kernel  (K2, one chunk forward)
//   ops/pallas_train_decoder.py::_build_bwd_kernel  (K3, one chunk backward)
// The Python wrapper (ops/fused_train_decoder.py) loops over the steps and
// launches, per forward step: train_prenet, gate_lstm (attention LSTM),
// query, train_attention, gate_lstm (generator LSTM), head; per backward
// step: bwd_head (with the generator cell's backward in its epilogue),
// bwd_gemm (generator), query, att_bwd, bwd_gemm (query, with the
// attention cell's backward in its epilogue), bwd_gemm (attention),
// bwd_prenet; and once per backward pass the dWq reduction (bwd_gemm over
// all steps and rows).  A train_query, train_head or bwd_gemm call is one
// launch, or two when it splits K: 11 launches a backward step at the
// flagship's widths and B=50.
//
// Every kernel is a template on the compute type CT, bfloat16 or float32
// (the JAX package's compute_dtype; ops/pallas_train_decoder.py writes its
// residual streams in it), and each launcher takes an `f32` flag that picks
// the instance.  In bf16 every product runs on the tensor cores (mma.sync
// m16n8k16, bfloat16 inputs, float32 sums) in the three tile routines of
// csrc/tile.cuh, or in bwd_head and bwd_prenet.  In float32 nothing is
// rounded and every product is float32-accurate, as the TPU kernel's
// full-precision float32 matmuls (ops/pallas_train_decoder.py:230-239):
// the gate products, the split-K products (splitk_f32_kernel), bwd_head's
// product, train_attention's location conv, att_bwd's three band products
// and bwd_prenet's products on the tensor cores in three TF32 passes
// (csrc/tile.cuh mma_tf32x3), as the serving decoder's float32 instances;
// the other small products on the CUDA cores in FFMA.  The forward
// prenet runs in prenet_tile_kernel (shared with the serving decoder's
// prenet): one clustered launch whose CTAs own column slices of each layer
// and exchange the compute-type rows over distributed shared memory.  The
// gate products run in gate_tile_kernel
// (shared with the serving decoder's gate product), with the LSTM step and
// zoneout or dropout in the epilogue.  The attention query, the head and
// the backward's dgates @ W^T, dq @ Wq^T and dWq run in splitk_kernel
// (shared with the serving decoder's head), which reads transposed
// operands as they lie through ldmatrix.trans and splits K over the grid
// (splitk_f32_kernel in float32, which stages them as they lie).
// The head backward (K = 80 mels) is one launch of its own kernel, a grid
// over column tiles of H + Mem that builds its A tile from the float32
// cotangents.  The forward's attention (train_attention) and its backward
// (att_bwd) each split a batch row over a thread-block cluster of up to 8
// tiles of positions (a tile grows with T: any length whose per-position
// rows fit a CTA's shared memory) and run the location conv as band
// products (csrc/tile.cuh, shared with the serving decoder's
// lsa_attention: the forward's energy; the backward's energy recompute,
// filter and cum gradients), exchanging the softmax statistics, the cum
// halo and the partial sums through distributed shared memory; the
// forward's context reads the tile's memory rows with 16-byte loads
// (csrc/tile.cuh ctx_*, shared with lsa_attention), from a copy in shared
// memory where it fits.  The
// prenet backward (bwd_prenet) is one clustered launch whose CTAs own
// column slices of each layer and exchange the da rows the same way.
// An eval forward (ops/pallas_train_decoder.py train=False) runs the same
// kernels with deterministic zoneout and writes no residual streams.
// Accumulators (dmt, the [K, A] location-conv grad dlc, dv) are per batch
// row and summed once at the end, partial sums are summed in a fixed order:
// no float atomics, so a run repeats bit for bit.
//
// Bound on the H100: a step's two gate products are 2*B*(K_att+K_gen)*4H
// bf16 operations (1.6 G at B=50), 1.6 us at 989 TFLOP/s, against 32 MB of
// gate weights that each step reads (9.6 us at 3.35 TB/s, mostly from L2
// after the first step); the backward repeats them transposed.  The forward
// launches one kernel per stage and step; with B=50 a gate product runs 64
// blocks of 64 rows by 16 units, each weight tile read once.  The query
// and head products (K = 1024 and 1344 against 2 output tiles) and the
// backward's dgates @ W^T (K = 4H) split K into S slices, so that each runs
// a few dozen to a few hundred blocks of all 50 rows, each weight tile read
// once, plus one small reduction launch.  In float32 the gate products are
// three TF32 passes of the same 1.6 G operations, 10 us at 495 TFLOP/s,
// against 65 MB of float32 gate weights (19 us), more than the 50 MB L2
// holds; K is split over clusters of two CTAs, so 128 CTAs stream them.
//
// Values are rounded to the compute type where the TPU kernels store or
// multiply in it (round_to<CT>, from_float<CT>: nothing in float32), so the
// plain PyTorch versions can repeat the arithmetic.
// Random bits: mask element (row, col) of site `salt` at global step gs
// draws rand_bits(row, col; seed0, seed1, gs * (n_prenet + 4) + salt), as
// ops/pallas_train_decoder.py::_salt_layout does.
//
// Interface: plain extern "C" launchers taking device pointers and a
// cudaStream_t as void*, each returning cudaGetLastError().

#include "common.cuh"
#include "tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// train_gate_lstm: gates = row @ W^T, the shared gate_tile_kernel of
// csrc/tile.cuh (on the tensor cores: bf16 with float32 sums; float32 in
// three TF32 passes, K split over a cluster of CTAs), with the LSTM step
// and the train-mode regularization in its epilogue, LstmEpi.
// ---------------------------------------------------------------------------

// regularization of an LSTM cell (ops/pallas_train_decoder.py:375-401):
// in train mode 0 none, 1 zoneout (keep new where bits < thresh), 2 output
// dropout on h (c untouched); in eval mode 3, zoneout's deterministic
// interpolation z * old + (1 - z) * new for h and c (an eval dropout cell
// is mode 0)
struct Reg {
  uint32_t seed0, seed1, salt_h, salt_c, th_h, th_c;
  int mode;
  float scale;   // 1 / keep of the h dropout
  float zh, zc;  // the zoneout rates of h and c
};

// gates + bias -> i, f, g, o; the LSTM step; the regularization; writes the
// float32 carries, the activations and c stream in the compute type CT
// (train mode; null in an eval forward, which keeps no residual streams),
// and h in CT into up to two concat rows
template <class CT>
struct LstmEpi {
  const float* bias;
  float* h;
  float* c;
  CT* act;
  CT* c_out;
  CT* h_dst0;
  int ld0;
  CT* h_dst1;
  int ld1;
  int H;
  Reg reg;
  __device__ void operator()(int row, int unit, const float* g) const {
    const float gi = sigmoid(g[0] + bias[unit]);
    const float gf = sigmoid(g[1] + bias[H + unit]);
    const float gg = tanhf(g[2] + bias[2 * H + unit]);
    const float go = sigmoid(g[3] + bias[3 * H + unit]);
    const size_t o = (size_t)row * H + unit;
    const float c_prev = c[o], h_prev = h[o];
    const float cn = gf * c_prev + gi * gg;
    const float hn = go * tanhf(cn);
    if (act != nullptr) {
      CT* a = act + (size_t)row * 4 * H + unit;
      a[0] = from_float<CT>(gi);
      a[H] = from_float<CT>(gf);
      a[2 * H] = from_float<CT>(gg);
      a[3 * H] = from_float<CT>(go);
    }
    float ho = hn, co = cn;
    if (reg.mode == 1) {
      const uint32_t bh = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                    reg.salt_h);
      const uint32_t bc = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                    reg.salt_c);
      ho = bh < reg.th_h ? hn : h_prev;
      co = bc < reg.th_c ? cn : c_prev;
    } else if (reg.mode == 2) {
      const uint32_t bh = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                    reg.salt_h);
      ho = bh < reg.th_h ? hn * reg.scale : 0.0f;
    } else if (reg.mode == 3) {
      // each product and the sum rounded once, as the plain version
      ho = __fadd_rn(__fmul_rn(reg.zh, h_prev), __fmul_rn(1.0f - reg.zh, hn));
      co = __fadd_rn(__fmul_rn(reg.zc, c_prev), __fmul_rn(1.0f - reg.zc, cn));
    }
    h[o] = ho;
    c[o] = co;
    if (c_out != nullptr) c_out[o] = from_float<CT>(co);
    const CT hb = from_float<CT>(ho);
    h_dst0[(size_t)row * ld0 + unit] = hb;
    if (h_dst1 != nullptr) h_dst1[(size_t)row * ld1 + unit] = hb;
  }
};

// ---------------------------------------------------------------------------
// the epilogues of splitk_kernel (csrc/tile.cuh) that only the training
// decoder runs; the heads' HeadOut is in tile.cuh
// ---------------------------------------------------------------------------

// out[row, col - lo] = add[row, col - lo] + v for the segment [lo, hi) that
// holds col (add may be null, or equal to out; unused segments: null out)
struct SegOut {
  int lo[3], hi[3], ldo[3], ldadd[3];
  float* out[3];
  const float* add[3];
  __device__ __forceinline__ void put(int row, int col, float v) const {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (out[s] == nullptr || col < lo[s] || col >= hi[s]) continue;
      const int j = col - lo[s];
      const float base =
          add[s] != nullptr ? add[s][(size_t)row * ldadd[s] + j] : 0.0f;
      out[s][(size_t)row * ldo[s] + j] = base + v;
    }
  }
};

// q = round_to<CT>(h @ Wq), held in float32 [M, N]
template <class CT>
struct RoundOut {
  float* out;
  int n;
  __device__ __forceinline__ void put(int row, int col, float v) const {
    out[(size_t)row * n + col] = round_to<CT>(v);
  }
};

// ---------------------------------------------------------------------------
// train_prenet: csrc/tile.cuh's prenet_tile_kernel (shared with the serving
// decoder's prenet) on the input frame (the shifted target at a teacher
// step, the previous prediction otherwise), with the training epilogue:
// the raw frame and each layer's post-dropout output in the compute type
// (streams; null in an eval forward) and the last layer into the attention
// LSTM's concat row.
// ---------------------------------------------------------------------------
template <class CT>
struct TrainPrenetOut {
  CT* raw_out;           // [B, in_dim], or null
  CT* pre_out;           // [n_layers] x [B, P] at pre_stride, or null
  long long pre_stride;
  CT* dst;               // [B, P] rows of ld_dst
  int ld_dst;
  float* x_out;          // [B, P] float32 copy of the output, or null
  int in_dim, P, n_layers;
  __device__ __forceinline__ void raw(int row, int k, CT v) const {
    if (raw_out != nullptr) raw_out[(size_t)row * in_dim + k] = v;
  }
  __device__ __forceinline__ void put(int layer, int row, int col, float y,
                                      bool) const {
    const CT yb = from_float<CT>(y);
    if (pre_out != nullptr)
      pre_out[layer * pre_stride + (size_t)row * P + col] = yb;
    if (layer == n_layers - 1) {
      dst[(size_t)row * ld_dst + col] = yb;
      if (x_out != nullptr) x_out[(size_t)row * P + col] = y;
    }
  }
};

// ---------------------------------------------------------------------------
// train_attention: the attention of one teacher-forced step
// (ops/pallas_train_decoder.py:437-517, location-sensitive):
//   loc = band(cum) @ lc (the location conv of the bf16 cum)
//   e[t] = sum_a v[a] bf16(tanh(bf16(bf16(bf16(loc) + q) + mtb))) + mask
//   w = softmax(e) -> the weights stream; cum before the step -> its bf16
//   stream (train mode; null in an eval forward); cum += w
//   ctx[m] = sum_t bf16(mem[t, m] * bf16(w[t])) -> the float32 carry and
//   bf16 copies into up to three concat rows
// A batch row is a cluster of `cl` CTAs, CTA `rank` owning the `tile`
// positions from rank * tile (tile a multiple of 16; cl * tile covers T:
// ops/fused_train_decoder.py::att_bwd_tiles, as att_bwd).  Each CTA
// issues all its reads of device memory at the start (lc and its tile's
// mtb and memory rows with cp.async), so that their latencies overlap;
// then the energies of its positions as the band product on the tensor
// cores (csrc/tile.cuh band_*, cum staged with its 15-position halo), a
// warp per 16 channels down the tile with the bf16 pairs of mtb in the
// epilogue, the warps' partials summed in warp order; the row's softmax
// from the tile maxima and then the tile sums of exp(e - max), each summed
// by every CTA from the cluster's shared memory in rank order after a
// cluster barrier, so that all CTAs hold the same max and sum; its tile's
// context partial with 16-byte loads of the tile's memory rows
// (csrc/tile.cuh ctx_*); after a third barrier a 1/cl share of the Mem
// columns, summed over the cluster's partials in rank order.  No float
// atomics: a run repeats bit for bit.
//
// In float32 (CT float) nothing is rounded: the location conv is the same
// band product on the tensor cores in three TF32 passes (m16n8k8,
// mma_tf32x3), the A fragments from cum's TF32 halves, split once when
// staged (band_stage_cum_tf32, band_frag_tf32), the B fragments from lc
// in swizzled rows of A words (band_copy_lc_tf32, band_frag_kn), split in
// registers where they are read (at T <= 128 each lc value is read by one
// warp once, so a split copy in shared memory would save nothing); then
// tanh((loc + q) + mtb) from the accumulator fragments, the warps' partial
// energies summed in warp order as in bf16; the context sums float32
// products of float32 rows.  The forward family's float32 instances keep
// a warp a position, a lane every 32nd channel.
//
// Long texts: a tile has T / 8 positions or more (att_bwd_tiles), and the
// tile's copies of its mtb and memory rows are kept only while they fit the
// CTA's 227 KB of shared memory (ta_stage: both, mtb alone, or neither);
// otherwise the energy and the context read them from device memory (the
// context with the same 16-byte loads).  What stays in shared memory grows
// by under 50 bytes a position in bf16 and by 52 in float32 (four float
// rows, cum's TF32 halves and the eight warps' partial energies).
//
// Bound on the H100: the bytes of memory and mtb (B*T*(Mem + A) bf16,
// 5.4 MB at B=50, T=128) and the rest, 1.69 us at 3.35 TB/s.  What costs
// is latency: one block a batch row would fill 50 of 132 SMs at B=50 and
// wait on each dependent load in turn, so T=128 runs 8 CTAs of 16
// positions a row (400 CTAs at B=50), each with all its loads in flight at
// once and three cluster barriers.
//
// The forward family (KIND ATT_FWD, ATT_FWD_TRANS;
// ops/pallas_train_decoder.py:483-539) runs the same kernel without the
// location conv: e[t] = sum_a v[a] bf16(tanh(bf16(q + mtb))), unmasked;
// energy = softmax(e); comb = prev + bf16(prev[t-1]), or (1 - tp) prev +
// tp bf16(prev[t-1]) with the transition agent, prev the float32 carry
// (the last step's weights; the tile's first position reads its
// neighbour's last as a halo before any CTA writes); w = mask ? comb *
// energy : 0, floored at 1e-6, over its sum; the carry receives w itself.
// With the agent, the step's tp' = sigmoid(ctx . wc + h_att . wq + x . wx
// + b) in float32: into the tp carry (in place: every CTA read it before
// the first barrier) and the tp stream.  Bound: the same bytes as the
// location-sensitive step's (1.7 us at B=50, T=128), less work.
//
// What costs the family is its chain of cluster exchanges (about 0.65 us
// a cluster barrier, PERF.md), so it runs three exchanges, with or
// without the agent (five and six cluster barriers before):
// 1. the softmax in one exchange (the online softmax): each tile sends
//    its maximum m_j and s_j = sum exp(e - m_j); every CTA combines the
//    pairs in rank order, M = max m_j, S = sum_j s_j exp(m_j - M), lane j
//    of warp 0 taking rank j's pair;
// 2. the renorm's tile sums, combined so;
// 3. the context partials, each CTA's share of the columns to the CTA
//    that owns it.  The agent has no exchange of its own: its operands
//    (wc, the CTA's shares of h_att, x and their weights) are copied in
//    the prologue with the other reads and the h_att and x shares summed
//    there; ctx . wc is linear in the tiles' partial contexts, so each
//    tile adds wc . its partial and sends the sum to rank 0 with its
//    context partials, and rank 0 sums the cl partials in rank order.
// Each exchange is a one-way message: a CTA stores its values
// into every receiver's slot with st.async, counted in bytes on the
// receiver's mbarrier, and waits on its own mbarrier alone; no CTA reads
// another's shared memory, so none waits for its peers at its exit.  The
// mbarriers are armed in the prologue, before a split cluster barrier
// whose wait precedes the first send: one cluster barrier in all.  The
// measured alternative (1.2 to 1.8 us slower a call, PERF.md;
// tools/torch_kernel_variants.py train_attention_fam_cluster_barriers)
// publishes each exchange in the CTA's own shared memory for a cluster
// barrier and reads of the peers' copies, and ends in a split exit
// (arrive after the CTA's last read of a peer, wait before it returns):
// three exchanges and the exit.
// ---------------------------------------------------------------------------
constexpr int TA_THREADS = 256, TA_WARPS = TA_THREADS / 32;
// the shared memory a CTA may opt in to on the H100
constexpr size_t SMEM_MAX = 227 * 1024;

// the transition agent's operands of train_attention (the forward family
// with the agent only)
struct TaAgent {
  float* tp;             // [B] the t_prob carry, in place
  float* tp_out;         // [B] the t_prob stream, or null
  const float* h_att;    // [B, H] float32
  const float* x;        // [B, P] float32 prenet output
  const float* w;        // [Mem + H + P] float32
  const float* bias;     // [1]
  int H, P;
};

// which of the tile's rows train_attention copies into shared memory
constexpr int TA_STAGE_MTB = 1, TA_STAGE_MEM = 2;

// the floats of the transition agent's operands that a CTA of a cluster of
// cl copies: wc [Mem], then its shares of h_att and wq [ceil(H / cl)] and
// of x and wx [ceil(P / cl)]
__host__ __device__ inline int ta_agent_floats(int Mem, int H, int P,
                                               int cl) {
  return Mem + 2 * ((H + cl - 1) / cl + (P + cl - 1) / cl);
}

// shared-memory layout of train_attention_kernel (byte offsets) for
// compute-type elements of `es` bytes and the copies `stage` names; `band`:
// the location-sensitive kind, whose float32 instance keeps lc in swizzled
// rows of A words (band_swz) and cum's TF32 lo halves beside its hi;
// `agent`: the transition agent's floats (ta_agent_floats), or 0
struct TaLayout {
  int ld, ldm;
  CtxScheme cs;   // the context's chunk scheme (csrc/tile.cuh)
  size_t lc, mtb, mem, q, v, ep, e, cumf, mask, cum, cum_lo, stat, red, ctxp,
      cpart, ag, msg, total;
  __host__ __device__ TaLayout(int tile, int A, int Mem, int es, int stage,
                               bool band, int agent = 0)
      : cs(Mem, TA_THREADS, 16 / es) {
    const bool tf32 = es == 4 && band;
    ld = tf32 ? A : A + 16 / es;   // rows of lc
    ldm = A + 16 / es;   // rows of the mtb tile: eight rows g in distinct banks
    lc = 0;
    mtb = lc + align16((size_t)BAND_K * ld * es);
    mem = mtb + (stage & TA_STAGE_MTB ? align16((size_t)tile * ldm * es) : 0);
    q = mem + (stage & TA_STAGE_MEM ? align16((size_t)tile * Mem * es) : 0);
    v = q + align16((size_t)A * 4);
    ep = v + align16((size_t)A * 4);
    // the warps' partial energies (not in the forward family's float32
    // instances, which sum a position in one warp)
    e = ep + (es == 2 || band ? align16((size_t)TA_WARPS * tile * 4) : 0);
    cumf = e + align16((size_t)tile * 4);
    mask = cumf + align16((size_t)tile * 4);
    cum = mask + align16((size_t)tile * 4);
    cum_lo = cum + align16((size_t)(tile + BAND_K) * es);
    stat = cum_lo + (tf32 ? align16((size_t)(tile + BAND_K) * 4) : 0);
    red = stat + 32;
    ctxp = red + 32 * 4;
    cpart = ctxp + align16((size_t)Mem * 4);
    ag = cpart + align16(cs.scratch_floats(Mem) * 4);
    msg = ag + align16((size_t)agent * 4);
    // the forward family's one-way messages: their mbarriers and slots
    total = msg + (band ? 0 : align16(32 + (40 + Mem) * 4));
  }
};

// the most of the tile's rows that fit: both copies, mtb's alone, or none
__host__ inline int ta_stage(int tile, int A, int Mem, int es, bool band,
                            int agent) {
  const int both = TA_STAGE_MTB | TA_STAGE_MEM;
  if (TaLayout(tile, A, Mem, es, both, band, agent).total <= SMEM_MAX)
    return both;
  if (TaLayout(tile, A, Mem, es, TA_STAGE_MTB, band, agent).total <=
      SMEM_MAX)
    return TA_STAGE_MTB;
  return 0;
}

// train_attention_kernel's parameters (CT: the compute type) and arguments
#define TA_PARAMS(CT)                                                      \
  const float *__restrict__ q, float *__restrict__ cum,                   \
      const CT *__restrict__ memory, const CT *__restrict__ mtb,          \
      const float *__restrict__ mask_add, const CT *__restrict__ lc,      \
      const float *__restrict__ v, float *__restrict__ w_out,             \
      CT *__restrict__ cum_out, float *__restrict__ ctx,                  \
      CT *__restrict__ dst0, int ld0, CT *__restrict__ dst1, int ld1,     \
      CT *__restrict__ dst2, int ld2, int T, int A, int Mem, int K,       \
      int tile, int cl, int vec, int stage, TaAgent ag
#define TA_ARGS                                                            \
  q, cum, memory, mtb, mask_add, lc, v, w_out, cum_out, ctx, dst0, ld0,    \
      dst1, ld1, dst2, ld2, T, A, Mem, K, tile, cl, vec, stage, ag

template <int KIND, class CT>
__device__ __forceinline__ void train_attention_body(TA_PARAMS(CT)) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  constexpr int V = 16 / sizeof(CT);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t ta_smem[];
  const int ag_floats =
      KIND == ATT_FWD_TRANS ? ta_agent_floats(Mem, ag.H, ag.P, cl) : 0;
  const TaLayout L(tile, A, Mem, sizeof(CT), stage, KIND == ATT_LS,
                   ag_floats);
  const int ld = L.ld, ldm = L.ldm;
  CT* s_lc = reinterpret_cast<CT*>(ta_smem + L.lc);            // [32][ld]
  CT* s_mtb = reinterpret_cast<CT*>(ta_smem + L.mtb);          // [tile][ldm]
  CT* s_mem = reinterpret_cast<CT*>(ta_smem + L.mem);          // [tile * Mem]
  float* s_q = reinterpret_cast<float*>(ta_smem + L.q);        // [A]
  float* s_v = reinterpret_cast<float*>(ta_smem + L.v);        // [A]
  float* s_ep = reinterpret_cast<float*>(ta_smem + L.ep);      // [WARPS][tile]
  float* s_e = reinterpret_cast<float*>(ta_smem + L.e);        // [tile]
  float* s_cumf = reinterpret_cast<float*>(ta_smem + L.cumf);  // [tile]
  float* s_mask = reinterpret_cast<float*>(ta_smem + L.mask);  // [tile]
  CT* s_cum = reinterpret_cast<CT*>(ta_smem + L.cum);          // [tile + 32]
  // float32: cum's TF32 lo halves beside s_cum's hi
  float* s_cum_lo = reinterpret_cast<float*>(ta_smem + L.cum_lo);
  // [0] max, [1] sum (location-sensitive: the tile's, published), [2] the
  // row's max, [3] the row's sum; the forward family: [5] the renorm's row
  // sum, [7] the halo prev[t_lo - 1]
  float* s_stat = reinterpret_cast<float*>(ta_smem + L.stat);  // [8]
  float* s_red = reinterpret_cast<float*>(ta_smem + L.red);    // [32]
  float* s_ctxp = reinterpret_cast<float*>(ta_smem + L.ctxp);  // [Mem]
  float* s_cpart = reinterpret_cast<float*>(ta_smem + L.cpart);
  // the agent's wc, then its h_att, wq, x and wx shares
  float* s_ag = reinterpret_cast<float*>(ta_smem + L.ag);
  // one-way messages: three mbarriers, then the slots of the tiles' pairs
  // [8][2], renorm sums [8], agent partials [8] and context partials [cl]
  // [share]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(ta_smem + L.msg);
  float* s_pair = reinterpret_cast<float*>(ta_smem + L.msg + 32);
  float* s_rsum = s_pair + 16;
  float* s_agin = s_rsum + 8;
  float* s_ctxin = s_agin + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x / cl, t_lo = rank * tile;
  const int rows = min(tile, T - t_lo);   // >= 1 (the launcher's check)
  const int half = (K - 1) / 2;
  const size_t rowT = (size_t)b * T;
  const bool mtb_staged = stage & TA_STAGE_MTB;
  const bool mem_staged = (stage & TA_STAGE_MEM) && vec;

  // every read of device memory is issued here, so that their latencies
  // overlap: lc and the tile's mtb rows (cp.async group 0), the tile's
  // memory rows (group 1, when 16-byte aligned), then q, v, cum and the mask
  if constexpr (KIND == ATT_LS && F32)
    band_copy_lc_tf32(s_lc, lc, K, A);
  else if constexpr (KIND == ATT_LS)
    band_copy_lc(s_lc, ld, lc, K, A);
  const int a_chunks = A / V;
  if (mtb_staged)
    for (int i = tid; i < tile * a_chunks; i += TA_THREADS) {
      const int r = i / a_chunks, c = (i - r * a_chunks) * V;
      cp_async16(s_mtb + r * ldm + c,
                 r < rows ? mtb + (rowT + t_lo + r) * A + c : mtb,
                 r < rows ? 16 : 0);
    }
  // the transition agent's operands: wc, and this CTA's shares of h_att
  // and x with their weights (the shares' products need nothing the step
  // computes)
  const int sh_h = (ag.H + cl - 1) / cl, sh_p = (ag.P + cl - 1) / cl;
  const int n_h = max(0, min(ag.H - rank * sh_h, sh_h));
  const int n_p = max(0, min(ag.P - rank * sh_p, sh_p));
  if constexpr (KIND == ATT_FWD_TRANS) {
    const float* h_sh = ag.h_att + (size_t)b * ag.H + rank * sh_h;
    const float* x_sh = ag.x + (size_t)b * ag.P + rank * sh_p;
    const float* wq_sh = ag.w + Mem + rank * sh_h;
    const float* wx_sh = ag.w + Mem + ag.H + rank * sh_p;
    for (int m = tid; m < Mem; m += TA_THREADS)
      cp_async4(s_ag + m, ag.w + m);
    for (int k = tid; k < n_h; k += TA_THREADS) {
      cp_async4(s_ag + Mem + k, h_sh + k);
      cp_async4(s_ag + Mem + sh_h + k, wq_sh + k);
    }
    for (int k = tid; k < n_p; k += TA_THREADS) {
      cp_async4(s_ag + Mem + 2 * sh_h + k, x_sh + k);
      cp_async4(s_ag + Mem + 2 * sh_h + sh_p + k, wx_sh + k);
    }
  }
  cp_async_commit();
  const CT* mem_tile = memory + (rowT + t_lo) * Mem;
  if (mem_staged) {
    const int bytes = rows * Mem * (int)sizeof(CT);
    for (int o = tid * 16; o < bytes; o += TA_THREADS * 16)
      cp_async16(reinterpret_cast<uint8_t*>(s_mem) + o,
                 reinterpret_cast<const uint8_t*>(mem_tile) + o,
                 min(16, bytes - o));
  }
  cp_async_commit();
  for (int a = tid; a < A; a += TA_THREADS) {
    s_q[a] = q[(size_t)b * A + a];
    s_v[a] = v[a];
  }
  for (int i = tid; i < rows; i += TA_THREADS) {
    s_cumf[i] = cum[rowT + t_lo + i];
    s_mask[i] = mask_add[rowT + t_lo + i];
  }
  if constexpr (KIND == ATT_LS && F32) {
    band_stage_cum_tf32(s_cum, s_cum_lo, tile + BAND_K, cum + rowT, t_lo,
                        half, T);
  } else if constexpr (KIND == ATT_LS) {
    band_stage_cum(s_cum, tile + BAND_K, cum + rowT, t_lo, half, T);
  } else if (tid == 0) {
    s_stat[7] = t_lo > 0 ? cum[rowT + t_lo - 1] : 0.0f;
  }
  const float tp_prev = KIND == ATT_FWD_TRANS ? ag.tp[b] : 0.0f;
  // this CTA's share of the context's columns
  const int share = (Mem + cl - 1) / cl, m_lo = rank * share;
  const int m_hi = min(Mem, m_lo + share);
  if constexpr (KIND != ATT_LS) {
    // each mbarrier armed with the bytes its messages bring: a pair and a
    // sum from each CTA, each CTA's partials of this share's columns (and,
    // at rank 0, the agent's partials); the split cluster barrier's wait
    // precedes the first send
    if (tid == 0) {
      mbar_init_expect(s_bar, cl * 8);
      mbar_init_expect(s_bar + 1, cl * 4);
      mbar_init_expect(s_bar + 2,
                       4 * cl * max(0, m_hi - m_lo) +
                           (KIND == ATT_FWD_TRANS && rank == 0 ? 4 * cl : 0));
      mbar_init_fence();
    }
    cluster_arrive();
  }
  cp_async_wait<1>();
  __syncthreads();
  // the agent's h_att and x shares of its pre-sigmoid sum
  float lin = 0.0f;
  if constexpr (KIND == ATT_FWD_TRANS) {
    for (int k = tid; k < n_h; k += TA_THREADS)
      lin = fmaf(s_ag[Mem + k], s_ag[Mem + sh_h + k], lin);
    for (int k = tid; k < n_p; k += TA_THREADS)
      lin = fmaf(s_ag[Mem + 2 * sh_h + k], s_ag[Mem + 2 * sh_h + sh_p + k],
                 lin);
  }

  // the tile's mtb rows, from the copy or from device memory
  const CT* mt_rows = mtb_staged ? s_mtb : mtb + (rowT + t_lo) * A;
  const int ldmt = mtb_staged ? ldm : A;
  if constexpr (F32 && KIND != ATT_LS) {
    // 1. energies: a warp a position, a lane every 32nd channel; the
    // forward family's softmax is unmasked
    for (int i = warp; i < rows; i += TA_WARPS) {
      float e = 0.0f;
      for (int a = lane; a < A; a += 32)
        e = fmaf(s_v[a], tanhf(s_q[a] + mt_rows[(size_t)i * ldmt + a]), e);
      e = warp_sum(e);
      if (lane == 0) s_e[i] = e;
    }
    __syncthreads();
  } else if constexpr (F32) {
    // 1. energies: the band product band(cum) @ lc in three TF32 passes,
    // a warp per 16 channels (two n8 groups) down the tile's 16-row mma
    // tiles, as in bf16; lc's fragments split in registers where they are
    // read (at T <= 128 a CTA has one mma tile: each lc value is read and
    // split by one warp once); each warp's partial of e
    for (int mt = 0; mt < tile / 16; ++mt) {
      const int ra = mt * 16 + g, rb = ra + 8;   // rows past T read zeros
      const bool in_a = mtb_staged || ra < rows;
      const bool in_b = mtb_staged || rb < rows;
      float e0 = 0.0f, e1 = 0.0f;
      for (int n0 = warp * 16; n0 < A; n0 += TA_WARPS * 16) {
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ah[4], al[4];
          band_frag_tf32(ah, s_cum + mt * 16 + 8 * ks, lane);
          band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t bh[2], bl[2];
            band_frag_kn(bh, s_lc, A, 8 * ks, n0 + 8 * h, lane);
            tf32_split<2>(bh, bl, bh);
            mma_tf32x3(acc[h], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = n0 + 8 * h + 2 * qd;
          const float2 zero2 = make_float2(0.0f, 0.0f);
          const float2 m0 =
              in_a ? *reinterpret_cast<const float2*>(
                         mt_rows + (size_t)ra * ldmt + a)
                   : zero2;
          const float2 m1 =
              in_b ? *reinterpret_cast<const float2*>(
                         mt_rows + (size_t)rb * ldmt + a)
                   : zero2;
          const float q0 = s_q[a], q1 = s_q[a + 1];
          const float v0 = s_v[a], v1 = s_v[a + 1];
          e0 = fmaf(v0, band_energy_tanh<float>(acc[h][0], q0, m0.x), e0);
          e0 = fmaf(v1, band_energy_tanh<float>(acc[h][1], q1, m0.y), e0);
          e1 = fmaf(v0, band_energy_tanh<float>(acc[h][2], q0, m1.x), e1);
          e1 = fmaf(v1, band_energy_tanh<float>(acc[h][3], q1, m1.y), e1);
        }
      }
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      if (qd == 0) {
        s_ep[warp * tile + mt * 16 + g] = e0;
        s_ep[warp * tile + mt * 16 + g + 8] = e1;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows; i += TA_THREADS) {
      float e = 0.0f;
      for (int w = 0; w < TA_WARPS; ++w) e += s_ep[w * tile + i];
      s_e[i] = e + s_mask[i];
    }
    __syncthreads();
  } else {
    // 1. energies: loc = band(cum) @ lc, a warp per 16 channels (two n8
    // groups) down the tile's 16-row mma tiles; each warp's partial of e
    for (int mt = 0; mt < tile / 16; ++mt) {
      uint32_t af[2][4];
      if (KIND == ATT_LS) band_frags(af, s_cum + mt * 16, lane);
      const int ra = mt * 16 + g, rb = ra + 8;   // rows past T read zeros
      const bool in_a = mtb_staged || ra < rows, in_b = mtb_staged || rb < rows;
      float e0 = 0.0f, e1 = 0.0f;
      for (int n0 = warp * 16; n0 < A; n0 += TA_WARPS * 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = n0 + 8 * h, a = c0 + 2 * qd;
          const float2 zero2 = make_float2(0.0f, 0.0f);
          const float2 m0 =
              in_a ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                         mt_rows + (size_t)ra * ldmt + a))
                   : zero2;
          const float2 m1 =
              in_b ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                         mt_rows + (size_t)rb * ldmt + a))
                   : zero2;
          const float q0 = s_q[a], q1 = s_q[a + 1];
          const float v0 = s_v[a], v1 = s_v[a + 1];
          if (KIND == ATT_LS) {
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            band_loc(acc, af, s_lc, ld, c0, lane);
            e0 = fmaf(v0, band_energy_tanh(acc[0], q0, m0.x), e0);
            e0 = fmaf(v1, band_energy_tanh(acc[1], q1, m0.y), e0);
            e1 = fmaf(v0, band_energy_tanh(acc[2], q0, m1.x), e1);
            e1 = fmaf(v1, band_energy_tanh(acc[3], q1, m1.y), e1);
          } else {
            e0 = fmaf(v0, fwd_energy_tanh(q0, m0.x), e0);
            e0 = fmaf(v1, fwd_energy_tanh(q1, m0.y), e0);
            e1 = fmaf(v0, fwd_energy_tanh(q0, m1.x), e1);
            e1 = fmaf(v1, fwd_energy_tanh(q1, m1.y), e1);
          }
        }
      }
      e0 += __shfl_xor_sync(0xffffffffu, e0, 1);
      e0 += __shfl_xor_sync(0xffffffffu, e0, 2);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 1);
      e1 += __shfl_xor_sync(0xffffffffu, e1, 2);
      if (qd == 0) {
        s_ep[warp * tile + mt * 16 + g] = e0;
        s_ep[warp * tile + mt * 16 + g + 8] = e1;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows; i += TA_THREADS) {
      float e = 0.0f;
      for (int w = 0; w < TA_WARPS; ++w) e += s_ep[w * tile + i];
      // the forward family's softmax is unmasked
      s_e[i] = KIND == ATT_LS ? e + s_mask[i] : e;
    }
    __syncthreads();
  }

  if constexpr (KIND == ATT_LS) {
    // 2. the row's masked softmax: tile maxima, then tile sums, each
    // combined in rank order by every CTA
    float mx = -CUDART_INF_F;
    for (int i = tid; i < rows; i += TA_THREADS) mx = fmaxf(mx, s_e[i]);
    mx = block_reduce<true>(mx, s_red);
    if (tid == 0) s_stat[0] = mx;
    cluster_sync();
    if (tid == 0) {
      float m = -CUDART_INF_F;
      for (int j = 0; j < cl; ++j) m = fmaxf(m, cluster_peer(s_stat, j)[0]);
      s_stat[2] = m;
    }
    __syncthreads();
    mx = s_stat[2];
    float sum = 0.0f;
    for (int i = tid; i < rows; i += TA_THREADS) {
      const float p = expf(s_e[i] - mx);
      s_e[i] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, s_red);
    if (tid == 0) s_stat[1] = sum;
    cluster_sync();
    if (tid == 0) {
      float s = 0.0f;
      for (int j = 0; j < cl; ++j) s += cluster_peer(s_stat, j)[1];
      s_stat[3] = s;
    }
    __syncthreads();
    sum = s_stat[3];
    for (int i = tid; i < rows; i += TA_THREADS) {
      const size_t o = rowT + t_lo + i;
      const float wt = s_e[i] / sum;
      w_out[o] = wt;
      const float c_old = s_cumf[i];
      if (cum_out != nullptr) cum_out[o] = from_float<CT>(c_old);
      cum[o] = c_old + wt;
      s_e[i] = round_to<CT>(wt);
    }
    __syncthreads();

    // 3. the context: this tile's partial (from the copy of its memory rows
    // when there is one), then a share of the columns over the cluster's
    // partials in rank order
    cp_async_wait<0>();
    __syncthreads();
    ctx_partials<!F32>(L.cs, s_cpart, mem_staged ? s_mem : mem_tile, s_e,
                       rows, Mem, vec, TA_THREADS);
    __syncthreads();
    for (int m = tid; m < Mem; m += TA_THREADS)
      s_ctxp[m] = ctx_column(L.cs, s_cpart, Mem, m);
    cluster_sync();
    for (int m = m_lo + tid; m < m_hi; m += TA_THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < cl; ++j) acc += cluster_peer(s_ctxp, j)[m];
      ctx[(size_t)b * Mem + m] = acc;
      const CT cb = from_float<CT>(acc);
      dst0[(size_t)b * ld0 + m] = cb;
      dst1[(size_t)b * ld1 + m] = cb;
      if (dst2 != nullptr) dst2[(size_t)b * ld2 + m] = cb;
    }
    // no CTA leaves while its peers may still read its shared memory
    cluster_sync();
  } else {
    // 2. the row's softmax (unmasked) in one exchange: each tile's maximum
    // m_j and s_j = sum exp(e - m_j) over the tile, combined in rank order
    // by every CTA: M = max m_j, S = sum_j s_j exp(m_j - M)
    float mx = -CUDART_INF_F;
    for (int i = tid; i < rows; i += TA_THREADS) mx = fmaxf(mx, s_e[i]);
    mx = block_reduce<true>(mx, s_red);
    float sum = 0.0f;
    for (int i = tid; i < rows; i += TA_THREADS) sum += expf(s_e[i] - mx);
    sum = block_reduce<false>(sum, s_red);
    cluster_wait();   // every peer's mbarriers are armed
    if (warp == 0 && lane < cl)
      st_async(dsmem_addr(s_pair + 2 * rank, lane), mx, sum,
               dsmem_addr(s_bar, lane));
    if (warp == 0) {
      // lane j takes rank j's pair, every lane combines them in rank order
      mbar_wait0(s_bar);
      const float mj = lane < cl ? s_pair[2 * lane] : -CUDART_INF_F;
      const float sj = lane < cl ? s_pair[2 * lane + 1] : 0.0f;
      float m = -CUDART_INF_F, s = 0.0f;
      for (int j = 0; j < cl; ++j)
        m = fmaxf(m, __shfl_sync(0xffffffffu, mj, j));
      for (int j = 0; j < cl; ++j)
        s += __shfl_sync(0xffffffffu, sj, j) *
             expf(__shfl_sync(0xffffffffu, mj, j) - m);
      if (lane == 0) {
        s_stat[2] = m;
        s_stat[3] = s;
      }
    }
    __syncthreads();
    mx = s_stat[2];
    sum = s_stat[3];
    // the recurrence, the mask and the floor; then the row's sum (the
    // second exchange)
    float wsum = 0.0f;
    for (int i = tid; i < rows; i += TA_THREADS) {
      const float energy = expf(s_e[i] - mx) / sum;
      const float prev = s_cumf[i];
      const float sh = round_to<CT>(i > 0 ? s_cumf[i - 1] : s_stat[7]);
      const float comb = KIND == ATT_FWD_TRANS
                             ? (1.0f - tp_prev) * prev + tp_prev * sh
                             : prev + sh;
      const float wt = fmaxf(s_mask[i] > -0.5f ? comb * energy : 0.0f, 1e-6f);
      s_e[i] = wt;
      wsum += wt;
    }
    wsum = block_reduce<false>(wsum, s_red);
    if (warp == 0 && lane < cl)
      st_async(dsmem_addr(s_rsum + rank, lane), wsum,
               dsmem_addr(s_bar + 1, lane));
    if (warp == 0) {
      mbar_wait0(s_bar + 1);
      const float x = lane < cl ? s_rsum[lane] : 0.0f;
      float s = 0.0f;
      for (int j = 0; j < cl; ++j) s += __shfl_sync(0xffffffffu, x, j);
      if (lane == 0) s_stat[5] = s;
    }
    __syncthreads();
    sum = s_stat[5];
    for (int i = tid; i < rows; i += TA_THREADS) {
      const size_t o = rowT + t_lo + i;
      const float wt = s_e[i] / sum;
      w_out[o] = wt;
      if (cum_out != nullptr) cum_out[o] = from_float<CT>(s_cumf[i]);
      cum[o] = wt;
      s_e[i] = round_to<CT>(wt);
    }
    __syncthreads();

    // 3. the context: this tile's partial, and with the transition agent
    // its term ctx . wc taken on the partial (linear in it) beside the
    // prologue's h_att and x shares; the third exchange sends each CTA's
    // share of the columns to it, and the agent's partials to rank 0
    cp_async_wait<0>();
    __syncthreads();
    ctx_partials<!F32>(L.cs, s_cpart, mem_staged ? s_mem : mem_tile, s_e,
                       rows, Mem, vec, TA_THREADS);
    __syncthreads();
    for (int m = tid; m < Mem; m += TA_THREADS) {
      const float c = ctx_column(L.cs, s_cpart, Mem, m);
      const int r = m / share;
      st_async(dsmem_addr(s_ctxin + rank * share + m - r * share, r), c,
               dsmem_addr(s_bar + 2, r));
      if (KIND == ATT_FWD_TRANS) lin = fmaf(s_ag[m], c, lin);
    }
    if (KIND == ATT_FWD_TRANS) {
      lin = block_reduce<false>(lin, s_red);
      if (tid == 0)
        st_async(dsmem_addr(s_agin + rank, 0), lin, dsmem_addr(s_bar + 2, 0));
    }
    // this share's partials (and, at rank 0, the agent's) have landed; no
    // CTA reads another's shared memory, so none waits for its peers to
    // leave
    mbar_wait0(s_bar + 2);
    for (int m = m_lo + tid; m < m_hi; m += TA_THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < cl; ++j) acc += s_ctxin[j * share + m - m_lo];
      ctx[(size_t)b * Mem + m] = acc;
      const CT cb = from_float<CT>(acc);
      dst0[(size_t)b * ld0 + m] = cb;
      dst1[(size_t)b * ld1 + m] = cb;
      if (dst2 != nullptr) dst2[(size_t)b * ld2 + m] = cb;
    }
    if (KIND == ATT_FWD_TRANS && rank == 0 && tid == 0) {
      float z = ag.bias[0];
      for (int j = 0; j < cl; ++j) z += s_agin[j];
      const float tp = 1.0f / (1.0f + expf(-z));
      ag.tp[b] = tp;
      if (ag.tp_out != nullptr) ag.tp_out[b] = tp;
    }
  }
}

template <int KIND, class CT>
__global__ void __launch_bounds__(TA_THREADS)
    train_attention_kernel(TA_PARAMS(CT)) {
  train_attention_body<KIND, CT>(TA_ARGS);
}

// the float32 band instance held to 64 registers, four CTAs an SM (80 and
// three without the bound: 396 slots for the 400 CTAs of B=50, T=128)
template <>
__global__ void __launch_bounds__(TA_THREADS, 4)
    train_attention_kernel<ATT_LS, float>(TA_PARAMS(float)) {
  train_attention_body<ATT_LS, float>(TA_ARGS);
}

// four consecutive elements of the compute type as float (16 or 8 bytes),
// and stored from float (rounded to CT)
__device__ __forceinline__ float4 load4ct(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4ct(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
__device__ __forceinline__ void store4ct(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4ct(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float elem4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// The LSTM cell's backward with its regularization for one (row, unit)
// (ops/pallas_train_decoder.py:668-713), over the stored i|f|g|o
// activations act [B, 4H] and the previous cell state c_prev (both in the
// compute type CT; c_prev null at the first step), given dht, the total
// cotangent of the cell's h output.  dc is the cell cotangent carry,
// updated in place; dh_reg gets the regularization's pass-through to the
// previous h; dg the gate gradients [B, 4H] (CT).  It runs in the epilogue
// of the kernel that computes dht's last term: bwd_head for the
// generator's cell, the dq @ Wq^T product (splitk_kernel or its reduction,
// CellOut) for the attention cell; bwd_cell_kernel runs it alone.  Each
// (row, unit) is one thread's: the in-place dc update reads and writes only
// its own element.  Where a thread takes four consecutive units (apply4:
// bwd_head's epilogue, H a multiple of 4), their four cells are
// independent work in flight at once and the outputs leave in 16-byte
// stores: the epilogue runs at low occupancy (84 blocks of 4 warps at
// B=50).
// ---------------------------------------------------------------------------
template <class CT>
struct CellBwd {
  const CT* act;
  const CT* c_prev;
  float* dc;
  CT* dg;
  float* dh_reg;
  int H;
  Reg reg;
  // reads its operands from global memory
  __device__ void operator()(int row, int unit, float dht) const {
    const size_t o = (size_t)row * H + unit;
    const CT* a = act + (size_t)row * 4 * H + unit;
    apply(row, unit, dht, to_float(a[0]), to_float(a[H]), to_float(a[2 * H]),
          to_float(a[3 * H]), c_prev != nullptr ? to_float(c_prev[o]) : 0.0f,
          dc[o]);
  }
  // the outputs of one (row, unit): dc, dh_reg and the four gate
  // gradients (before their rounding to CT)
  struct Out {
    float dc, dh_reg, d[4];
  };
  // on operands already read: the gates i, f, g, o, the previous c and dc
  __device__ void apply(int row, int unit, float dht, float i, float f,
                        float gg, float og, float cp, float dct) const {
    const Out r = compute(row, unit, dht, i, f, gg, og, cp, dct);
    const size_t o = (size_t)row * H + unit;
    dc[o] = r.dc;
    dh_reg[o] = r.dh_reg;
    CT* d = dg + (size_t)row * 4 * H + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q * H] = from_float<CT>(r.d[q]);
  }
  // four consecutive units [unit, unit + 4) of a row at once (four
  // independent cells in flight a thread), on operands already read: dht,
  // the gates g[q] (i, f, g, o), the previous c and dc of each; unit a
  // multiple of 4 and the rows 16-byte aligned (H a multiple of 4): dc and
  // dh_reg stored as float4, each gate gradient as four CT
  __device__ __forceinline__ void apply4(int row, int unit, const float4& dht,
                                         const float4 (&g)[4],
                                         const float4& cp,
                                         const float4& dct) const {
    Out r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = compute(row, unit + j, elem4(dht, j), elem4(g[0], j),
                     elem4(g[1], j), elem4(g[2], j), elem4(g[3], j),
                     elem4(cp, j), elem4(dct, j));
    const size_t o = (size_t)row * H + unit;
    store4ct(dc + o, make_float4(r[0].dc, r[1].dc, r[2].dc, r[3].dc));
    store4ct(dh_reg + o, make_float4(r[0].dh_reg, r[1].dh_reg,
                                     r[2].dh_reg, r[3].dh_reg));
    CT* d = dg + (size_t)row * 4 * H + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      store4ct(d + (size_t)q * H,
               make_float4(r[0].d[q], r[1].d[q], r[2].d[q], r[3].d[q]));
  }
  __device__ __forceinline__ Out compute(int row, int unit, float dht,
                                         float i, float f, float gg,
                                         float og, float cp,
                                         float dct) const {
    const float tanh_c = tanhf(f * cp + i * gg);
    float dh_new = dht, dh_prev = 0.0f, dc_state = dct, dc_prev = 0.0f;
    if (reg.mode == 1) {
      const bool zh = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                reg.salt_h) < reg.th_h;
      const bool zc = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                reg.salt_c) < reg.th_c;
      dh_new = zh ? dht : 0.0f;
      dh_prev = zh ? 0.0f : dht;
      dc_state = zc ? dct : 0.0f;
      dc_prev = zc ? 0.0f : dct;
    } else if (reg.mode == 2) {
      const bool keep = rand_bits(row, unit, H, reg.seed0, reg.seed1,
                                  reg.salt_h) < reg.th_h;
      dh_new = keep ? dht * reg.scale : 0.0f;
    }
    const float dc_new = dc_state + dh_new * og * (1.0f - tanh_c * tanh_c);
    return Out{dc_prev + dc_new * f,
               dh_prev,
               {dc_new * gg * i * (1.0f - i), dc_new * cp * f * (1.0f - f),
                dc_new * i * (1.0f - gg * gg),
                dh_new * tanh_c * og * (1.0f - og)}};
  }
};

// the dq @ Wq^T product's epilogue (N = H): dh_tot = add + v, the final sum
// (splitk_kernel's own when K is whole, splitk_reduce_kernel's when it is
// split, never a slice's partial), then the attention cell's backward.
// The reduction reads the cell's operands (prefetch) before the partials,
// so that both round trips overlap (at the flagship's B=50 the product's K
// is always split: splitk_slices)
template <class CT>
struct CellOut {
  const float* add;
  int ldadd;
  CellBwd<CT> cell;
  struct Ops {
    float add, i, f, g, o, cp, dc;
  };
  __device__ __forceinline__ void put(int row, int col, float v) const {
    put(row, col, v, prefetch(row, col));
  }
  __device__ __forceinline__ Ops prefetch(int row, int col) const {
    const size_t o = (size_t)row * cell.H + col;
    const CT* a = cell.act + (size_t)row * 4 * cell.H + col;
    return Ops{add[(size_t)row * ldadd + col], to_float(a[0]),
               to_float(a[cell.H]), to_float(a[2 * cell.H]),
               to_float(a[3 * cell.H]),
               cell.c_prev != nullptr ? to_float(cell.c_prev[o]) : 0.0f,
               cell.dc[o]};
  }
  __device__ __forceinline__ void put(int row, int col, float v,
                                      const Ops& x) const {
    cell.apply(row, col, x.add + v, x.i, x.f, x.g, x.o, x.cp, x.dc);
  }
};

// ---------------------------------------------------------------------------
// bwd_head: the head backward (ops/pallas_train_decoder.py:731-743)
//   dframe_tot = dspec + dframe  -> the da_frame stream (compute type)
//   dproto = round(dframe_tot) @ W[:M] + dstop W[M]
//   dh_gen_tot = dh_gen + dproto[:, :H];  dctx_tot = dctx + dproto[:, H:]
// With a cell (cell.act not null), the generator cell's backward (CellBwd)
// runs on each dh_gen_tot value in the epilogue, and dh_gen_tot is not
// stored: a block of columns < H copies the cell's operands of its tile
// (the four gate slices, c_prev, dc) into shared memory with cp.async
// beside its weight tile, so that their latency overlaps, parks its
// dh_gen_tot tile in shared memory after the product, and then runs the
// cells a thread four consecutive units (CellBwd::apply4), consecutive
// threads on consecutive groups.  W is
// the head weight [M + 1, ldw] (one row per output, inputs
// contiguous), so W[:M] is the product's B as it lies ("KN", n contiguous).
//
// Bound on the H100: 2*B*(M+1)*(H+Mem) operations (10.7 M at B=50) and
// 0.8 MB in and out, 0.23 us; what costs is latency and launches, so the
// product is one launch.  Block: the BH_BM rows of a
// row tile (grid y over the row tiles) by BH_BN columns of H + Mem (21 x 4
// = 84 blocks at the flagship's 1316 and B=50: short row tiles spread the
// fused cell's work, which is most of the block's, over the SMs).  Each block copies its
// [M, BH_BN] weight tile as it lies with cp.async (rows past M zero),
// reads the carries its outputs add to, and builds its A tile
// round(dspec + dframe) [BH_BM, M] in shared memory from the float32 inputs
// with every 16-byte load in flight at once (the blocks of column 0 also
// write da_frame), so that the three latencies overlap.  Four warps of 16
// rows x 16 columns run the product on the tensor cores over K = M
// (zero-padded to a multiple of 16): in bf16 mma.sync m16n8k16 with
// float32 sums, the fragments from ldmatrix (.trans for W); in float32
// (the TPU kernel's float32 matmul takes full precision,
// ops/pallas_train_decoder.py:735-740) mma.sync m16n8k8 TF32 in three
// passes (mma_tf32x3), summed straight into the float32 sums over K's 10
// steps, the A fragments from ldmatrix and W's "KN" fragments word by word
// (frag_kmn: rows of BH_BN + 8 words, 8 mod 32, so the lanes read distinct
// banks).  The stop term stays in float32, as in the JAX
// kernel, and the epilogue adds it in the plain version's order, each
// operation rounded once: base + (acc + dstop * W[M]).
// ---------------------------------------------------------------------------
constexpr int BH_BM = 16, BH_BN = 64, BH_THREADS = 128;
// warps along the columns (16 each), and 16-row mma tiles a warp
constexpr int BH_WN = BH_BN / 16;
constexpr int BH_MT = BH_BM / 16 / (BH_THREADS / 32 / BH_WN);
// float4 slots of the A tile a thread loads at once: the whole tile while
// K_pad <= 128, so that every load is in flight before the first store
constexpr int BH_SLOTS = 8;

// elements a row of the A tile, for elements of `es` bytes (rows padded
// by 16 bytes), and of the weight tile (by 8 elements: 8 words mod 32 in
// float32)
__host__ __device__ inline int bh_lda(int kp, int es) { return kp + 16 / es; }
constexpr int BH_LDN = BH_BN + 8;

__host__ __device__ inline size_t bwd_head_smem(int kp, int es) {
  return (size_t)BH_BM * bh_lda(kp, es) * es + (size_t)kp * BH_LDN * es +
         (BH_BN + BH_BM) * sizeof(float);
}
// the fused cell's tile after bwd_head_smem: its gates [BH_BM][4][BH_BN]
// and c_prev [BH_BM][BH_BN] in the compute type, dc and dh_gen_tot
// [BH_BM][BH_BN] in float32
__host__ __device__ inline size_t bh_cell_smem(int es) {
  return (size_t)BH_BM * BH_BN * (5 * es + 2 * sizeof(float));
}

// four consecutive floats of a row at p, zero past `n` of them; `vec`: p is
// 16-byte aligned and n >= 4
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int n,
                                        bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

template <class CT>
__global__ void __launch_bounds__(BH_THREADS)
bwd_head_kernel(const float* __restrict__ dspec,
                const float* __restrict__ dstop,
                const float* __restrict__ dframe, const CT* __restrict__ w,
                int ldw, int wvec, int dvec, CT* __restrict__ da_frame,
                const float* __restrict__ dh_gen,
                const float* __restrict__ dctx, float* __restrict__ dh_gen_tot,
                float* __restrict__ dctx_tot, int B, int M, int kp, int H,
                int Mem, CellBwd<CT> cell, int cvec) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  constexpr int V = 16 / sizeof(CT);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t bh_smem[];
  const int lda = bh_lda(kp, sizeof(CT));       // a row of the A tile
  const int ldn = BH_LDN;                       // a row of the weight tile
  CT* as = reinterpret_cast<CT*>(bh_smem);      // [BH_BM][lda]
  CT* bs = as + BH_BM * lda;                    // [kp][ldn]
  float* s_wm = reinterpret_cast<float*>(bs + kp * ldn);  // W[M] tile
  float* s_ds = s_wm + BH_BN;                   // dstop of the rows
  // the fused cell's operands and dh_gen_tot tile
  CT* s_act = reinterpret_cast<CT*>(bh_smem + bwd_head_smem(kp, sizeof(CT)));
  CT* s_cp = s_act + BH_BM * 4 * BH_BN;
  float* s_dc = reinterpret_cast<float*>(s_cp + BH_BM * BH_BN);
  float* s_dht = s_dc + BH_BM * BH_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * BH_BM, col0 = blockIdx.x * BH_BN;
  const int N = H + Mem;
  const int wm = (warp / BH_WN) * 16 * BH_MT, wn = (warp % BH_WN) * 16;
  const bool fused = cell.act != nullptr && col0 < H;

  for (int p = tid; p < kp * (BH_BN / V); p += BH_THREADS) {
    const int k = p / (BH_BN / V), c = (p % (BH_BN / V)) * V;
    load16(bs + k * ldn + c, w, ldw, k, col0 + c, M, N, wvec);
  }
  if (fused) {
    const int rows = min(BH_BM, B - row0);
    for (int p = tid; p < rows * (BH_BN / V); p += BH_THREADS) {
      const int r = p / (BH_BN / V), c = (p % (BH_BN / V)) * V;
      const int row = row0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        load16(s_act + (r * 4 + q) * BH_BN + c, cell.act + (size_t)q * H,
               4 * H, row, col0 + c, B, H, cvec);
      if (cell.c_prev != nullptr)
        load16(s_cp + r * BH_BN + c, cell.c_prev, H, row, col0 + c, B, H,
               cvec);
    }
    for (int p = tid; p < rows * (BH_BN / 4); p += BH_THREADS) {
      const int r = p / (BH_BN / 4), c = (p % (BH_BN / 4)) * 4;
      load4f(s_dc + r * BH_BN + c, cell.dc + (size_t)(row0 + r) * H,
             col0 + c, H, cvec);
    }
  }
  cp_async_commit();

  // the carry an output (row0 + r, col0 + c) adds to
  auto carry_at = [&](int r, int c) -> float {
    const int row = row0 + r, col = col0 + c;
    return row >= B || col >= N ? 0.0f
           : col < H            ? dh_gen[(size_t)row * H + col]
                                : dctx[(size_t)row * Mem + col - H];
  };
  // the carries of this thread's outputs, read now so that their latency
  // overlaps the A tile's
  float base[BH_MT][2][4];
#pragma unroll
  for (int mt = 0; mt < BH_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        base[mt][nt][e] = carry_at(wm + mt * 16 + (lane >> 2) + (e >> 1) * 8,
                                   wn + nt * 8 + 2 * (lane & 3) + (e & 1));

  // the A tile round(dspec + dframe), four columns a slot; the blocks of
  // column 0 also write da_frame
  const int row_slots = kp / 4, slots = BH_BM * row_slots;
  for (int p0 = 0; p0 < slots; p0 += BH_SLOTS * BH_THREADS) {
    float4 x[BH_SLOTS], y[BH_SLOTS];
#pragma unroll
    for (int j = 0; j < BH_SLOTS; ++j) {
      const int p = p0 + tid + j * BH_THREADS;
      const int r = p / row_slots, k = (p % row_slots) * 4, row = row0 + r;
      x[j] = y[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < slots && row < B && k < M) {
        const size_t o = (size_t)row * M + k;
        x[j] = load4(dspec + o, M - k, dvec);
        y[j] = load4(dframe + o, M - k, dvec);
      }
    }
#pragma unroll
    for (int j = 0; j < BH_SLOTS; ++j) {
      const int p = p0 + tid + j * BH_THREADS;
      if (p >= slots) continue;
      const int r = p / row_slots, k = (p % row_slots) * 4, row = row0 + r;
      const float4 s4 = make_float4(x[j].x + y[j].x, x[j].y + y[j].y,
                                    x[j].z + y[j].z, x[j].w + y[j].w);
      CT v[4];
      if constexpr (F32) {
        *reinterpret_cast<float4*>(as + r * lda + k) = s4;
        v[0] = s4.x, v[1] = s4.y, v[2] = s4.z, v[3] = s4.w;
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(s4.x, s4.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s4.z, s4.w);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(as + r * lda + k) = packed;
        v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
      }
      if (blockIdx.x == 0 && row < B) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < M) da_frame[(size_t)row * M + k + q] = v[q];
      }
    }
  }
  for (int c = tid; c < BH_BN; c += BH_THREADS)
    s_wm[c] = col0 + c < N ? to_float(w[(size_t)M * ldw + col0 + c]) : 0.0f;
  for (int r = tid; r < BH_BM; r += BH_THREADS)
    s_ds[r] = row0 + r < B ? dstop[row0 + r] : 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // output (r, c) of the tile from its product sum and carry
  auto finish = [&](int r, int c, float acc, float carry) {
    const int row = row0 + r, col = col0 + c;
    if (row >= B || col >= N) return;
    const float dp = __fadd_rn(acc, __fmul_rn(s_ds[r], s_wm[c]));
    const float v = carry + dp;
    if (col >= H)
      dctx_tot[(size_t)row * Mem + col - H] = v;
    else if (fused)
      s_dht[r * BH_BN + c] = v;
    else
      dh_gen_tot[(size_t)row * H + col] = v;
  };
  float acc[BH_MT][2][4];
#pragma unroll
  for (int i = 0; i < BH_MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  if constexpr (F32) {
    for (int kk = 0; kk < kp; kk += 8) {
      uint32_t ah[BH_MT][4], al[BH_MT][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int mt = 0; mt < BH_MT; ++mt) {
        ldsm_x4(ah[mt], as + (wm + mt * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * lda +
                            kk + (lane >> 4) * 4);
        tf32_split<4>(ah[mt], al[mt], ah[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        frag_kmn(bh[nt], bs, kk, wn + nt * 8, lane, ldn);
        tf32_split<2>(bh[nt], bl[nt], bh[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < BH_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_tf32x3(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
    }
  } else {
    for (int kk = 0; kk < kp; kk += 16) {
      uint32_t af[BH_MT][4], bfr[2][2], r[4];
#pragma unroll
      for (int mt = 0; mt < BH_MT; ++mt)
        ldsm_x4(af[mt], as + (wm + mt * 16 + (lane & 7) +
                              ((lane >> 3) & 1) * 8) * lda +
                            kk + (lane >> 4) * 8);
      ldsm_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldn +
                            wn + (lane >> 4) * 8);
      bfr[0][0] = r[0];
      bfr[0][1] = r[1];
      bfr[1][0] = r[2];
      bfr[1][1] = r[3];
#pragma unroll
      for (int mt = 0; mt < BH_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < BH_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        finish(wm + mt * 16 + (lane >> 2) + (e >> 1) * 8,
               wn + nt * 8 + 2 * (lane & 3) + (e & 1), acc[mt][nt][e],
               base[mt][nt][e]);
  if (!fused) return;
  __syncthreads();
  // the cells four consecutive units a thread (CellBwd::apply4: four
  // independent cells in flight, 16-byte stores) where H and the outputs'
  // rows allow, else one unit at a time
  const bool v4 = H % 4 == 0 &&
                  ((uintptr_t)cell.dc | (uintptr_t)cell.dh_reg) % 16 == 0 &&
                  (uintptr_t)cell.dg % (4 * sizeof(CT)) == 0;
  for (int p = tid; p < BH_BM * (BH_BN / 4); p += BH_THREADS) {
    const int r = p / (BH_BN / 4), c = (p % (BH_BN / 4)) * 4;
    const int row = row0 + r, col = col0 + c;
    if (row >= B || col >= H) continue;
    const CT* a = s_act + r * 4 * BH_BN + c;
    const int e = r * BH_BN + c;
    if (v4 && col + 4 <= H) {
      float4 g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = load4ct(a + q * BH_BN);
      cell.apply4(row, col, *reinterpret_cast<const float4*>(s_dht + e), g,
                  cell.c_prev != nullptr
                      ? load4ct(s_cp + e)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f),
                  *reinterpret_cast<const float4*>(s_dc + e));
      continue;
    }
    for (int j = 0; j < 4 && col + j < H; ++j)
      cell.apply(row, col + j, s_dht[e + j], to_float(a[j]),
                 to_float(a[BH_BN + j]), to_float(a[2 * BH_BN + j]),
                 to_float(a[3 * BH_BN + j]),
                 cell.c_prev != nullptr ? to_float(s_cp[e + j]) : 0.0f,
                 s_dc[e + j]);
  }
}

// ---------------------------------------------------------------------------
// bwd_cell: the cell backward alone (CellBwd), one thread per (row, unit);
// the training path runs it fused into bwd_head and the dq @ Wq^T product
// ---------------------------------------------------------------------------
template <class CT>
__global__ void bwd_cell_kernel(const float* __restrict__ dh_tot, int B,
                                CellBwd<CT> cell) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * cell.H) return;
  cell(idx / cell.H, idx % cell.H, dh_tot[idx]);
}

// ---------------------------------------------------------------------------
// att_bwd: the attention backward of one step
// (ops/pallas_train_decoder.py:779-926, single fold):
//   dw = dw_out + dcum + sum_m mem[t, m] dctx[m]
//   de = w (dw - sum_t dw w)               (softmax backward, stored w)
//   tz recomputed from cum and q; dz = de[t] v[a] (1 - tz^2)
//   dmt += dz; dv += sum_t tz de; dq = sum_t dz (-> bf16 stream)
//   dlc[k, a] += sum_t bf16(cum[t+k-half]) bf16(dz[t, a])
//   dcum[t'] += sum_{k, a} bf16(dz[t'-k+half, a]) lc[k, a]
// dmt [B, T, A], dlc [B, K, A] and dv [B, A] are per-row accumulators.
//
// A batch row is a cluster of `cl` CTAs, CTA `rank` owning the `tile`
// positions from rank * tile (tile a multiple of 16; cl * tile covers T).
// Each CTA: dw over its positions (a warp a row, 16-byte loads of memory
// with a scalar head and tail); its partial of sum_t dw w, summed by every
// CTA from the cluster's shared memory in rank order after a cluster
// barrier; the energy recompute as the band product loc = band(cum) @ lc
// (csrc/tile.cuh), with dz, the dmt update and the dv and dq column sums in
// its epilogue and bf16(dz) into shared memory; dlc's partial band(cum)^T @
// bf16(dz) and P = bf16(dz) @ lc^T on the tensor cores.  After a second
// cluster barrier each CTA sums the diagonals of P for its own positions,
// reading the halo rows from its neighbours, and a 1/cl share of the dlc,
// dv and dq partials in rank order before its "+=".  No float atomics: a
// run repeats bit for bit.
//
// The forward family (KIND ATT_FWD, ATT_FWD_TRANS;
// ops/pallas_train_decoder.py:857-896) has no location conv and no band
// product.  Each CTA replays its positions' energies (a warp a position,
// bf16(tanh(bf16(q + mtb))) kept in shared memory for dz) and, with
// exchanges in rank order, the row's softmax (each tile's max m_j and sum
// s_j of exp(e - m_j) at one exchange, the row's sum sum_j s_j exp(m_j -
// m)) and the recurrence from the stored state (the tile's first position
// reads its neighbour's last state as a halo), the masked w and the
// renorm's sum of max(w, 1e-6), exchanged with the sums below that need
// only it as a divisor (pe = sum_t [w_s > 1e-6] (dw - s1) comb energy /
// sum, and dtp's likewise), so that the replay crosses two cluster
// barriers and the dv and dq partials a third; then
//   dwc = (dw - sum_t dw w_s) / sum;  dw_raw = wm > 1e-6 ? dwc : 0
//   denergy = dw_raw comb;  dcomb = dw_raw energy
//   dcum[t] = dcomb[t] + bf16(dcomb[t+1])          (assigned: the state is
//   or (1 - tp) dcomb[t] + bf16(tp dcomb[t+1])      w, not cum + w)
//   dtp = sum_t dcomb (bf16(prev[t-1]) - prev[t])  (into the dtp carry)
//   de = energy (denergy - sum_t denergy energy)
// with dcomb[t+1] of the tile's last position read from the next CTA, and
// dz, dmt, dv and dq as above, with every thread busy: a thread a channel
// pair and a group of the tile's positions (AbFamMap), its dmt pairs read
// as 8-byte loads, AB_DZ_BATCH in flight before the arithmetic, and the
// groups' dv and dq partials summed in shared memory in group order before
// the cluster's rank-order sum.  With
// the transition agent, the prologue runs the agent's backward
// (pallas_train_decoder.py:759-785, :936-937): dlin = dtp tp (1 - tp) from
// the dtp carry that the next step left and the step's own tp, which the
// context cotangent consumed here gets as dlin wc, the attention LSTM's h
// cotangent (complete once the generator's product has run) as dlin wq,
// and dx, the prenet output's cotangent that the attention gates' product
// adds to next, as dlin wx; each CTA a 1/cl share of h_att's and x's.
// Bound: the bytes of memory, mtb and the dmt accumulator's read and write
// (3.7 us at B=50, T=128), as the location-sensitive backward's.
//
// In float32 (CT float) nothing is rounded and the location conv's three
// products run on the tensor cores in three TF32 passes (csrc/tile.cuh,
// the band routine's float32 instance; the TPU kernel's band products take
// full precision, ops/pallas_train_decoder.py:904-925) in the bf16
// instance's order of work: lc copied with cp.async and split into its
// TF32 halves once, cum split once when staged; loc, summed straight into
// the float32 sums over the 32 taps, a warp per 8 channels down the tile
// with dz in its epilogue (float32 dz into a swizzled tile, band_swz);
// P = dz @ lc^T a warp per 16 positions x 8 taps over K = A (two sums,
// even and odd K steps); then, lc dead, dlc's partial a warp per 8
// channels over the tile, each 16-row tile's passes summed apart, into
// lc's hi rows.  dz is split in registers where P and dlc read it.  Four
// CTAs an SM (__launch_bounds__ holds this instance to 64 registers, and
// it takes 47 KB of shared memory at T = 128), so that a step's 50
// clusters of 8 are resident at once; the other instances keep the
// compiler's choice (64 registers).
// Bound as the bf16 instance's: bytes (5.7 us at B=50, T=128).
//
// Long texts: the tile grows with T (att_bwd_tiles); in the single tile's
// layout every per-position row lives in shared memory (about 410 bytes a
// position in bf16 and 650 in float32 at A = 128, location-sensitive; 284
// and 540 in the forward family, its tanh terms), which holds T up to
// about 3,900 (bf16) and 2,304 (float32: a tile of 288 positions), and
// 6,200 and 3,200 in the family, at the flagship's widths.  Past that the
// planner (ops/fused_train_decoder.py::att_bwd_plan) picks the sub-tiled
// layout (AbLayout sub > 0, att_bwd_sub_kernel): the location-sensitive
// passes walk the tile in sub-tiles of 64 positions (att_bwd_ls_sub), and
// the family's dz pass recomputes its tanh terms from mtb instead of
// keeping them (one more read of mtb, B*T*A elements, where a scratch in
// device memory would move them twice, written and read), so that what
// stays in shared memory grows by 14 bytes a position in bf16 and 20 in
// float32 (location-sensitive; the family 28): T = 8,192's tiles of 1,024
// take 69 KB in bf16 and 115 KB in float32 at the flagship's widths (the
// family 37 KB).  The single tile's shapes
// run the single tile's code, unchanged; the launcher refuses a layout
// that does not fit.
// ---------------------------------------------------------------------------
constexpr int AB_THREADS = 256, AB_WARPS = AB_THREADS / 32;
// the forward family's dz pass: positions a thread loads at once
constexpr int AB_DZ_BATCH = 4;

// the forward family's dz pass over a tile of `rows` positions and A
// channels (A even: the launcher's check): a thread a channel pair (a, a +
// 1) and a group of the positions, as many groups as the threads leave
// (A = 128: 64 pairs x 4 groups, 4 positions a thread at T = 128's tiles of
// 16, 48 at T = 1,500's tiles of 192, looped AB_DZ_BATCH at a time)
struct AbFamMap {
  int pairs, groups, per;
  __host__ __device__ AbFamMap(int A, int rows) {
    pairs = (A + 1) / 2;
    groups = pairs < AB_THREADS ? AB_THREADS / pairs : 1;
    per = (rows + groups - 1) / groups;
  }
};

// the forward family's operands of att_bwd (null for location-sensitive;
// all but mask_add null without the transition agent)
struct AbFam {
  const float* mask_add;   // [B, T]
  const float* tp_prev;    // [B] the t_prob that the step's recurrence read
  const float* tp;         // [B] the t_prob the step made
  float* dtp;              // [B] its cotangent carry: read, then replaced
  float* dlin;             // [B] the pre-sigmoid gradient stream
  const float* w;          // [Mem + H + P] the agent's weight, float32
  float* dh_att;           // [B, H] float32, added to
  float* dx;               // [B, P] float32, written
  int H, P;
};

// shared-memory layout of att_bwd_kernel (byte offsets) for compute-type
// elements of `es` bytes; the forward family needs no band operands but
// five float rows of its tile, the tile's energy terms and its dz pass's
// dv and dq partials by position group ([groups][A] each, AbFamMap).  bf16: lc's and
// dz's rows of ld = A + 8 elements, for ldmatrix.  float32 (tf32): lc's hi
// and lo tiles and dz's, swizzled rows of ld = A words (band_swz); dlc's
// partial takes lc's hi rows once P has read them, w P's rows until P is
// written, and cum is kept as its TF32 halves: per position the bytes of
// the FFMA design that it replaced.
//
// `sub` > 0 is the sub-tiled layout of long texts, where the single tile's
// rows do not fit (ops/fused_train_decoder.py::att_bwd_plan): dz's and P's
// rows for `sub` positions only, dlc's partial in its own [32][A] floats,
// w in its own row, and the cum cotangent's sums over the tile with
// BAND_K positions each side (acc, at fam); the forward family keeps no
// tanh terms (tz empty: the dz pass recomputes them from mtb).  sub = 0
// gives the single tile's offsets, unchanged.
struct AbLayout {
  int ld;
  size_t lc, dz, p, dlcp, q, v, dvp, dqp, w, de, dctx, cum, cum_lo, red, s1,
      fam, tz, gdv, gdq, total;
  __host__ __device__ AbLayout(int tile, int A, int Mem, bool family, int es,
                               int sub = 0) {
    const bool tf32 = es == 4 && !family;
    // the single tile's float32 band layout, with its aliased rows
    const bool alias = tf32 && sub == 0;
    const int rows = sub > 0 ? sub : tile;   // dz's and P's rows
    ld = tf32 ? A : A + 8;
    lc = 0;
    dz = lc + (family ? 0 : align16((size_t)(tf32 ? 2 : 1) * BAND_K * ld * es));
    p = dz + (family ? 0 : align16((size_t)rows * ld * es));
    dlcp = alias ? lc : p + (family ? 0 : align16((size_t)rows * BAND_K * 4));
    q = alias ? p + align16((size_t)tile * BAND_K * 4)
              : dlcp + (family ? 0 : align16((size_t)BAND_K * A * 4));
    v = q + align16((size_t)A * 4);
    dvp = v + align16((size_t)A * 4);
    dqp = dvp + align16((size_t)A * 4);
    w = alias ? p : dqp + align16((size_t)A * 4);
    de = alias ? dqp + align16((size_t)A * 4) : w + align16((size_t)tile * 4);
    dctx = de + align16((size_t)tile * 4);
    cum = dctx + align16((size_t)Mem * 4);
    cum_lo = cum + (family ? 0 : align16((size_t)(tile + BAND_K) * es));
    red = cum_lo + (tf32 ? align16((size_t)(tile + BAND_K) * 4) : 0);
    s1 = red + 32 * 4;
    fam = s1 + 32;
    tz = fam + (family ? align16((size_t)5 * tile * 4)
                : sub > 0 ? align16((size_t)(tile + 2 * BAND_K) * 4) : 0);
    // groups x A <= max(2 x AB_THREADS, A) floats
    const size_t gp = family ? align16(
        (size_t)(A > 2 * AB_THREADS ? A : 2 * AB_THREADS) * 4) : 0;
    gdv = tz + (family && sub == 0 ? align16((size_t)tile * A * es) : 0);
    gdq = gdv + gp;
    total = gdq + gp;
  }
};

// att_bwd_kernel's parameters and arguments
#define AB_PARAMS                                                           \
  const float *__restrict__ q, const CT *__restrict__ cum_s,              \
      const float *__restrict__ w_s, const CT *__restrict__ memory,       \
      const CT *__restrict__ mtb, const CT *__restrict__ lc,              \
      const float *__restrict__ v, const float *__restrict__ dctx,        \
      const float *__restrict__ dw_out, float *__restrict__ dcum,         \
      float *__restrict__ dmt, float *__restrict__ dlc,                   \
      float *__restrict__ dv, CT *__restrict__ dq_out,                    \
      CT *__restrict__ dctx_out, int T, int A, int Mem, int K, int tile,  \
      int cl, int sub, AbFam fa
#define AB_ARGS                                                            \
  q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out, dcum, dmt, dlc, dv,     \
      dq_out, dctx_out, T, A, Mem, K, tile, cl, sub, fa

// att_bwd's location-sensitive passes in the sub-tiled layout (AbLayout
// sub > 0, texts whose single tile does not fit): the CTA walks its tile in
// sub-tiles of `sub` positions (whole mma tiles), each through the single
// tile's three passes on its own rows: dz over (position, channel) with
// the dmt update and the dv and dq partials in the band product's
// epilogue, dlc's partial band(cum)^T @ dz and P = dz @ lc^T.  The dv, dq
// and dlc partials are added into the CTA's sums (s_dvp, s_dqp, s_dlcp) in
// sub-tile order, and P's diagonals into the cum cotangent's sums s_acc
// [BAND_K + i] for the positions i they reach, from -half (the left
// neighbour's last ones) to tile + K - 2 - half (the right neighbour's
// first ones).  After the cluster barrier each own position adds its left
// and right neighbours' edge sums, in that order, into dcum.  cum stays
// staged for the whole tile (s_cum; in float32 with its TF32 lo halves,
// lc split once), as in the single tile.  No float atomics, sums in a
// fixed order: a run repeats bit for bit.  The passes repeat the single
// tile's code rather than share it: one routine for both raised the
// float32 single tile's spills (held to 64 registers) from 48 to 156 bytes
// of loads and its time at T = 128 by 4.6 % (PERF.md).
template <class CT>
__device__ void att_bwd_ls_sub(
    const CT* s_lc, CT* s_dz, float* s_p, float* s_dlcp, const float* s_q,
    const float* s_v, float* s_dvp, float* s_dqp, const float* s_de,
    const CT* s_cum, const float* s_cum_lo, float* s_acc,
    const CT* __restrict__ mtb, float* __restrict__ dmt,
    float* __restrict__ dcum, size_t rowT, int t_lo, int rows, int tile,
    int T, int A, int K, int ld, int sub, int rank, int cl) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int half = (K - 1) / 2;
  for (int i = tid; i < BAND_K * A; i += AB_THREADS) s_dlcp[i] = 0.0f;
  for (int a = tid; a < A; a += AB_THREADS) s_dvp[a] = s_dqp[a] = 0.0f;
  for (int i = tid; i < tile + 2 * BAND_K; i += AB_THREADS) s_acc[i] = 0.0f;
  __syncthreads();
  for (int s0 = 0; s0 < rows; s0 += sub) {
    const int n = min(sub, tile - s0), mtiles = n / 16, mt0 = s0 / 16;
    // dz over the sub-tile's (position, channel): loc = band(cum) @ lc, a
    // warp per 8 channels down the sub-tile
    for (int n0 = warp * 8; n0 < A; n0 += AB_WARPS * 8) {
      const int a = n0 + 2 * qd;
      const float q0 = s_q[a], q1 = s_q[a + 1], v0 = s_v[a],
                  v1 = s_v[a + 1];
      uint32_t bh[4][2], bl[4][2];
      if constexpr (F32) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          band_frag_kn(bh[ks], s_lc, A, 8 * ks, n0, lane);
          band_frag_kn(bl[ks], s_lc + BAND_K * A, A, 8 * ks, n0, lane);
        }
      }
      float pdv0 = 0.0f, pdv1 = 0.0f, pdq0 = 0.0f, pdq1 = 0.0f;
      for (int mt = 0; mt < mtiles; ++mt) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (F32) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t ah[4], al[4];
            band_frag_tf32(ah, s_cum + (mt0 + mt) * 16 + 8 * ks, lane);
            band_frag_tf32(al, s_cum_lo + (mt0 + mt) * 16 + 8 * ks, lane);
            mma_tf32x3(acc, ah, al, bh[ks], bl[ks]);
          }
        } else {
          uint32_t af[2][4];
          band_frags(af, s_cum + (mt0 + mt) * 16, lane);
          band_loc(acc, af, s_lc, ld, n0, lane);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h, i = s0 + r, t = t_lo + i;
          float dz0 = 0.0f, dz1 = 0.0f;
          if (t < T) {
            const size_t o = (rowT + t) * A + a;
            float m0, m1;
            if constexpr (F32) {
              const float2 m2 = *reinterpret_cast<const float2*>(mtb + o);
              m0 = m2.x;
              m1 = m2.y;
            } else {
              const __nv_bfloat162 m2 =
                  *reinterpret_cast<const __nv_bfloat162*>(mtb + o);
              m0 = __low2float(m2);
              m1 = __high2float(m2);
            }
            const float tz0 = band_energy_tanh<CT>(acc[2 * h], q0, m0);
            const float tz1 = band_energy_tanh<CT>(acc[2 * h + 1], q1, m1);
            const float de = s_de[i];
            dz0 = de * v0 * (1.0f - tz0 * tz0);
            dz1 = de * v1 * (1.0f - tz1 * tz1);
            float2* pm = reinterpret_cast<float2*>(dmt + o);
            float2 old = *pm;
            old.x += dz0;
            old.y += dz1;
            *pm = old;
            pdv0 = fmaf(tz0, de, pdv0);
            pdv1 = fmaf(tz1, de, pdv1);
            pdq0 += dz0;
            pdq1 += dz1;
          }
          if constexpr (F32)
            *reinterpret_cast<float2*>(s_dz + band_swz(r, a, A)) =
                make_float2(dz0, dz1);
          else
            *reinterpret_cast<__nv_bfloat162*>(s_dz + r * ld + a) =
                __floats2bfloat162_rn(dz0, dz1);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        pdv0 += __shfl_xor_sync(0xffffffffu, pdv0, off);
        pdv1 += __shfl_xor_sync(0xffffffffu, pdv1, off);
        pdq0 += __shfl_xor_sync(0xffffffffu, pdq0, off);
        pdq1 += __shfl_xor_sync(0xffffffffu, pdq1, off);
      }
      if (g == 0) {
        s_dvp[a] += pdv0;
        s_dvp[a + 1] += pdv1;
        s_dqp[a] += pdq0;
        s_dqp[a + 1] += pdq1;
      }
    }
    __syncthreads();
    if constexpr (F32) {
      const float* lc_lo = s_lc + BAND_K * A;
      // P = dz @ lc^T, [n][32]: a warp per 16 positions x 8 taps over K =
      // A, as the single tile's
      for (int it = warp; it < mtiles * 4; it += AB_WARPS) {
        const int m0 = (it >> 2) * 16, n0 = (it & 3) * 8;
        float acc[2][4] = {};
        for (int kk = 0; kk < A; kk += 16) {
          uint32_t bh[4], bl[4];
          const int lc_at = band_swz(n0 + (lane & 7), kk + (lane >> 3) * 4, A);
          ldsm_x4(bh, s_lc + lc_at);
          ldsm_x4(bl, lc_lo + lc_at);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t ah[4], al[4];
            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8,
                                        kk + 8 * h + (lane >> 4) * 4, A));
            tf32_split<4>(ah, al, ah);
            mma_tf32x3(acc[h], ah, al, bh + 2 * h, bl + 2 * h);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_p[(m0 + g + 8 * (e >> 1)) * BAND_K + n0 + 2 * qd + (e & 1)] =
              acc[0][e] + acc[1][e];
      }
      // dlc's partial band(cum)^T @ dz, a warp per 8 channels, each 16-row
      // tile's passes summed apart, added into s_dlcp
      for (int n0 = warp * 8; n0 < A; n0 += AB_WARPS * 8) {
        float acc[2][4] = {};
        for (int mt = 0; mt < mtiles; ++mt) {
          float st[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int k0 = mt * 16 + 8 * ks;
            uint32_t bh[2], bl[2];
            band_frag_kn(bh, s_dz, A, k0, n0, lane);
            tf32_split<2>(bh, bl, bh);
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              uint32_t ah[4], al[4];
              band_frag_tf32(ah, s_cum + s0 + k0 + 16 * kh, lane);
              band_frag_tf32(al, s_cum_lo + s0 + k0 + 16 * kh, lane);
              mma_tf32x3(st[kh], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[kh][e] += st[kh][e];
        }
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_dlcp[(kh * 16 + g + 8 * (e >> 1)) * A + n0 + 2 * qd + (e & 1)] +=
                acc[kh][e];
      }
    } else {
      // dlc's partial band(cum)^T @ bf16(dz), a warp per 16 channels, both
      // halves of the 32 taps, added into s_dlcp
      for (int n0 = warp * 16; n0 < A; n0 += AB_WARPS * 16) {
        float acc[2][2][4] = {};
        for (int mt = 0; mt < mtiles; ++mt)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
            band_dlc(acc[kh], s_cum + s0 + mt * 16 + kh * 16,
                     s_dz + mt * 16 * ld, ld, n0, lane);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s_dlcp[(kh * 16 + g + 8 * (e >> 1)) * A + n0 + nt * 8 + 2 * qd +
                     (e & 1)] += acc[kh][nt][e];
      }
      // P = bf16(dz) @ lc^T, [n][32]: a warp per 16 positions x 16 taps
      for (int it = warp; it < mtiles * 2; it += AB_WARPS) {
        const int mt = it >> 1, kh = it & 1;
        float acc[2][4] = {};
        band_p(acc, s_dz + mt * 16 * ld, s_lc, ld, kh * 16, A, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_p[(mt * 16 + g + 8 * (e >> 1)) * BAND_K + kh * 16 + nt * 8 +
                2 * qd + (e & 1)] = acc[nt][e];
      }
    }
    __syncthreads();
    // P's diagonals: row r = i - k + half of the sub-tile reaches position
    // i at tap k, a warp a position, a lane a tap
    for (int i = s0 - half + warp; i <= s0 + n + K - 2 - half;
         i += AB_WARPS) {
      const int r = i - lane + half - s0;
      float part = lane < K && r >= 0 && r < n ? s_p[r * BAND_K + lane] : 0.0f;
      part = warp_sum(part);
      if (lane == 0) s_acc[BAND_K + i] += part;
    }
    __syncthreads();
  }
  cluster_sync();
  // each own position's sum, then the left and right neighbours' edges
  for (int i = tid; i < rows; i += AB_THREADS) {
    float part = s_acc[BAND_K + i];
    if (rank > 0 && i < BAND_K)
      part += cluster_peer(s_acc, rank - 1)[BAND_K + tile + i];
    if (rank + 1 < cl && i >= tile - BAND_K)
      part += cluster_peer(s_acc, rank + 1)[BAND_K + i - tile];
    dcum[rowT + t_lo + i] += part;
  }
}

template <int KIND, class CT, bool SUB = false>
__device__ __forceinline__ void att_bwd_body(AB_PARAMS) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  constexpr int V = 16 / sizeof(CT);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t ab_smem[];
  const AbLayout L(tile, A, Mem, KIND != ATT_LS, sizeof(CT), SUB ? sub : 0);
  const int ld = L.ld;
  CT* s_lc = reinterpret_cast<CT*>(ab_smem + L.lc);            // [32][ld]
  CT* s_dz = reinterpret_cast<CT*>(ab_smem + L.dz);            // [tile][ld]
  float* s_p = reinterpret_cast<float*>(ab_smem + L.p);        // [tile][32]
  float* s_dlcp = reinterpret_cast<float*>(ab_smem + L.dlcp);  // [32][A]
  float* s_q = reinterpret_cast<float*>(ab_smem + L.q);
  float* s_v = reinterpret_cast<float*>(ab_smem + L.v);
  float* s_dvp = reinterpret_cast<float*>(ab_smem + L.dvp);    // [A]
  float* s_dqp = reinterpret_cast<float*>(ab_smem + L.dqp);    // [A]
  float* s_w = reinterpret_cast<float*>(ab_smem + L.w);        // [tile]
  float* s_de = reinterpret_cast<float*>(ab_smem + L.de);      // [tile]
  float* s_dctx = reinterpret_cast<float*>(ab_smem + L.dctx);  // [Mem]
  CT* s_cum = reinterpret_cast<CT*>(ab_smem + L.cum);          // [tile + 32]
  // float32: cum's TF32 lo halves beside s_cum's hi
  float* s_cum_lo = reinterpret_cast<float*>(ab_smem + L.cum_lo);
  float* s_red = reinterpret_cast<float*>(ab_smem + L.red);
  // [0] sum_t dw w; the forward family: [1] max, [2] the softmax's sum,
  // [3] the renorm's sum, [4] sum_t denergy energy, [5] dtp, [6] the halo
  // state prev[t_lo - 1]
  float* s_s1 = reinterpret_cast<float*>(ab_smem + L.s1);      // [8]
  // the forward family's tile rows: prev, energy, comb, wm, dcomb
  float* s_prev = reinterpret_cast<float*>(ab_smem + L.fam);
  float* s_en = s_prev + tile;
  float* s_comb = s_en + tile;
  float* s_wm = s_comb + tile;
  float* s_dcb = s_wm + tile;
  CT* s_tz = reinterpret_cast<CT*>(ab_smem + L.tz);            // [tile][A]
  // the family's dv and dq partials by position group, [groups][A] each
  float* s_gdv = reinterpret_cast<float*>(ab_smem + L.gdv);
  float* s_gdq = reinterpret_cast<float*>(ab_smem + L.gdq);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x / cl, t_lo = rank * tile;
  const int rows = min(tile, T - t_lo);
  const int half = (K - 1) / 2;
  const size_t rowT = (size_t)b * T;

  for (int a = tid; a < A; a += AB_THREADS) {
    s_q[a] = q[(size_t)b * A + a];
    s_v[a] = v[a];
  }
  if constexpr (KIND == ATT_LS && F32) {
    // lc's copy lands during the dw pass and is split after it
    band_copy_lc_tf32(s_lc, lc, K, A);
    cp_async_commit();
    band_stage_cum_tf32(s_cum, s_cum_lo, tile + BAND_K, cum_s + rowT, t_lo,
                        half, T);
  } else if constexpr (KIND == ATT_LS) {
    band_stage_lc(s_lc, ld, lc, K, A);
    band_stage_cum(s_cum, tile + BAND_K, cum_s + rowT, t_lo, half, T);
  } else {
    for (int i = tid; i < tile; i += AB_THREADS)
      s_prev[i] = t_lo + i < T ? to_float(cum_s[rowT + t_lo + i]) : 0.0f;
    if (tid == 0)
      s_s1[6] = t_lo > 0 ? to_float(cum_s[rowT + t_lo - 1]) : 0.0f;
  }
  for (int i = tid; i < tile; i += AB_THREADS)
    s_w[i] = t_lo + i < T ? w_s[rowT + t_lo + i] : 0.0f;
  // the transition agent's backward: dlin from the dtp carry (read here,
  // before any CTA of the row replaces it after the barriers below)
  float dlin = 0.0f;
  if constexpr (KIND == ATT_FWD_TRANS) {
    const float p = fa.tp[b];
    dlin = fa.dtp[b] * p * (1.0f - p);
    const float* wq = fa.w + Mem;
    const float* wx = wq + fa.H;
    const int sh_h = (fa.H + cl - 1) / cl, sh_p = (fa.P + cl - 1) / cl;
    for (int k = rank * sh_h + tid; k < min(fa.H, (rank + 1) * sh_h);
         k += AB_THREADS)
      fa.dh_att[(size_t)b * fa.H + k] += dlin * wq[k];
    for (int k = rank * sh_p + tid; k < min(fa.P, (rank + 1) * sh_p);
         k += AB_THREADS)
      fa.dx[(size_t)b * fa.P + k] = dlin * wx[k];
    if (rank == 0 && tid == 0) fa.dlin[b] = dlin;
  }
  for (int m = tid; m < Mem; m += AB_THREADS) {
    float d = dctx[(size_t)b * Mem + m];
    if constexpr (KIND == ATT_FWD_TRANS) d += dlin * fa.w[m];
    s_dctx[m] = d;
    if (rank == 0) dctx_out[(size_t)b * Mem + m] = from_float<CT>(d);
  }
  __syncthreads();

  // dw, a warp per position: 16-byte loads of the row's aligned body; the
  // forward family's energy there too, its mtb row read beside the memory
  // row and its tanh terms kept for dz
  for (int i = warp; i < tile; i += AB_WARPS) {
    const int t = t_lo + i;
    float part = 0.0f;
    if (t < T) {
      const CT* row = memory + (rowT + t) * Mem;
      const int head = min(
          Mem, (int)((16 - ((uintptr_t)row & 15)) & 15) / (int)sizeof(CT));
      const int body = (Mem - head) / V, rest = head + V * body;
      for (int c = lane; c < body; c += 32) {
        float x[V];
        chunk_floats(x, *reinterpret_cast<const uint4*>(row + head + V * c),
                     row);
        const float* d = s_dctx + head + V * c;
#pragma unroll
        for (int j = 0; j < V; ++j) part = fmaf(x[j], d[j], part);
      }
      if (lane < head) part = fmaf(to_float(row[lane]), s_dctx[lane], part);
      if (rest + lane < Mem)
        part = fmaf(to_float(row[rest + lane]), s_dctx[rest + lane], part);
    }
    if constexpr (KIND != ATT_LS) {
      float e = 0.0f;
      if (t < T) {
        if constexpr (F32) {
          for (int a = lane; a < A; a += 32) {
            const float tz = fwd_energy_tanh<CT>(s_q[a],
                                                 mtb[(rowT + t) * A + a]);
            if constexpr (!SUB) s_tz[i * A + a] = tz;
            e = fmaf(s_v[a], tz, e);
          }
        } else {
          for (int a = 2 * lane; a < A; a += 64) {
            const __nv_bfloat162 m2 = *reinterpret_cast<const __nv_bfloat162*>(
                mtb + (rowT + t) * A + a);
            const float tz0 = fwd_energy_tanh(s_q[a], __low2float(m2));
            const float tz1 = fwd_energy_tanh(s_q[a + 1], __high2float(m2));
            if constexpr (!SUB)
              *reinterpret_cast<__nv_bfloat162*>(s_tz + i * A + a) =
                  __floats2bfloat162_rn(tz0, tz1);
            e = fmaf(s_v[a], tz0, e);
            e = fmaf(s_v[a + 1], tz1, e);
          }
        }
      }
      e = warp_sum(e);
      if (lane == 0) s_en[i] = e;
    }
    part = warp_sum(part);
    if (lane == 0)
      s_de[i] = t < T ? dw_out[rowT + t] + dcum[rowT + t] + part : 0.0f;
  }
  if constexpr (KIND == ATT_LS && F32) cp_async_wait<0>();
  __syncthreads();
  if constexpr (KIND == ATT_LS && F32) tf32_split_words(s_lc, BAND_K * A);
  float s1 = 0.0f;
  for (int i = tid; i < tile; i += AB_THREADS) s1 += s_de[i] * s_w[i];
  s1 = block_reduce<false>(s1, s_red);
  if (tid == 0) s_s1[0] = s1;

  if constexpr (KIND != ATT_LS) {
    // the tile's max m_j and its sum s_j of exp(e - m_j), published with
    // s1 at one exchange: the row's sum is sum_j s_j exp(m_j - m), in rank
    // order
    float mx = -CUDART_INF_F;
    for (int i = tid; i < rows; i += AB_THREADS) mx = fmaxf(mx, s_en[i]);
    mx = block_reduce<true>(mx, s_red);
    float psum = 0.0f;
    for (int i = tid; i < rows; i += AB_THREADS) psum += expf(s_en[i] - mx);
    psum = block_reduce<false>(psum, s_red);
    if (tid == 0) {
      s_s1[1] = mx;
      s_s1[2] = psum;
    }
    cluster_sync();
    s1 = 0.0f;
    mx = -CUDART_INF_F;
    for (int j = 0; j < cl; ++j) {
      s1 += cluster_peer(s_s1, j)[0];
      mx = fmaxf(mx, cluster_peer(s_s1, j)[1]);
    }
    psum = 0.0f;
    for (int j = 0; j < cl; ++j)
      psum += cluster_peer(s_s1, j)[2] * expf(cluster_peer(s_s1, j)[1] - mx);
    // the replayed recurrence, the mask and the renorm's sum, published
    // with what the renorm's backward sums: over the unfloored positions,
    // (dw - s1) comb energy (pe times the renorm's sum) and (dw - s1)
    // energy (shifted - prev) (dtp's)
    const float tp = KIND == ATT_FWD_TRANS ? fa.tp_prev[b] : 0.0f;
    float nsum = 0.0f, pe = 0.0f, pt = 0.0f;
    for (int i = tid; i < rows; i += AB_THREADS) {
      const float energy = expf(s_en[i] - mx) / psum;
      const float prev = s_prev[i];
      const float sh = i > 0 ? s_prev[i - 1] : s_s1[6];
      const float comb = KIND == ATT_FWD_TRANS
                             ? (1.0f - tp) * prev + tp * sh
                             : prev + sh;
      const float wm =
          fa.mask_add[rowT + t_lo + i] > -0.5f ? comb * energy : 0.0f;
      s_en[i] = energy;
      s_comb[i] = comb;
      s_wm[i] = wm;
      nsum += fmaxf(wm, 1e-6f);
      if (wm > 1e-6f) {
        const float d = s_de[i] - s1;
        pe = fmaf(d * comb, energy, pe);
        if (KIND == ATT_FWD_TRANS) pt = fmaf(d * energy, sh - prev, pt);
      }
    }
    nsum = block_reduce<false>(nsum, s_red);
    pe = block_reduce<false>(pe, s_red);
    if (KIND == ATT_FWD_TRANS) pt = block_reduce<false>(pt, s_red);
    if (tid == 0) {
      s_s1[3] = nsum;
      s_s1[4] = pe;
      s_s1[5] = pt;
    }
    cluster_sync();
    nsum = 0.0f;
    pe = 0.0f;
    pt = 0.0f;
    for (int j = 0; j < cl; ++j) {
      nsum += cluster_peer(s_s1, j)[3];
      pe += cluster_peer(s_s1, j)[4];
      pt += cluster_peer(s_s1, j)[5];
    }
    pe /= nsum;
    pt /= nsum;
    // the renorm's and the floor's backward, then the softmax's; dcomb
    // kept for the state's cotangent after the next exchange
    for (int i = tid; i < rows; i += AB_THREADS) {
      const float dwc = (s_de[i] - s1) / nsum;
      const float dwr = s_wm[i] > 1e-6f ? dwc : 0.0f;
      s_dcb[i] = dwr * s_en[i];
      s_de[i] = s_en[i] * (dwr * s_comb[i] - pe);
    }
    if (KIND == ATT_FWD_TRANS && rank == 0 && tid == 0) fa.dtp[b] = pt;
    __syncthreads();
    // dz, dmt, and the dv and dq partials: a thread a channel pair and a
    // group of the tile's positions (AbFamMap), its dmt pairs loaded
    // AB_DZ_BATCH at a time before the arithmetic, then written back; the
    // groups' partials summed in group order (positions ascending)
    const AbFamMap fm(A, rows);
    for (int c = tid; c < fm.pairs * fm.groups; c += AB_THREADS) {
      const int a = 2 * (c % fm.pairs), grp = c / fm.pairs;
      const int i_lo = grp * fm.per, i_hi = min(rows, i_lo + fm.per);
      const float v0 = s_v[a], v1 = s_v[a + 1];
      float pdv0 = 0.0f, pdv1 = 0.0f, pdq0 = 0.0f, pdq1 = 0.0f;
      for (int i0 = i_lo; i0 < i_hi; i0 += AB_DZ_BATCH) {
        float2 m[AB_DZ_BATCH], mt[AB_DZ_BATCH];
#pragma unroll
        for (int j = 0; j < AB_DZ_BATCH; ++j)
          if (i0 + j < i_hi) {
            const size_t o = (rowT + t_lo + i0 + j) * A + a;
            m[j] = *reinterpret_cast<const float2*>(dmt + o);
            // the sub-tiled layout keeps no tanh terms: mtb's pair, for
            // the dw pass's op sequence again (the same values)
            if constexpr (SUB && F32) {
              mt[j] = make_float2(mtb[o], mtb[o + 1]);
            } else if constexpr (SUB) {
              const __nv_bfloat162 m2 =
                  *reinterpret_cast<const __nv_bfloat162*>(mtb + o);
              mt[j] = make_float2(__low2float(m2), __high2float(m2));
            }
          }
#pragma unroll
        for (int j = 0; j < AB_DZ_BATCH; ++j) {
          const int i = i0 + j;
          if (i >= i_hi) continue;
          float tz0, tz1;
          if constexpr (SUB) {
            tz0 = fwd_energy_tanh<CT>(s_q[a], mt[j].x);
            tz1 = fwd_energy_tanh<CT>(s_q[a + 1], mt[j].y);
          } else if constexpr (F32) {
            const float2 z = *reinterpret_cast<const float2*>(s_tz + i * A + a);
            tz0 = z.x;
            tz1 = z.y;
          } else {
            const __nv_bfloat162 z =
                *reinterpret_cast<const __nv_bfloat162*>(s_tz + i * A + a);
            tz0 = __low2float(z);
            tz1 = __high2float(z);
          }
          const float de = s_de[i];
          const float dz0 = de * v0 * (1.0f - tz0 * tz0);
          const float dz1 = de * v1 * (1.0f - tz1 * tz1);
          m[j].x += dz0;
          m[j].y += dz1;
          *reinterpret_cast<float2*>(dmt + (rowT + t_lo + i) * A + a) = m[j];
          pdv0 = fmaf(tz0, de, pdv0);
          pdv1 = fmaf(tz1, de, pdv1);
          pdq0 += dz0;
          pdq1 += dz1;
        }
      }
      s_gdv[grp * A + a] = pdv0;
      s_gdv[grp * A + a + 1] = pdv1;
      s_gdq[grp * A + a] = pdq0;
      s_gdq[grp * A + a + 1] = pdq1;
    }
    __syncthreads();
    for (int a = tid; a < A; a += AB_THREADS) {
      float pdv = 0.0f, pdq = 0.0f;
      for (int grp = 0; grp < fm.groups; ++grp) {
        pdv += s_gdv[grp * A + a];
        pdq += s_gdq[grp * A + a];
      }
      s_dvp[a] = pdv;
      s_dqp[a] = pdq;
    }
    cluster_sync();
    // the state's cotangent, assigned, with the next position's dcomb from
    // the next CTA at the tile's end
    for (int i = tid; i < rows; i += AB_THREADS) {
      const int t = t_lo + i;
      const float nxt = t + 1 >= T ? 0.0f
                        : i + 1 < tile ? s_dcb[i + 1]
                                       : cluster_peer(s_dcb, rank + 1)[0];
      const float dcb = s_dcb[i];
      dcum[rowT + t] = KIND == ATT_FWD_TRANS
                           ? (1.0f - tp) * dcb + round_to<CT>(tp * nxt)
                           : dcb + round_to<CT>(nxt);
    }
  } else {
    cluster_sync();
    s1 = 0.0f;
    for (int j = 0; j < cl; ++j) s1 += cluster_peer(s_s1, j)[0];
    for (int i = tid; i < tile; i += AB_THREADS)
      s_de[i] = s_w[i] * (s_de[i] - s1);
    __syncthreads();
    if constexpr (SUB) {
      // ends after its cluster barrier, the cum cotangent written
      att_bwd_ls_sub<CT>(s_lc, s_dz, s_p, s_dlcp, s_q, s_v, s_dvp, s_dqp,
                         s_de, s_cum, s_cum_lo,
                         reinterpret_cast<float*>(ab_smem + L.fam), mtb, dmt,
                         dcum, rowT, t_lo, rows, tile, T, A, K, ld, sub, rank,
                         cl);
    } else if constexpr (F32) {
      const float* lc_lo = s_lc + BAND_K * A;
      const int mtiles = tile / 16;
      // dz over (position, channel): loc = band(cum) @ lc in three TF32
      // passes, a warp per 8 channels down the tile, lc's fragments over
      // the 32 taps read once; nothing rounded
      for (int n0 = warp * 8; n0 < A; n0 += AB_WARPS * 8) {
        const int a = n0 + 2 * qd;
        const float q0 = s_q[a], q1 = s_q[a + 1], v0 = s_v[a],
                    v1 = s_v[a + 1];
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          band_frag_kn(bh[ks], s_lc, A, 8 * ks, n0, lane);
          band_frag_kn(bl[ks], lc_lo, A, 8 * ks, n0, lane);
        }
        float pdv0 = 0.0f, pdv1 = 0.0f, pdq0 = 0.0f, pdq1 = 0.0f;
        for (int mt = 0; mt < mtiles; ++mt) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t ah[4], al[4];
            band_frag_tf32(ah, s_cum + mt * 16 + 8 * ks, lane);
            band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, lane);
            mma_tf32x3(acc, ah, al, bh[ks], bl[ks]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = mt * 16 + g + 8 * h, t = t_lo + i;
            float dz0 = 0.0f, dz1 = 0.0f;
            if (t < T) {
              const size_t o = (rowT + t) * A + a;
              const float2 m2 = *reinterpret_cast<const float2*>(mtb + o);
              const float tz0 = band_energy_tanh<float>(acc[2 * h], q0, m2.x);
              const float tz1 =
                  band_energy_tanh<float>(acc[2 * h + 1], q1, m2.y);
              const float de = s_de[i];
              dz0 = de * v0 * (1.0f - tz0 * tz0);
              dz1 = de * v1 * (1.0f - tz1 * tz1);
              float2* pm = reinterpret_cast<float2*>(dmt + o);
              float2 old = *pm;
              old.x += dz0;
              old.y += dz1;
              *pm = old;
              pdv0 = fmaf(tz0, de, pdv0);
              pdv1 = fmaf(tz1, de, pdv1);
              pdq0 += dz0;
              pdq1 += dz1;
            }
            *reinterpret_cast<float2*>(s_dz + band_swz(i, a, A)) =
                make_float2(dz0, dz1);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          pdv0 += __shfl_xor_sync(0xffffffffu, pdv0, off);
          pdv1 += __shfl_xor_sync(0xffffffffu, pdv1, off);
          pdq0 += __shfl_xor_sync(0xffffffffu, pdq0, off);
          pdq1 += __shfl_xor_sync(0xffffffffu, pdq1, off);
        }
        if (g == 0) {
          s_dvp[a] = pdv0;
          s_dvp[a + 1] = pdv1;
          s_dqp[a] = pdq0;
          s_dqp[a + 1] = pdq1;
        }
      }
      __syncthreads();

      // P = dz @ lc^T, [tile][32]: a warp per 16 positions x 8 taps over
      // K = A, lc's "NK" fragments of two K steps by one ldmatrix
      for (int it = warp; it < mtiles * 4; it += AB_WARPS) {
        const int m0 = (it >> 2) * 16, n0 = (it & 3) * 8;
        float acc[2][4] = {};
        for (int kk = 0; kk < A; kk += 16) {
          uint32_t bh[4], bl[4];
          const int lc_at = band_swz(n0 + (lane & 7), kk + (lane >> 3) * 4, A);
          ldsm_x4(bh, s_lc + lc_at);
          ldsm_x4(bl, lc_lo + lc_at);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t ah[4], al[4];
            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8,
                                        kk + 8 * h + (lane >> 4) * 4, A));
            tf32_split<4>(ah, al, ah);
            mma_tf32x3(acc[h], ah, al, bh + 2 * h, bl + 2 * h);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_p[(m0 + g + 8 * (e >> 1)) * BAND_K + n0 + 2 * qd + (e & 1)] =
              acc[0][e] + acc[1][e];
      }
      __syncthreads();

      // dlc's partial band(cum)^T @ dz into lc's hi rows (read for the
      // last time above): a warp per 8 channels, both halves of the 32
      // taps, each 16-row tile's passes summed apart
      for (int n0 = warp * 8; n0 < A; n0 += AB_WARPS * 8) {
        float acc[2][4] = {};
        for (int mt = 0; mt < mtiles; ++mt) {
          float st[2][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int k0 = mt * 16 + 8 * ks;
            uint32_t bh[2], bl[2];
            band_frag_kn(bh, s_dz, A, k0, n0, lane);
            tf32_split<2>(bh, bl, bh);
#pragma unroll
            for (int kh = 0; kh < 2; ++kh) {
              uint32_t ah[4], al[4];
              band_frag_tf32(ah, s_cum + k0 + 16 * kh, lane);
              band_frag_tf32(al, s_cum_lo + k0 + 16 * kh, lane);
              mma_tf32x3(st[kh], ah, al, bh, bl);
            }
          }
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[kh][e] += st[kh][e];
        }
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_dlcp[(kh * 16 + g + 8 * (e >> 1)) * A + n0 + 2 * qd + (e & 1)] =
                acc[kh][e];
      }
    } else {
      // dz over (position, channel): the band product loc = band(cum) @
      // lc, a warp per 8 channels down the tile
      const int mtiles = tile / 16;
      for (int n0 = warp * 8; n0 < A; n0 += AB_WARPS * 8) {
        const int a = n0 + 2 * qd;
        const float q0 = s_q[a], q1 = s_q[a + 1], v0 = s_v[a],
                    v1 = s_v[a + 1];
        float pdv0 = 0.0f, pdv1 = 0.0f, pdq0 = 0.0f, pdq1 = 0.0f;
        for (int mt = 0; mt < mtiles; ++mt) {
          uint32_t af[2][4];
          band_frags(af, s_cum + mt * 16, lane);
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          band_loc(acc, af, s_lc, ld, n0, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = mt * 16 + g + 8 * h, t = t_lo + i;
            float dz0 = 0.0f, dz1 = 0.0f;
            if (t < T) {
              const size_t o = (rowT + t) * A + a;
              const __nv_bfloat162 m2 =
                  *reinterpret_cast<const __nv_bfloat162*>(mtb + o);
              const float tz0 =
                  band_energy_tanh(acc[2 * h], q0, __low2float(m2));
              const float tz1 =
                  band_energy_tanh(acc[2 * h + 1], q1, __high2float(m2));
              const float de = s_de[i];
              dz0 = de * v0 * (1.0f - tz0 * tz0);
              dz1 = de * v1 * (1.0f - tz1 * tz1);
              float2* pm = reinterpret_cast<float2*>(dmt + o);
              float2 old = *pm;
              old.x += dz0;
              old.y += dz1;
              *pm = old;
              pdv0 = fmaf(tz0, de, pdv0);
              pdv1 = fmaf(tz1, de, pdv1);
              pdq0 += dz0;
              pdq1 += dz1;
            }
            *reinterpret_cast<__nv_bfloat162*>(s_dz + i * ld + a) =
                __floats2bfloat162_rn(dz0, dz1);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          pdv0 += __shfl_xor_sync(0xffffffffu, pdv0, off);
          pdv1 += __shfl_xor_sync(0xffffffffu, pdv1, off);
          pdq0 += __shfl_xor_sync(0xffffffffu, pdq0, off);
          pdq1 += __shfl_xor_sync(0xffffffffu, pdq1, off);
        }
        if (g == 0) {
          s_dvp[a] = pdv0;
          s_dvp[a + 1] = pdv1;
          s_dqp[a] = pdq0;
          s_dqp[a + 1] = pdq1;
        }
      }
      __syncthreads();

      // dlc's partial band(cum)^T @ bf16(dz), a warp per 16 channels, both
      // halves of the 32 taps
      for (int n0 = warp * 16; n0 < A; n0 += AB_WARPS * 16) {
        float acc[2][2][4] = {};
        for (int mt = 0; mt < mtiles; ++mt)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
            band_dlc(acc[kh], s_cum + mt * 16 + kh * 16, s_dz + mt * 16 * ld,
                     ld, n0, lane);
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s_dlcp[(kh * 16 + g + 8 * (e >> 1)) * A + n0 + nt * 8 + 2 * qd +
                     (e & 1)] = acc[kh][nt][e];
      }
      // P = bf16(dz) @ lc^T, [tile][32]: a warp per 16 positions x 16 taps
      for (int it = warp; it < mtiles * 2; it += AB_WARPS) {
        const int mt = it >> 1, kh = it & 1;
        float acc[2][4] = {};
        band_p(acc, s_dz + mt * 16 * ld, s_lc, ld, kh * 16, A, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_p[(mt * 16 + g + 8 * (e >> 1)) * BAND_K + kh * 16 + nt * 8 +
                2 * qd + (e & 1)] = acc[nt][e];
      }
    }
    if constexpr (!SUB) {
      cluster_sync();
      // the cum cotangent of each own position: a diagonal of P, halo rows
      // from the neighbours, a lane per tap
      for (int i = warp; i < tile && t_lo + i < T; i += AB_WARPS) {
        const int t = t_lo + i;
        float part = 0.0f;
        const int t2 = t - lane + half;
        if (lane < K && t2 >= 0 && t2 < T) {
          const int r = t2 / tile;
          part = cluster_peer(s_p, r)[(t2 - r * tile) * BAND_K + lane];
        }
        part = warp_sum(part);
        if (lane == 0) dcum[rowT + t] += part;
      }
    }
    // this CTA's share of the row's dlc, partials in rank order
    for (int idx = rank * AB_THREADS + tid; idx < K * A;
         idx += cl * AB_THREADS) {
      float sum = 0.0f;
      for (int j = 0; j < cl; ++j) sum += cluster_peer(s_dlcp, j)[idx];
      dlc[(size_t)b * K * A + idx] += sum;
    }
  }
  // this CTA's share of the row's dv and dq, partials in rank order
  for (int a = rank * AB_THREADS + tid; a < A; a += cl * AB_THREADS) {
    float sv = 0.0f, sq = 0.0f;
    for (int j = 0; j < cl; ++j) {
      sv += cluster_peer(s_dvp, j)[a];
      sq += cluster_peer(s_dqp, j)[a];
    }
    dv[(size_t)b * A + a] += sv;
    dq_out[(size_t)b * A + a] = from_float<CT>(sq);
  }
  // no CTA leaves while its peers may still read its shared memory
  cluster_sync();
}

template <int KIND, class CT>
__global__ void __launch_bounds__(AB_THREADS) att_bwd_kernel(AB_PARAMS) {
  att_bwd_body<KIND, CT>(AB_ARGS);
}

// the forward family's instances, held to 64 registers, four CTAs an SM
// (74 to 78 and three without the bound: a step's 50 clusters of 8 then
// ran in two waves, 0.0287 against 0.0195 ms in bf16 on an H100, PERF.md)
template <int KIND, class CT>
__global__ void __launch_bounds__(AB_THREADS, 4)
    att_bwd_family_kernel(AB_PARAMS) {
  att_bwd_body<KIND, CT>(AB_ARGS);
}

// the kernel of att_bwd's instance <KIND, CT>
template <int KIND, class CT>
constexpr auto att_bwd_entry() {
  if constexpr (KIND == ATT_LS)
    return att_bwd_kernel<KIND, CT>;
  else
    return att_bwd_family_kernel<KIND, CT>;
}

// the sub-tiled layout's instances (long texts: AbLayout sub > 0), one CTA
// or two an SM at the tiles they run, the compiler's choice of registers
template <int KIND, class CT>
__global__ void __launch_bounds__(AB_THREADS) att_bwd_sub_kernel(AB_PARAMS) {
  att_bwd_body<KIND, CT, true>(AB_ARGS);
}

// the float32 band products' instance held to 64 registers, four CTAs an
// SM (80 and three without the bound)
template <>
__global__ void __launch_bounds__(AB_THREADS, 4)
    att_bwd_kernel<ATT_LS, float>(const float* __restrict__ q,
                                  const float* __restrict__ cum_s,
                                  const float* __restrict__ w_s,
                                  const float* __restrict__ memory,
                                  const float* __restrict__ mtb,
                                  const float* __restrict__ lc,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dctx,
                                  const float* __restrict__ dw_out,
                                  float* __restrict__ dcum,
                                  float* __restrict__ dmt,
                                  float* __restrict__ dlc,
                                  float* __restrict__ dv,
                                  float* __restrict__ dq_out,
                                  float* __restrict__ dctx_out, int T, int A,
                                  int Mem, int K, int tile, int cl, int sub,
                                  AbFam fa) {
  att_bwd_body<ATT_LS, float>(AB_ARGS);
}

// ---------------------------------------------------------------------------
// bwd_prenet: the prenet backward (ops/pallas_train_decoder.py:944-957),
// layers in reverse:
//   da = (out > 0) ? dx * scale : 0    -> the da stream (bf16); the
//                                         post-dropout output > 0 replays
//                                         both the ReLU and the dropout mask
//   dx = bf16(da) @ W^T                (W [in, out] as it lies: the [N, K]
//                                       operand of mma.sync, K = out = P)
// then the frame cotangent: dshift at a teacher step, the dframe carry
// otherwise.
//
// One launch: a thread-block cluster of `cl` CTAs for each BP_ROWS = 16
// rows (one mma tile of rows; 4 clusters at B=50, 32 CTAs).  CTA `rank`
// owns the columns [rank * np, rank * np + np) of P and [rank * n0,
// rank * n0 + n0) of the input frame's M (whole 8-column mma tiles:
// ops/fused_decoder.py::prenet_split, shared with the forward prenet).
// At the start it copies, with cp.async, its columns of dx_in and of every
// layer's output (the masks) and its rows of every layer's weight (W_l[i,
// :] for its columns i of the layer's input), so that all the copies are
// in flight at once and the weights' overlap the first mask.  Then, for each layer from the top:
// its columns of da (from dx_in for the top layer, from its own product's
// accumulators below) go to the da stream and, in bf16, to its shared
// slice; after a cluster barrier it gathers the full bf16 da rows from its
// peers' slices (16-byte reads of distributed shared memory, four in
// flight a thread) and computes its columns of dx = da @ W^T on mma.sync
// m16n8k16 with float32 sums.  Two slices alternate, so one barrier a
// layer suffices.  No float atomics: a run repeats bit for bit.
//
// In float32 the da rows, weights and masks are float32, the gather moves
// float32 rows, and dx = da @ W^T runs on mma.sync m16n8k8 TF32 in three
// passes through the forward prenet's routine (csrc/tile.cuh::
// tf32x3_kslices, W's rows read "NK" a word at a time): a warp per (n8
// tile, K slice), K split over the warps that the n8 tiles leave (a P x P
// layer's 4 tiles at np = 32 in two halves, layer 0's 2 tiles at n0 = 16
// in four quarters), so that all eight warps run at most 16 k-steps, each
// pass and k-step parity summed in its own accumulator (chains of at most
// 8 dependent mma.sync); da's and W's fragments split into their TF32
// halves in registers where they are read (a split copy of da would double
// s_a and cost the deepest prenet that fits one layer); each warp's 16 x 8
// partial goes to shared memory, and the partials are summed in K order
// before the epilogue.
//
// Bound on the H100: 2*B*(M*P + (n-1)*P*P) operations (8.6 M at B=50, two
// layers) and the weights, masks and cotangents once (0.35 MB), 0.10 us:
// what costs is latency, so each CTA reads only its slices of the weights
// (25 KB at the flagship's widths), all copies in flight at once, and a
// layer costs one cluster barrier, one gather and one 16-step mma chain.
// ---------------------------------------------------------------------------
constexpr int BP_ROWS = 16, BP_THREADS = 256, BP_WARPS = BP_THREADS / 32;

// shared-memory layout of bwd_prenet_kernel (byte offsets) for elements of
// `es` bytes; rows padded by 16 bytes (float32: a fragment's 32 words, rows
// g and columns t, in distinct banks); float32 adds the warps' K partials
struct BpLayout {
  int kp, ldw, ldo;
  size_t w, pre, dx, a, own, part, total;
  __host__ __device__ BpLayout(int P, int np, int n0, int n_layers, int es) {
    kp = (P + 31) / 32 * 32;   // K of every layer's product, zero-padded
    ldw = kp + 16 / es;        // elements a row of the weights and of da
    ldo = np + 16 / es;        // elements a row of a slice
    w = 0;
    pre = w + align16((size_t)(n0 + (n_layers - 1) * np) * ldw * es);
    dx = pre + align16((size_t)n_layers * BP_ROWS * ldo * es);
    a = dx + align16((size_t)BP_ROWS * np * 4);
    own = a + align16((size_t)BP_ROWS * ldw * es);
    part = own + 2 * align16((size_t)BP_ROWS * ldo * es);
    const int parts_p = tf32x3_splits(np, BP_WARPS) * np,
              parts_0 = tf32x3_splits(n0, BP_WARPS) * n0;
    const size_t parts = parts_p > parts_0 ? parts_p : parts_0;
    total = part + (es == 4 ? align16((size_t)BP_ROWS * parts * 4) : 0);
  }
};

template <class CT>
__global__ void __launch_bounds__(BP_THREADS)
bwd_prenet_kernel(const float* __restrict__ dx_in,
                  int dvec, const CT* __restrict__ pre_s,
                  long long pre_stride, int pvec,
                  const CT* __restrict__ w_all, int wvec,
                  CT* __restrict__ da_s, long long da_stride,
                  CT* __restrict__ dshift, float* __restrict__ dframe,
                  int teacher, int B, int in_dim, int P, int n_layers,
                  float scale, int cl, int np, int n0) {
  constexpr bool F32 = std::is_same<CT, float>::value;
  constexpr int V = 16 / sizeof(CT);   // elements a 16-byte chunk
  extern __shared__ __align__(16) uint8_t bp_smem[];
  const BpLayout L(P, np, n0, n_layers, sizeof(CT));
  const int ldw = L.ldw, ldo = L.ldo, kp = L.kp;
  CT* s_w = reinterpret_cast<CT*>(bp_smem + L.w);          // layers' rows
  CT* s_pre = reinterpret_cast<CT*>(bp_smem + L.pre);      // [n][ROWS][ldo]
  float* s_dx = reinterpret_cast<float*>(bp_smem + L.dx);  // [ROWS][np]
  CT* s_a = reinterpret_cast<CT*>(bp_smem + L.a);          // [ROWS][ldw]
  CT* s_own = reinterpret_cast<CT*>(bp_smem + L.own);      // 2 x [ROWS][ldo]
  // float32: the warps' K partials, [K slice][ROWS][n_l]
  float* s_part = reinterpret_cast<float*>(bp_smem + L.part);
  const size_t own_slot = align16((size_t)BP_ROWS * ldo * sizeof(CT)) /
                          sizeof(CT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int row0 = (blockIdx.x / cl) * BP_ROWS;
  const int mtiles = (min(BP_ROWS, B - row0) + 15) / 16;
  const int c_lo = rank * np;   // this CTA's columns of P

  // this CTA's columns of dx_in and of every layer's output, then its rows
  // of every layer's weight (layer 0: its n0 columns of the input frame),
  // zero outside the matrices
  for (int i = tid; i < BP_ROWS * np / 4; i += BP_THREADS) {
    const int r = i / (np / 4), c = (i % (np / 4)) * 4;
    const int row = row0 + r, col = c_lo + c, n = min(4, P - col);
    float* dst = s_dx + r * np + c;
    if (dvec) {
      const bool in = row < B && n > 0;
      cp_async16(dst, in ? dx_in + (size_t)row * P + col : dx_in,
                 in ? 4 * n : 0);
    } else {
      for (int q = 0; q < 4; ++q)
        dst[q] = row < B && q < n ? dx_in[(size_t)row * P + col + q] : 0.0f;
    }
  }
  const int chunks_o = np / V;
  for (int i = tid; i < n_layers * BP_ROWS * chunks_o; i += BP_THREADS) {
    const int l = i / (BP_ROWS * chunks_o), r = (i / chunks_o) % BP_ROWS;
    const int c = (i % chunks_o) * V;
    load16(s_pre + ((size_t)l * BP_ROWS + r) * ldo + c,
           pre_s + (size_t)l * pre_stride, P, row0 + r, c_lo + c, B, P, pvec);
  }
  cp_async_commit();
  const int chunks_k = kp / V;
  for (int l = 0, off = 0; l < n_layers; ++l) {
    const int n_l = l == 0 ? n0 : np, k_l = l == 0 ? in_dim : P;
    const CT* w_l =
        w_all + (l == 0 ? 0 : (size_t)in_dim * P + (size_t)(l - 1) * P * P);
    for (int i = tid; i < n_l * chunks_k; i += BP_THREADS) {
      const int r = i / chunks_k, k = (i % chunks_k) * V;
      load16(s_w + (size_t)(off + r) * ldw + k, w_l, P, rank * n_l + r, k,
             k_l, P, wvec);
    }
    off += n_l;
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the top layer's da: this CTA's columns from dx_in
  {
    const int l = n_layers - 1;
    for (int i = tid; i < BP_ROWS * np; i += BP_THREADS) {
      const int r = i / np, c = i % np, row = row0 + r, col = c_lo + c;
      float da = 0.0f;
      if (row < B && col < P) {
        const float out =
            to_float(s_pre[((size_t)l * BP_ROWS + r) * ldo + c]);
        da = out > 0.0f ? s_dx[r * np + c] * scale : 0.0f;
        da_s[l * da_stride + (size_t)row * P + col] = from_float<CT>(da);
      }
      s_own[(size_t)r * ldo + c] = from_float<CT>(da);
    }
  }

  for (int l = n_layers - 1; l >= 0; --l) {
    const CT* own = s_own + ((n_layers - 1 - l) & 1) * own_slot;
    CT* nxt = s_own + ((n_layers - l) & 1) * own_slot;
    // every slice of this layer's da is written: gather the full rows
    cluster_sync();
    cluster_gather_rows(s_a, ldw, own, ldo, np, cl, mtiles * 16, kp,
                        BP_THREADS);
    if (l == n_layers - 1) cp_async_wait<0>();   // the weights
    __syncthreads();

    // this CTA's columns of dx = da @ W_l^T
    const int n_l = l == 0 ? n0 : np, k_l = l == 0 ? in_dim : P;
    const int col0 = rank * n_l;
    const CT* w_l = s_w + (size_t)(l == 0 ? 0 : n0 + (l - 1) * np) * ldw;
    // output (r, c) of this CTA's columns from its sum
    auto finish = [&](int r, int c, float acc) {
      const int row = row0 + r, col = col0 + c;
      const bool in = row < B && col < k_l;
      if (l > 0) {
        // the next layer down's da, its columns of P
        float da = 0.0f;
        if (in) {
          const float out =
              to_float(s_pre[((size_t)(l - 1) * BP_ROWS + r) * ldo + c]);
          da = out > 0.0f ? acc * scale : 0.0f;
          da_s[(l - 1) * da_stride + (size_t)row * P + col] =
              from_float<CT>(da);
        }
        nxt[(size_t)r * ldo + c] = from_float<CT>(da);
      } else if (in) {
        const size_t o = (size_t)row * in_dim + col;
        dshift[o] = from_float<CT>(teacher ? acc : 0.0f);
        dframe[o] = teacher ? 0.0f : acc;
      }
    };
    if constexpr (F32) {
      // a warp per (n8 tile, K slice) of the 16 rows in three TF32 passes
      // over the "NK" weight rows (csrc/tile.cuh), then the warps'
      // partials in K order
      tf32x3_kslices<false>(s_part, s_a, ldw, w_l, ldw, n_l, kp, warp,
                            BP_WARPS, lane);
      __syncthreads();
      for (int o = tid; o < BP_ROWS * n_l; o += BP_THREADS)
        finish(o / n_l, o % n_l, tf32x3_kslice_sum(s_part, n_l, BP_WARPS, o));
    } else {
      // a warp per (m tile, n8 tile), mma.sync
      for (int pair = warp; pair < mtiles * (n_l / 8); pair += BP_WARPS) {
        const int mt = pair / (n_l / 8), nt = pair % (n_l / 8);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kk = 0; kk < kp; kk += 32) {
          uint32_t a0[4], a1[4], bw[4];
          const bf16* ar = s_a + (size_t)(mt * 16 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8) * ldw +
                           kk + (lane >> 4) * 8;
          ldsm_x4(a0, ar);
          ldsm_x4(a1, ar + 16);
          ldsm_x4(bw, w_l + (size_t)(nt * 8 + (lane & 7)) * ldw + kk +
                          (lane >> 3) * 8);
          mma_bf16(acc, a0, bw);
          mma_bf16(acc, a1, bw + 2);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          finish(mt * 16 + g + 8 * (e >> 1), nt * 8 + 2 * qd + (e & 1),
                 acc[e]);
      }
    }
  }
  // no CTA leaves while its peers may still read its shared memory
  cluster_sync();
}

// ---------------------------------------------------------------------------
// the launches of both instances, behind the launchers below
// ---------------------------------------------------------------------------

// a product of either instance: A [M, K] (a_km: [K, M]) @ B (b_kn: [K, N],
// else [N, K]), the epilogue epi
template <class Epi>
int product_launch(const void* a, int lda, int a_km, const void* b, int ldb,
                   int b_kn, int M, int N, int K, int slices, int kslice,
                   void* scratch, const Epi& epi, int f32, void* stream) {
  if (a_km && !b_kn) return (int)cudaErrorInvalidValue;
  if (f32) {
    if (a_km)
      return splitk_f32_launch<true, true>(a, lda, b, ldb, M, N, K, slices,
                                           kslice, scratch, epi, stream);
    if (b_kn)
      return splitk_f32_launch<false, true>(a, lda, b, ldb, M, N, K, slices,
                                            kslice, scratch, epi, stream);
    return splitk_f32_launch<false, false>(a, lda, b, ldb, M, N, K, slices,
                                           kslice, scratch, epi, stream);
  }
  if (a_km)
    return splitk_launch<true, true>(a, lda, b, ldb, M, N, K, slices, kslice,
                                     scratch, epi, stream);
  if (b_kn)
    return splitk_launch<false, true>(a, lda, b, ldb, M, N, K, slices,
                                      kslice, scratch, epi, stream);
  return splitk_launch<false, false>(a, lda, b, ldb, M, N, K, slices, kslice,
                                     scratch, epi, stream);
}

// the launch of train_attention_kernel<KIND, CT> over B rows
template <int KIND, class CT>
int train_attention_run(const void* q, void* cum, const void* memory,
                        const void* mtb, const void* mask_add, const void* lc,
                        const void* v, void* w_out, void* cum_out, void* ctx,
                        void* dst0, int ld0, void* dst1, int ld1, void* dst2,
                        int ld2, int B, int T, int A, int Mem, int K,
                        int tile, int cl, const TaAgent& ag, void* stream) {
  constexpr int es = sizeof(CT);
  const int ag_floats =
      KIND == ATT_FWD_TRANS ? ta_agent_floats(Mem, ag.H, ag.P, cl) : 0;
  const int stage = ta_stage(tile, A, Mem, es, KIND == ATT_LS, ag_floats);
  const TaLayout L(tile, A, Mem, es, stage, KIND == ATT_LS, ag_floats);
  const int vec = (uintptr_t)memory % 16 == 0 &&
                  ((long long)T * Mem) % (16 / es) == 0;
  return (int)launch_cluster(
      train_attention_kernel<KIND, CT>, B * cl, TA_THREADS, L.total, cl,
      (cudaStream_t)stream, (const float*)q, (float*)cum, (const CT*)memory,
      (const CT*)mtb, (const float*)mask_add, (const CT*)lc, (const float*)v,
      (float*)w_out, (CT*)cum_out, (float*)ctx, (CT*)dst0, ld0, (CT*)dst1,
      ld1, (CT*)dst2, ld2, T, A, Mem, K, tile, cl, vec, stage, ag);
}

// the launch of bwd_head_kernel<CT> over B rows
template <class CT>
int bwd_head_run(const void* dspec, const void* dstop, const void* dframe,
                 const void* w, int ldw, void* da_frame, const void* dh_gen,
                 const void* dctx, void* dh_gen_tot, void* dctx_tot, int B,
                 int M, int Mem, const CellBwd<CT>& cell, void* stream) {
  constexpr int es = sizeof(CT);
  const int H = cell.H;
  const int kp = (M + 15) / 16 * 16;
  const bool dvec = M % 4 == 0 && (uintptr_t)dspec % 16 == 0 &&
                    (uintptr_t)dframe % 16 == 0;
  const size_t smem =
      bwd_head_smem(kp, es) + (cell.act != nullptr ? bh_cell_smem(es) : 0);
  // the cell's operands with cp.async: 16-byte aligned rows
  const int cvec = (uintptr_t)cell.act % 16 == 0 &&
                   (uintptr_t)cell.c_prev % 16 == 0 &&
                   (uintptr_t)cell.dc % 16 == 0 && H % 8 == 0;
  const int wvec = vec_ok(w, ldw, es);
  cudaError_t err = allow_smem(bwd_head_kernel<CT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + Mem + BH_BN - 1) / BH_BN, (B + BH_BM - 1) / BH_BM);
  bwd_head_kernel<CT><<<grid, BH_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)dspec, (const float*)dstop, (const float*)dframe,
      (const CT*)w, ldw, wvec, dvec, (CT*)da_frame, (const float*)dh_gen,
      (const float*)dctx, (float*)dh_gen_tot, (float*)dctx_tot, B, M, kp, H,
      Mem, cell, cvec);
  return (int)cudaGetLastError();
}

// the launch of att_bwd's instance <KIND, CT> over B rows, in the single
// tile's layout (sub 0) or the sub-tiled one (sub > 0); a layout that does
// not fit a CTA's shared memory is refused
template <int KIND, class CT>
int att_bwd_run(const void* q, const void* cum_s, const void* w_s,
                const void* memory, const void* mtb, const void* lc,
                const void* v, const void* dctx, const void* dw_out,
                void* dcum, void* dmt, void* dlc, void* dv, void* dq_out,
                void* dctx_out, int B, int T, int A, int Mem, int K, int tile,
                int cl, int sub, const AbFam& fa, void* stream) {
  const AbLayout L(tile, A, Mem, KIND != ATT_LS, sizeof(CT), sub);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(
      sub > 0 ? &att_bwd_sub_kernel<KIND, CT> : att_bwd_entry<KIND, CT>(),
      B * cl, AB_THREADS, L.total, cl, (cudaStream_t)stream, (const float*)q,
      (const CT*)cum_s, (const float*)w_s, (const CT*)memory, (const CT*)mtb,
      (const CT*)lc, (const float*)v, (const float*)dctx,
      (const float*)dw_out, (float*)dcum, (float*)dmt, (float*)dlc,
      (float*)dv, (CT*)dq_out, (CT*)dctx_out, T, A, Mem, K, tile, cl, sub,
      fa);
}

}  // namespace

extern "C" {

// Every launcher takes the compute type as `f32` (1: float32 operands and
// streams, the float32 instances; 0: bfloat16) just before the stream.

// the columns of P in `cl` shares of np (prenet_split); the input is
// shifted (compute type) at a teacher step, the float32 frame carry
// otherwise; x_out (null, or [B, P] float32) also receives the last layer's
// output
int train_prenet_launch(const void* shifted, const void* frame, int teacher,
                        const void* w_all, const void* b_all, void* raw_out,
                        void* pre_out, long long pre_stride, void* dst,
                        int ld_dst, void* x_out, int B, int in_dim, int P,
                        int n_layers,
                        unsigned seed0, unsigned seed1, unsigned salt0,
                        unsigned thresh, float scale, int apply_dropout,
                        int cl, int np, int f32, void* stream) {
  const PrenetArgs args{w_all, (const float*)b_all, B, in_dim, P, n_layers,
                        seed0, seed1, salt0, thresh, scale, apply_dropout,
                        cl, np};
  const void* x = teacher ? shifted : frame;
  if (f32) {
    const TrainPrenetOut<float> epi{(float*)raw_out, (float*)pre_out,
                                    pre_stride, (float*)dst, ld_dst,
                                    (float*)x_out, in_dim, P, n_layers};
    return (int)prenet_tile_launch<TrainPrenetOut<float>, float>(
        x, 0, args, epi, (cudaStream_t)stream);
  }
  const TrainPrenetOut<bf16> epi{(bf16*)raw_out, (bf16*)pre_out, pre_stride,
                                 (bf16*)dst, ld_dst, (float*)x_out, in_dim, P,
                                 n_layers};
  return (int)prenet_tile_launch(x, teacher ? 1 : 0, args, epi,
                                 (cudaStream_t)stream);
}

// row [B, K] (rows of ld_row elements) and w [4H, K], K of whole 16-byte
// chunks, both 16-byte aligned
int gate_lstm_launch(const void* row, int ld_row, const void* w, int K,
                     const void* bias, int B, int H, void* h, void* c,
                     void* act, void* c_out, void* h_dst0, int ld0,
                     void* h_dst1, int ld1, unsigned seed0, unsigned seed1,
                     unsigned salt_h, unsigned salt_c, unsigned th_h,
                     unsigned th_c, int mode, float scale, float zh, float zc,
                     int f32, void* stream) {
  const Reg reg{seed0, seed1, salt_h, salt_c, th_h, th_c, mode, scale, zh, zc};
  if (f32) {
    const LstmEpi<float> epi{(const float*)bias, (float*)h, (float*)c,
                             (float*)act, (float*)c_out, (float*)h_dst0, ld0,
                             (float*)h_dst1, ld1, H, reg};
    return (int)gate_tile_launch<float>(row, 4 * ld_row, w, 4 * K, 4 * K, B,
                                        H, epi, (cudaStream_t)stream);
  }
  const LstmEpi<bf16> epi{(const float*)bias, (float*)h, (float*)c,
                          (bf16*)act, (bf16*)c_out, (bf16*)h_dst0, ld0,
                          (bf16*)h_dst1, ld1, H, reg};
  return (int)gate_tile_launch<bf16>(row, 2 * ld_row, w, 2 * K, 2 * K, B, H,
                                      epi, (cudaStream_t)stream);
}

// q [B, A] = round(h @ Wq), h [B, H] (rows of ld_h), Wq [H, A]
int query_launch(const void* h, int ld_h, const void* wq, int B, int H, int A,
                 void* q_out, int slices, int kslice, void* scratch, int f32,
                 void* stream) {
  if (f32)
    return splitk_f32_launch<false, true>(h, ld_h, wq, A, B, A, H, slices,
                                          kslice, scratch,
                                          RoundOut<float>{(float*)q_out, A},
                                          stream);
  return splitk_launch<false, true>(h, ld_h, wq, A, B, A, H, slices, kslice,
                                    scratch, RoundOut<bf16>{(float*)q_out, A},
                                    stream);
}

// row [B, K] (rows of ld_row) against the head weight [N, K]
int head_launch(const void* row, int ld_row, const void* w, int K,
                const void* bias, int B, int N, void* spec, void* frame,
                void* stop, int slices, int kslice, void* scratch, int f32,
                void* stream) {
  const HeadOut epi{(const float*)bias, (float*)spec, (float*)frame,
                    (float*)stop, N};
  if (f32)
    return splitk_f32_launch<false, false>(row, ld_row, w, K, B, N, K, slices,
                                           kslice, scratch, epi, stream);
  return splitk_launch<false, false>(row, ld_row, w, K, B, N, K, slices,
                                     kslice, scratch, epi, stream);
}

// out segments of A @ B.  a_km: A is [K, M] (m contiguous); b_kn: B is
// [K, N] (n contiguous), else [N, K].  Unused segments have a null out.
int bwd_gemm_launch(const void* a, int lda, int a_km, const void* b, int ldb,
                    int b_kn, int M, int N, int K, int slices, int kslice,
                    void* scratch, int lo0, int hi0, void* out0, int ldo0,
                    const void* add0, int lda0, int lo1, int hi1, void* out1,
                    int ldo1, const void* add1, int lda1, int lo2, int hi2,
                    void* out2, int ldo2, const void* add2, int lda2, int f32,
                    void* stream) {
  const SegOut epi{{lo0, lo1, lo2}, {hi0, hi1, hi2}, {ldo0, ldo1, ldo2},
                   {lda0, lda1, lda2},
                   {(float*)out0, (float*)out1, (float*)out2},
                   {(const float*)add0, (const float*)add1,
                    (const float*)add2}};
  return product_launch(a, lda, a_km, b, ldb, b_kn, M, N, K, slices, kslice,
                        scratch, epi, f32, stream);
}

// the row's positions in `cl` tiles of `tile` (att_bwd_tiles); A a multiple
// of 16, K <= 32 taps, mtb and lc 16-byte aligned
int train_attention_launch(const void* q, void* cum, const void* memory,
                           const void* mtb, const void* mask_add,
                           const void* lc, const void* v, void* w_out,
                           void* cum_out, void* ctx, void* dst0, int ld0,
                           void* dst1, int ld1, void* dst2, int ld2, int B,
                           int T, int A, int Mem, int K, int tile, int cl,
                           int f32, void* stream) {
  if (B <= 0 || T <= 0 || A <= 0 || A % 16 != 0 || Mem <= 0 || K < 1 ||
      K > BAND_K || tile <= 0 || tile % 16 != 0 || cl < 1 || cl > 8 ||
      (long long)cl * tile < T || (long long)(cl - 1) * tile >= T ||
      (uintptr_t)mtb % 16 != 0 || (uintptr_t)lc % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (f32 ? train_attention_run<ATT_LS, float>
              : train_attention_run<ATT_LS, bf16>)(
      q, cum, memory, mtb, mask_add, lc, v, w_out, cum_out, ctx, dst0, ld0,
      dst1, ld1, dst2, ld2, B, T, A, Mem, K, tile, cl, TaAgent{}, stream);
}

// the forward family's step (trans = 1: with the transition agent, whose
// tp carry [B] is updated in place, tp_out [B] a stream or null, h_att
// [B, H] and x [B, P] float32, w [Mem + H + P] and bias [1] float32); cum
// holds the last step's weights and receives the new ones; the rest as
// train_attention_launch's
int train_fwd_attention_launch(const void* q, void* cum, const void* memory,
                               const void* mtb, const void* mask_add,
                               const void* v, void* w_out, void* cum_out,
                               void* ctx, void* dst0, int ld0, void* dst1,
                               int ld1, void* dst2, int ld2, void* tp,
                               void* tp_out, const void* h_att,
                               const void* x, const void* w,
                               const void* bias, int B, int T, int A,
                               int Mem, int H, int P, int tile, int cl,
                               int trans, int f32, void* stream) {
  if (B <= 0 || T <= 0 || A <= 0 || A % 16 != 0 || Mem <= 0 || tile <= 0 ||
      tile % 16 != 0 || cl < 1 || cl > 8 || (long long)cl * tile < T ||
      (long long)(cl - 1) * tile >= T || (uintptr_t)mtb % 16 != 0 ||
      (trans && (tp == nullptr || h_att == nullptr || x == nullptr ||
                 w == nullptr || bias == nullptr || H <= 0 || P <= 0)))
    return (int)cudaErrorInvalidValue;
  const TaAgent ag{(float*)tp, (float*)tp_out, (const float*)h_att,
                   (const float*)x, (const float*)w, (const float*)bias, H,
                   P};
  auto run = trans ? (f32 ? train_attention_run<ATT_FWD_TRANS, float>
                          : train_attention_run<ATT_FWD_TRANS, bf16>)
                   : (f32 ? train_attention_run<ATT_FWD, float>
                          : train_attention_run<ATT_FWD, bf16>);
  return run(q, cum, memory, mtb, mask_add, nullptr, v, w_out, cum_out, ctx,
             dst0, ld0, dst1, ld1, dst2, ld2, B, T, A, Mem, 1, tile, cl, ag,
             stream);
}

// the LSTM cell backward's arguments, in the launchers' order: act, c_prev
// (null at the first step), dc, dg, dh_reg, H, then the regularization;
// mode 3 (an eval forward's) has no backward
#define CELL_PARAMS                                                         \
  const void *act, const void *c_prev, void *dc, void *dg, void *dh_reg,   \
      int H, unsigned seed0, unsigned seed1, unsigned salt_h,              \
      unsigned salt_c, unsigned th_h, unsigned th_c, int mode, float scale, \
      float zh, float zc
#define CELL_ARGS(CT)                                                      \
  CellBwd<CT> {                                                            \
    (const CT*)act, (const CT*)c_prev, (float*)dc, (CT*)dg, (float*)dh_reg, \
        H, Reg{seed0, seed1, salt_h, salt_c, th_h, th_c, mode, scale, zh,  \
               zc}                                                         \
  }

// with act not null, the generator cell's backward runs in the epilogue and
// dh_gen_tot may be null; with act null, the cell's other arguments are
// ignored
int bwd_head_launch(const void* dspec, const void* dstop, const void* dframe,
                    const void* w, int ldw, void* da_frame,
                    const void* dh_gen, const void* dctx, void* dh_gen_tot,
                    void* dctx_tot, int B, int M, int Mem, CELL_PARAMS,
                    int f32, void* stream) {
  if (B <= 0 || M <= 0 || ldw < H + Mem ||
      (act != nullptr ? mode == 3 : dh_gen_tot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return bwd_head_run(dspec, dstop, dframe, w, ldw, da_frame, dh_gen, dctx,
                        dh_gen_tot, dctx_tot, B, M, Mem, CELL_ARGS(float),
                        stream);
  return bwd_head_run(dspec, dstop, dframe, w, ldw, da_frame, dh_gen, dctx,
                      dh_gen_tot, dctx_tot, B, M, Mem, CELL_ARGS(bf16),
                      stream);
}

int bwd_cell_launch(const void* dh_tot, int B, CELL_PARAMS, int f32,
                    void* stream) {
  if (B <= 0 || H <= 0 || mode == 3) return (int)cudaErrorInvalidValue;
  const int n = B * H;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    bwd_cell_kernel<float><<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)dh_tot, B, CELL_ARGS(float));
  else
    bwd_cell_kernel<bf16><<<(n + 255) / 256, 256, 0, st>>>(
        (const float*)dh_tot, B, CELL_ARGS(bf16));
  return (int)cudaGetLastError();
}

// A [M, K] @ B (b_kn: [K, N], else [N, K]) with N = H, then the attention
// cell's backward on dh_tot = add + the product (CellOut)
int bwd_gemm_cell_launch(const void* a, int lda, const void* b, int ldb,
                         int b_kn, int M, int K, int slices, int kslice,
                         void* scratch, const void* add, int ldadd,
                         CELL_PARAMS, int f32, void* stream) {
  if (add == nullptr || mode == 3) return (int)cudaErrorInvalidValue;
  if (f32)
    return product_launch(a, lda, 0, b, ldb, b_kn, M, H, K, slices, kslice,
                          scratch,
                          CellOut<float>{(const float*)add, ldadd,
                                         CELL_ARGS(float)},
                          1, stream);
  return product_launch(a, lda, 0, b, ldb, b_kn, M, H, K, slices, kslice,
                        scratch,
                        CellOut<bf16>{(const float*)add, ldadd,
                                      CELL_ARGS(bf16)},
                        0, stream);
}

// the bytes of shared memory of att_bwd's layout at a tile of `tile`
// positions (AbLayout; sub 0: the single tile, sub > 0: sub-tiles of that
// many positions), for the forward family (family = 1) or the
// location-sensitive kind, float32 (f32 = 1) or bf16 compute: the Python
// planner's mirror (ops/fused_train_decoder.py::att_bwd_smem_bytes) is
// held to it
long long att_bwd_smem_bytes(int tile, int A, int Mem, int family, int f32,
                             int sub) {
  return (long long)AbLayout(tile, A, Mem, family != 0, f32 ? 4 : 2, sub)
      .total;
}

// the row's positions in `cl` tiles of `tile` (a multiple of 16; cl <= 8,
// the last tile not empty), walked in sub-tiles of `sub` positions (a
// multiple of 16) or whole (sub 0); A a multiple of 16, K <= 32 taps; mtb
// aligned to two elements, dmt to two floats, and in float32 lc to 16
// bytes
int att_bwd_launch(const void* q, const void* cum_s, const void* w_s,
                   const void* memory, const void* mtb, const void* lc,
                   const void* v, const void* dctx, const void* dw_out,
                   void* dcum, void* dmt, void* dlc, void* dv, void* dq_out,
                   void* dctx_out, int B, int T, int A, int Mem, int K,
                   int tile, int cl, int sub, int f32, void* stream) {
  if (B <= 0 || T <= 0 || A <= 0 || A % 16 != 0 || Mem <= 0 || K < 1 ||
      K > BAND_K || tile <= 0 || tile % 16 != 0 || cl < 1 || cl > 8 ||
      (long long)cl * tile < T || (long long)(cl - 1) * tile >= T ||
      sub < 0 || sub % 16 != 0 ||
      (uintptr_t)mtb % (f32 ? 8 : 4) != 0 || (uintptr_t)dmt % 8 != 0 ||
      (f32 && (uintptr_t)lc % 16 != 0))
    return (int)cudaErrorInvalidValue;
  return (f32 ? att_bwd_run<ATT_LS, float> : att_bwd_run<ATT_LS, bf16>)(
      q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out, dcum, dmt, dlc, dv,
      dq_out, dctx_out, B, T, A, Mem, K, tile, cl, sub, AbFam{}, stream);
}

// the forward family's attention backward: dcum [B, T] the state's
// cotangent (replaced), mask_add [B, T], A even, mtb aligned to two
// elements and dmt to two floats; with the transition agent
// (trans = 1) tp_prev and tp [B] (float32 streams), the dtp carry [B]
// (replaced), the dlin stream [B], the agent's weight w [Mem + H + P], the
// attention LSTM's dh_att [B, H] (added to) and the prenet output's dx
// [B, P] (written), all float32; the rest as att_bwd_launch's, without lc
// and dlc
int fwd_att_bwd_launch(const void* q, const void* cum_s, const void* w_s,
                       const void* memory, const void* mtb,
                       const void* mask_add, const void* v, const void* dctx,
                       const void* dw_out, void* dcum, void* dmt, void* dv,
                       void* dq_out, void* dctx_out, const void* tp_prev,
                       const void* tp, void* dtp, void* dlin, const void* w,
                       void* dh_att, void* dx, int B, int T, int A, int Mem,
                       int H, int P, int tile, int cl, int sub, int trans,
                       int f32, void* stream) {
  if (B <= 0 || T <= 0 || A <= 0 || A % 2 != 0 || Mem <= 0 || tile <= 0 ||
      tile % 16 != 0 || cl < 1 || cl > 8 || (long long)cl * tile < T ||
      (long long)(cl - 1) * tile >= T || sub < 0 || sub % 16 != 0 ||
      (uintptr_t)mtb % 4 != 0 ||
      (uintptr_t)dmt % 8 != 0 || mask_add == nullptr ||
      (trans && (tp_prev == nullptr || tp == nullptr || dtp == nullptr ||
                 dlin == nullptr || w == nullptr || dh_att == nullptr ||
                 dx == nullptr || H <= 0 || P <= 0)))
    return (int)cudaErrorInvalidValue;
  const AbFam fa{(const float*)mask_add, (const float*)tp_prev,
                 (const float*)tp, (float*)dtp, (float*)dlin,
                 (const float*)w, (float*)dh_att, (float*)dx, H, P};
  auto run = trans ? (f32 ? att_bwd_run<ATT_FWD_TRANS, float>
                          : att_bwd_run<ATT_FWD_TRANS, bf16>)
                   : (f32 ? att_bwd_run<ATT_FWD, float>
                          : att_bwd_run<ATT_FWD, bf16>);
  return run(q, cum_s, w_s, memory, mtb, nullptr, v, dctx, dw_out, dcum, dmt,
             nullptr, dv, dq_out, dctx_out, B, T, A, Mem, 1, tile, cl, sub,
             fa, stream);
}

// the columns of P and of the input frame in `cl` shares of np and n0
// (prenet_split); every layer's weight rows must fit in shared memory
int bwd_prenet_launch(const void* dx, const void* pre_s, long long pre_stride,
                      const void* w_all, void* da_s, long long da_stride,
                      void* dshift, void* dframe, int teacher, int B,
                      int in_dim, int P, int n_layers, float scale, int cl,
                      int np, int n0, int f32, void* stream) {
  if (B <= 0 || in_dim <= 0 || P <= 0 || n_layers < 1 || cl < 1 || cl > 8 ||
      np <= 0 || np % 8 != 0 || n0 <= 0 || n0 % 8 != 0 ||
      (long long)cl * np < P || (long long)cl * n0 < in_dim)
    return (int)cudaErrorInvalidValue;
  const int es = f32 ? 4 : 2, V = 16 / es;
  const BpLayout L(P, np, n0, n_layers, es);
  const int dvec = (uintptr_t)dx % 16 == 0 && P % 4 == 0;
  const int pvec = (uintptr_t)pre_s % 16 == 0 && P % V == 0 &&
                   pre_stride % V == 0;
  const int wvec = (uintptr_t)w_all % 16 == 0 && P % V == 0;
  const int grid = (B + BP_ROWS - 1) / BP_ROWS * cl;
  const cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return (int)launch_cluster(
        bwd_prenet_kernel<float>, grid, BP_THREADS, L.total, cl, st,
        (const float*)dx, dvec, (const float*)pre_s, pre_stride, pvec,
        (const float*)w_all, wvec, (float*)da_s, da_stride, (float*)dshift,
        (float*)dframe, teacher, B, in_dim, P, n_layers, scale, cl, np, n0);
  return (int)launch_cluster(
      bwd_prenet_kernel<bf16>, grid, BP_THREADS, L.total, cl, st,
      (const float*)dx, dvec, (const bf16*)pre_s, pre_stride, pvec,
      (const bf16*)w_all, wvec, (bf16*)da_s, da_stride, (bf16*)dshift,
      (float*)dframe, teacher, B, in_dim, P, n_layers, scale, cl, np, n0);
}

}  // extern "C"
