#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s checks, or time one kernel, on changed copies of
the PyTorch port's CUDA sources, on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py faults [NAME ...]
    python3 tools/torch_kernel_variants.py checks train_attention_taps
    python3 tools/torch_kernel_variants.py checks tf32x3_in_place
    python3 tools/torch_kernel_variants.py time lsa_l2_prefetch att_bwd_l2_prefetch
    python3 tools/torch_kernel_variants.py time bwd_head_cols_32 att_bwd_f32_split_in_registers band_swz_off
    python3 tools/torch_kernel_variants.py time train_attention_taps
    python3 tools/torch_kernel_variants.py time gate_f32_cluster_1 gate_f32_cluster_4 gate_rows_halved gate_f32_stage_128
    python3 tools/torch_kernel_variants.py time prenet_not_wide bwd_prenet_f32_one_chain
    python3 tools/torch_kernel_variants.py --root PARENT time train_prenet_f32_no_product att_bwd_fwd_no_dz att_bwd_fwd_no_energy att_bwd_fwd_one_exchange
    python3 tools/torch_kernel_variants.py ab --base PARENT prenet K3fam K3
    python3 tools/torch_kernel_variants.py --root PARENT time train_attention_fam_no_sum_exchange train_attention_fam_no_agent_tail train_attention_fam_floor lsa_f32_no_band lsa_f32_no_query lsa_f32_no_products
    python3 tools/torch_kernel_variants.py time train_attention_fam_cluster_barriers
    python3 tools/torch_kernel_variants.py checks train_attention_fam_cluster_barriers_checks train_attention_fam_exit_probe
    python3 tools/torch_kernel_variants.py ab --base PARENT K2fam K1f32 K2 K1
    python3 tools/torch_kernel_variants.py --root PARENT time lsa_streams_in_smem fwd_no_agent_tail lsa_one_reduction_fewer lsa_step0_all
    python3 tools/torch_kernel_variants.py time lsa_flagship_staged
    python3 tools/torch_kernel_variants.py checks lsa_flagship_staged_checks
    python3 tools/torch_kernel_variants.py ab --base PARENT K1q8 K1fam
    python3 tools/torch_kernel_variants.py --root PARENT time f32fam_no_energy f32fam_no_tanh f32fam_one_reduction_fewer f32fam_no_ctx f32fam_no_agent_tail f32fam_floor cell_no_tanh
    python3 tools/torch_kernel_variants.py time f32fam_new_no_energy f32fam_new_no_ctx f32fam_l2_prefetch f32fam_l2_prefetch_mt f32fam_l2_prefetch_mt_late f32fam_unroll_16 f32fam_ctx_batch_16 f32fam_ctx_batch_4
    python3 tools/torch_kernel_variants.py ab --base PARENT K1f32 K1f32fam K1f32fam548 K3cell K1

Each variant copies ``multilingual_text_to_speech_tpu_torch`` under the
ignored ``build/variants/<name>/``, replaces pieces of a ``csrc`` source
there (each must occur exactly once), and runs in a fresh process that
imports the copy before the checkout's own package, so the kernels build
from the changed source into the copy's own build directory.

``faults`` plants one fault at a time: a wrong location-conv tap (K1's
``lsa_attention``; K2's ``train_attention``; K3's ``att_bwd``, in its cum
gradient and in its filter gradient), a dropped ReLU/dropout mask in one
layer of K3's ``bwd_prenet``, or, in the forward prenet routine that K1's
``prenet`` and K2's ``train_prenet`` share (``csrc/tile.cuh``), a dropout
mask drawn at the CTA's local column instead of the global one or one
peer's slice skipped in the gather of the bf16 rows (each run under K1's
checks and under K2's), or, in K3's LSTM cell backward (which runs fused
into ``bwd_head`` and the dq @ Wq^T product), the cell-state zoneout mask
drawn with the h salt or the attention cell run on each split-K slice's
partial sum instead of the reduced one, or, in the forward-attention
family's kernels, the 1e-6 floor given to K1's own padding of the text
length, K3's recurrence replayed with the step's own t_prob instead of
the previous step's, or K3's state cotangent added to instead of assigned
(each under its attention kind's phase), or, in K1's float32 and
int8-stream instances, the float32 gate product (``csrc/tile.cuh``, three
TF32 passes) run in one pass, the W8A8 row rounded to bf16 before a
float32 decoder quantizes it, or the last bytes of each int8 memory row
that is not a multiple of 16 bytes (292, 548) left out of the context, or,
in K2's and K3's float32 instances (one fault in each), the float32
products on the tensor cores (the gate routine's cluster leaving its last
CTA's partial tile out of the sum; the split-K routine in one TF32 pass,
or reading the second word of its transposed fragments 4 k-rows off), an
operand of a small float32 product rounded to bf16 (the prenet's,
``bwd_head``'s and ``bwd_prenet``'s), a float32 stream stored in bf16 (the
LSTM activations, the cells' gate gradients, ``att_bwd``'s dz, the
family's energy terms and shifted weights) or the last chunk of each
float32 memory row left out of the context; and in K3's float32 head
backward and attention-backward band products on the tensor cores, each
product in one TF32 pass (``bwd_head``; ``att_bwd``'s loc, P and dlc),
the Hankel fragment of cum one tap off, a swizzled "KN" fragment's second
word read from its first row, one cluster rank's dlc partial left out, or
lc's TF32 lo halves dropped; and in K2's float32 location conv and K3's
float32 prenet backward on the tensor cores, each product in one TF32
pass, train_attention's Hankel fragment one tap off, lc's or da's TF32 lo
halves dropped, one warp's partial energy or one K slice's partial of
``bwd_prenet`` left out of its sum; and in the float32 forward prenet's
products (``csrc/tile.cuh::tf32x3_kslices``, shared with ``bwd_prenet``)
one TF32 pass, one K slice's partial left out of the sum or the weights'
TF32 lo halves dropped, and in the forward family's ``att_bwd`` dz pass
(a thread a channel pair and a group of positions) the last group's dv
and dq partials left out or each group reaching one position into the
next (a dmt row written twice); and in the forward family's
``train_attention`` (three one-way exchanges) each tile's softmax terms
left on its own maximum, the transition agent's prologue share of h_att
left out, the context partials summed before their message lands, and,
in its cluster-barrier alternative, the exit barrier's arrive moved
before the last read of a peer; and in K1's float32 location-sensitive
band on the tensor cores lc's TF32 lo halves dropped; and in K1's
staged instances (bf16 compute on int8 streams, the forward family on
bf16 streams: the streams copied into rings of shared-memory slots by
bulk copies) each ring's mbarrier wait moved after its tile's reads, the
context's tiles past the first one position off, a scale pair swapped, the
softmax's (max, sum) pairs summed without their rescale by exp(m_j - M), the
transition agent's prologue share of h_att and x dropped, or the ragged
tail of a tile left uncopied; and in the forward family's energy loop
(``fam_energies``, the float32 and the staged instances) the last lane's
partial of each position dropped, each lane's stream group read one
group on, or an int8 lane's scales a channel off, and in its float32 step
the (max, sum) rescale or the agent's prologue share dropped (phases
``K1f32:forward``, ``K1f32:forward_transition_agent``, ``K1q8:forward``:
the checks at that attention type); and in K3's cells the attention
cell's c_prev read a unit off in the reduction's prefetch, or a four-unit
cell's c_prev taken from the next unit (``K3f32``); and runs the checks
of that kernel's
``chip_smoke`` phase (``phase_kernels`` for K1, ``phase_variant_kernels``
for its float32 (``K1f32``) and int8-stream (``K1q8``: bf16 and float32,
at the 292- and the shared strategy's 548-wide memory) instances,
``phase_train_kernels`` for K2 and K3, and at float32 compute for their
float32 instances, ``K2f32`` and ``K3f32``) with
``chip_smoke.fail`` recording each failed check instead of stopping, so
every check's reading prints; a fault whose kernel stops with a CUDA
error (the phase's process dies) counts as caught by that error.  The run
fails unless every fault fails at least one check.

``checks`` runs the same checks on each named design variant and prints
every reading, failed or not: ``train_attention_taps`` computes K2's
location conv on the CUDA cores, K FMAs in the reference's tap order,
instead of as the band product on the tensor cores; ``tf32x3_in_place``
sums the three TF32 passes of the float32 gate and split-K products
straight into their float32 sums on the tensor cores, where the kernels
sum each ring stage's apart and add it on the CUDA cores (K1's, K2's and
K3's float32 checks); ``train_attention_fam_cluster_barriers_checks``
runs the family's exchanges as cluster barriers and peer reads instead of
one-way messages, and ``train_attention_fam_exit_probe`` that
alternative with a CTA's context partials overwritten once its exit wait
returns (the probe of the fault ``fam_exit_arrive_early``, harmless
alone); ``lsa_flagship_staged_checks`` runs K1's checks with the
flagship's bf16 location-sensitive instance staged as well.

``ab --base DIR NAME ...`` runs each named timing script (K1, K1f32,
K1f32fam, K1f32fam548, K1q8, K1fam, K2, K2fam, K3, K3fam, K3cell, prenet,
gates: those of ``time``) on DIR's package and on the
checkout's in turns (base, change, change, base), e.g. the parent commit's
against this one.  K3 and K3fam also print a digest of ``att_bwd``'s
outputs from one run on the same inputs (``alone_digest_*``,
``fwd_digest_*``, ``trans_digest_*``): equal digests on both checkouts,
bit-identical outputs.

``time`` times each named variant's kernel and the checkout's own in turns
(``--root DIR`` takes another checkout's package, e.g. the parent commit
unpacked under ``build/``, as the one copied and timed as is)
(as is, variant, variant, as is): ``lsa_attention`` at the serving path's
B=240, T=128, W8A8, alone (``chip_smoke.device_ms``) and a step inside a
32-step chunk (``torch.profiler``); ``att_bwd`` (in bf16 and float32) and
``train_attention`` at the training path's B=50, T=128 on random inputs of
the flagship's widths, alone, and ``bwd_head`` with the generator cell
(both types), among them ``bwd_head_cols_32`` (blocks of 32 columns and
two warps, twice the blocks), ``att_bwd_f32_split_in_registers``
(the float32 instance's lc and cum split into their TF32 halves in
registers at each fragment read, where the checkout splits them once when
staged) and ``band_swz_off`` (its float32 operand tiles unswizzled); the
float32 gate routine, both of the flagship's LSTMs at B=50
and 240, for ``gate_f32_cluster_1`` and ``gate_f32_cluster_4`` (K split
over clusters of one or four CTAs, where the checkout's are of two),
``gate_rows_halved`` (blocks of half the rows the launcher picks: 32 at
B=50, 64 at B=240) and ``gate_f32_stage_128`` (another ring); both
forward prenets (``prenet``: K2's ``train_prenet`` at B=50 with its
streams, K1's ``prenet`` at B=240 with its masks, both types), among them
``prenet_not_wide`` (the float32 prenet in clusters of 8 CTAs at B=50 too,
where the checkout takes non-portable clusters of 16);
the forward family's ``att_bwd`` (``K3fam``: both kinds, both types, B=50,
T=128); the family's ``train_attention`` (``K2fam``: both kinds, both
types, B=50, T=128), among them ``train_attention_fam_cluster_barriers``
(its exchanges as cluster barriers) and, on the parent, the step-0 parts
left out (``train_attention_fam_no_sum_exchange``: the tile sums' cluster
barrier a CTA barrier; ``..._no_agent_tail``; ``..._floor``: both); K1's
float32 attention (``K1f32``: location-sensitive on float32 and int8
streams, the family's float32 fwd and agent, B=240, T=128, alone and
the location-sensitive step in a 32-step chunk), on the parent with its
band (``lsa_f32_no_band``), its query (``lsa_f32_no_query``) or both
(``lsa_f32_no_products``) left out; K1's bf16 attention on int8 streams
(``K1q8``: location-sensitive at the 292- and the 548-wide memory beside
the flagship's bf16 streams, the family's fwd and agent) and the family's
bf16 instances (``K1fam``), B=240, T=128, alone, among them
``lsa_flagship_staged`` (the flagship's instance staged too) and, on the
parent, the step-0 parts left out (``lsa_streams_in_smem``: both streams
read from shared memory; ``fwd_no_agent_tail``; ``lsa_one_reduction_fewer``:
the softmax's max reduction; ``lsa_step0_all``: all three), and the staged
step with a part left out or changed (``staged_no_waits``,
``staged_no_ctx``, ``staged_no_energy``, ``staged_small_rings``,
``staged_cp_async``: the rings filled by cp.async, ``staged_mt_at_start``:
the memory transform issued ahead of Wq's copy); ``staged_phase_clock``
(timer ``K1trace``) reads each phase's cycles from each CTA's clock, and
``parent_phase_clock`` the parent kernel's (``--root PARENT``); the
forward family's float32 instances (``K1f32fam``: fwd and agent on float32
and on int8 streams, B=240, T=128, with the clusters each launch holds at
once; ``K1f32fam548``: on float32 streams at the 548-wide memory), on the
parent with a part left out (``f32fam_no_energy``, ``f32fam_no_tanh``,
``f32fam_one_reduction_fewer``, ``f32fam_no_ctx``, ``f32fam_no_agent_tail``,
``f32fam_floor``: energy and context), the redesigned step with a part
left out (``f32fam_new_no_energy``, ``f32fam_new_no_ctx``), its streams
hinted to L2 (``f32fam_l2_prefetch``, ``..._mt``, ``..._mt_late``) or
other reads in flight (``f32fam_unroll_16``, ``f32fam_ctx_batch_16``,
``f32fam_ctx_batch_4``); K3's cells (``K3cell``: B=50, both types, each
host with and without its cell, what each cell adds, both alone, and a
digest of each host's cell outputs), also with the cell's tanhf left out
(``cell_no_tanh``).

Prints every run and, last, one JSON object of the results, also written
to ``build/variants/kernel_variants_<mode>.json``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "multilingual_text_to_speech_tpu_torch"

# K2 train_attention's energies on the CUDA cores, a warp a position and a
# lane a channel, the location conv as K FMAs in tap order (the order of
# the reference's float32 conv1d) instead of the band product
_TA_TAPS_ENERGIES = r"""  // 1. energies, a warp a position, a lane a channel: loc in tap order
  for (int i = warp; i < rows; i += TA_WARPS) {
    float part = 0.0f;
    for (int a = lane; a < A; a += 32) {
      float loc = 0.0f;
      for (int k = 0; k < K; ++k)
        loc = fmaf(__bfloat162float(s_cum[i + k]),
                   __bfloat162float(s_lc[k * ld + a]), loc);
      const float tz = band_energy_tanh(
          loc, s_q[a], __bfloat162float(s_mtb[i * ldm + a]));
      part = fmaf(s_v[a], tz, part);
    }
    part = warp_sum(part);
    if (lane == 0) s_e[i] = part + s_mask[i];
  }
  __syncthreads();

"""

# the forward family's train_attention with its exchanges as cluster
# barriers and reads of the peers' shared memory, ending in a split exit
# (arrive after the CTA's last read of a peer, wait before it returns),
# the measured alternative to the checkout's one-way messages: the
# prologue's mbarrier arming left out, and the exchanges from the first on
# replaced by this text
_TA_FAM_BARRIERS = r"""    if (tid == 0) {
      s_stat[0] = mx;
      s_stat[1] = sum;
    }
    cluster_sync();
    if (warp == 0) {
      // lane j reads rank j's pair, every lane combines them in rank order
      float mj = -CUDART_INF_F, sj = 0.0f;
      if (lane < cl) {
        const float* st = cluster_peer(s_stat, lane);
        mj = st[0];
        sj = st[1];
      }
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
    if (tid == 0) s_stat[4] = wsum;
    cluster_sync();
    if (warp == 0) {
      const float x = lane < cl ? cluster_peer(s_stat, lane)[4] : 0.0f;
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
    cp_async_wait<0>();
    __syncthreads();
    ctx_partials<!F32>(L.cs, s_cpart, mem_staged ? s_mem : mem_tile, s_e,
                       rows, Mem, vec, TA_THREADS);
    __syncthreads();
    for (int m = tid; m < Mem; m += TA_THREADS) {
      const float c = ctx_column(L.cs, s_cpart, Mem, m);
      s_ctxp[m] = c;
      if (KIND == ATT_FWD_TRANS) lin = fmaf(s_ag[m], c, lin);
    }
    if (KIND == ATT_FWD_TRANS) {
      lin = block_reduce<false>(lin, s_red);
      if (tid == 0) s_stat[6] = lin;
    }
    // (every thread's reads of s_cpart above precede the barrier)
    cluster_sync();
    // the share's sums into s_cpart (no peer reads it), then the exit
    // barrier's arrive once this CTA's last read of a peer is done
    for (int m = m_lo + tid; m < m_hi; m += TA_THREADS) {
      float acc = 0.0f;
      for (int j = 0; j < cl; ++j) acc += cluster_peer(s_ctxp, j)[m];
      s_cpart[m - m_lo] = acc;
    }
    float z = 0.0f;
    if (KIND == ATT_FWD_TRANS && rank == 0 && warp == 0) {
      const float x = lane < cl ? cluster_peer(s_stat, lane)[6] : 0.0f;
      z = ag.bias[0];
      for (int j = 0; j < cl; ++j) z += __shfl_sync(0xffffffffu, x, j);
    }
    cluster_arrive();
    for (int m = m_lo + tid; m < m_hi; m += TA_THREADS) {
      const float acc = s_cpart[m - m_lo];
      ctx[(size_t)b * Mem + m] = acc;
      const CT cb = from_float<CT>(acc);
      dst0[(size_t)b * ld0 + m] = cb;
      dst1[(size_t)b * ld1 + m] = cb;
      if (dst2 != nullptr) dst2[(size_t)b * ld2 + m] = cb;
    }
    if (KIND == ATT_FWD_TRANS && rank == 0 && tid == 0) {
      const float tp = 1.0f / (1.0f + expf(-z));
      ag.tp[b] = tp;
      if (ag.tp_out != nullptr) ag.tp_out[b] = tp;
    }
    // no CTA leaves while its peers may still read its shared memory
    cluster_wait();
  }
}
"""
_TA_FAM_BARRIER_SPANS = [
    ("  if constexpr (KIND != ATT_LS) {\n    // each mbarrier armed",
     "  cp_async_wait<1>();\n  __syncthreads();\n  // the agent's h_att", ""),
    ("    cluster_wait();   // every peer's mbarriers are armed\n",
     "\ntemplate <int KIND, class CT>\n__global__ void __launch_bounds__("
     "TA_THREADS)\n    train_attention_kernel(", _TA_FAM_BARRIERS),
]

_LSA_STREAMS_IN_SMEM = (
    "  const ST* mem_b = memory + (size_t)b * T * M;\n"
    "  const ST* mtb_b = mtb + (size_t)b * T * A;\n",
    "  const ST* mem_b = reinterpret_cast<const ST*>(s_wq);\n"
    "  const ST* mtb_b = reinterpret_cast<const ST*>(s_wq);\n")
_CTX_WRAPPED = [
    ("chunk_floats(x, *reinterpret_cast<const uint4*>(mem + base), mem);",
     "chunk_floats(x, *reinterpret_cast<const uint4*>(mem + (base & 8191)),"
     " mem);"),
    ("x[j] = base + j < n_el ? to_float(mem[base + j]) : 0.0f;",
     "x[j] = base + j < n_el ? to_float(mem[(base + j) & 8191]) : 0.0f;")]
_LSA_NO_AGENT_TAIL = (
    "    if (KIND == ATT_FWD_TRANS) {\n      // 5. the transition agent",
    "    if (false) {\n      // 5. the transition agent")
_LSA_NO_MAX_REDUCTION = ("    mx = block_reduce<true>(mx, s_red);\n", "")
_F32FAM_CTX = ("    ctx_partials<!F32>(L.cs, s_cpart, mem_b, s_e, T, M, vec, "
               "LSA_THREADS);\n")
_FLAGSHIP_STAGED = (
    "         (std::is_same<ST, int8_t>::value || KIND != ATT_LS);\n",
    "         true;\n")


class Alt(tuple):
    """Alternative spans of one variant: the first whose piece occurs
    exactly once in the source is replaced (so that one variant applies to
    an earlier checkout's source, ``--root``, and to this one's)."""

    def __new__(cls, *spans):
        return super().__new__(cls, spans)


# one TF32 pass in place of the three of warp_tf32x3 (the lo terms
# dropped), on the fragments `a` and `b` of a warp's 32 x 32 tile, into
# the stage's sums `stage_acc`
def _one_tf32_pass(a: str, b: str) -> str:
    return (
        "{\n"
        "        uint32_t a1[2][4], b1[4][2];\n"
        "        for (int mt = 0; mt < 2; ++mt)\n"
        "          for (int i = 0; i < 4; ++i)\n"
        f"            a1[mt][i] = tf32_rna(__uint_as_float({a}[mt][i]));\n"
        "        for (int nt = 0; nt < 4; ++nt)\n"
        "          for (int i = 0; i < 2; ++i)\n"
        f"            b1[nt][i] = tf32_rna(__uint_as_float({b}[nt][i]));\n"
        "        for (int mt = 0; mt < 2; ++mt)\n"
        "          for (int nt = 0; nt < 4; ++nt)\n"
        "            mma_tf32(stage_acc[mt][nt], a1[mt], b1[nt]);\n"
        "      }")


# name: (source, piece, replacement, what to run), or (source, [(start,
# end, replacement), ...], what to run): the text from start up to end
# replaced (a pair (piece, replacement) in that list replaces the piece),
# or ({source: [...], ...}, what to run) for pieces of several sources
VARIANTS = {
    "lsa_location_tap": (
        "fused_decoder.cu",
        "band_stage_cum(s_cum, L.tpad + BAND_K,\n"
        "                     cum + (size_t)b * T, 0, half, T);",
        "band_stage_cum(s_cum, L.tpad + BAND_K,\n"
        "                     cum + (size_t)b * T, 0, half + 1, T);", "K1"),
    "att_bwd_dcum_tap": (
        "fused_train_decoder.cu",
        "const int t2 = t - lane + half;",
        "const int t2 = t - lane + half + 1;", "K3"),
    "att_bwd_dlc_tap": (
        "fused_train_decoder.cu",
        "band_dlc(acc[kh], s_cum + mt * 16 + kh * 16,",
        "band_dlc(acc[kh], s_cum + mt * 16 + kh * 16 + 1,", "K3"),
    "train_attention_tap": (
        "fused_train_decoder.cu",
        "band_stage_cum(s_cum, tile + BAND_K, cum + rowT, t_lo, half, T);",
        "band_stage_cum(s_cum, tile + BAND_K, cum + rowT, t_lo, half + 1,"
        " T);", "K2"),
    # the layers below the top one lose their mask (layer 0 of two)
    "bwd_prenet_mask": (
        "fused_train_decoder.cu",
        "da = out > 0.0f ? acc * scale : 0.0f;",
        "da = acc * scale;", "K3"),
    # the forward prenet routine: the mask drawn at the CTA's own column
    # (right only in the cluster's first CTA), or the gather of the bf16
    # rows skipping the last CTA's slice (zeros in its columns)
    "prenet_mask_local_col": (
        "tile.cuh",
        "keep = rand_bits((uint32_t)row, (uint32_t)col, (uint32_t)P,",
        "keep = rand_bits((uint32_t)row, (uint32_t)c, (uint32_t)P,", "K1"),
    "train_prenet_mask_local_col": (
        "tile.cuh",
        "keep = rand_bits((uint32_t)row, (uint32_t)col, (uint32_t)P,",
        "keep = rand_bits((uint32_t)row, (uint32_t)c, (uint32_t)P,", "K2"),
    "prenet_gather_skip_peer": (
        "tile.cuh", "cluster_gather_rows(s_a, lda, own, ldo, np, cl,",
        "cluster_gather_rows(s_a, lda, own, ldo, np, cl - 1,", "K1"),
    "train_prenet_gather_skip_peer": (
        "tile.cuh", "cluster_gather_rows(s_a, lda, own, ldo, np, cl,",
        "cluster_gather_rows(s_a, lda, own, ldo, np, cl - 1,", "K2"),
    # K3's cell backward (CellBwd, fused into bwd_head and the dq
    # product): the c mask drawn with the h mask's salt; or the dq product
    # launched without its reduction, every K slice running the attention
    # cell on its own partial sum
    # the forward family: the 1e-6 floor given to K1's own padding of T
    # to 16 (its renorm sum counts those positions); K3's replay of the
    # recurrence with the step's own t_prob instead of the one it read;
    # K3's state cotangent added to instead of assigned (right only for
    # the location-sensitive cum + w)
    "fwd_floor_on_padding": (
        "fused_decoder.cu",
        "      float wsum = 0.0f;\n      for (int t = tid; t < T; "
        "t += LSA_THREADS) {\n        const float energy = expf(s_e[t] - mx) "
        "/ sum;\n        const float prev = s_prev[t];\n"
        "        const float sh = t > 0 ? round_bf16(",
        "      float wsum = 0.0f;\n"
        "      for (int t = T + tid; t < L.tpad; t += LSA_THREADS) "
        "wsum += 1e-6f;\n"
        "      for (int t = tid; t < T; t += LSA_THREADS) {\n"
        "        const float energy = expf(s_e[t] - mx) / sum;\n"
        "        const float prev = s_prev[t];\n"
        "        const float sh = t > 0 ? round_bf16(",
        "K1:forward"),
    "fwd_bwd_current_tp": (
        "fused_train_decoder.cu",
        "const float tp = KIND == ATT_FWD_TRANS ? fa.tp_prev[b] : 0.0f;",
        "const float tp = KIND == ATT_FWD_TRANS ? fa.tp[b] : 0.0f;",
        "K3:forward_transition_agent"),
    # the family's dz pass (a thread a channel pair and a group of
    # positions): the last position group's dv and dq partials left out of
    # the CTA's sum; each group's positions reaching one into the next
    # group's, so that a dmt row is loaded, updated and written twice and
    # its dv and dq terms counted twice
    "fwd_dz_group_dropped": (
        "fused_train_decoder.cu",
        "      for (int grp = 0; grp < fm.groups; ++grp) {",
        "      for (int grp = 0; grp < fm.groups - 1; ++grp) {", "K3:forward"),
    "fwd_dz_row_twice": (
        "fused_train_decoder.cu",
        "const int i_lo = grp * fm.per, i_hi = min(rows, i_lo + fm.per);",
        "const int i_lo = grp * fm.per, i_hi = min(rows, i_lo + fm.per + 1);",
        "K3f32:forward_transition_agent"),
    "fwd_bwd_dcum_added": (
        "fused_train_decoder.cu",
        "dcum[rowT + t] = KIND == ATT_FWD_TRANS",
        "dcum[rowT + t] += KIND == ATT_FWD_TRANS", "K3:forward"),
    # K1's float32 and int8-stream instances: the float32 product on bf16
    # operands; the W8A8 row rounded to bf16 before a float32 decoder
    # quantizes it; an int8 memory row's last M % 16 bytes left out of the
    # context sum
    "f32_gates_one_tf32_pass": (
        "tile.cuh", "        warp_tf32x3(stage_acc, af, bf);",
        "        " + _one_tf32_pass("af", "bf"), "K1f32"),
    "w8a8_row_rounded_bf16": (
        "fused_decoder.cu", "    return round_to<CT>(v);",
        "    return round_bf16(v);", "K1f32"),
    "int8_row_tail_skipped": (
        "tile.cuh", "        const float wt = r < rows ? w[r] : 0.0f;",
        "        const bool tail = V == 16 && (V * c + j) % M >= M / V * V;\n"
        "        const float wt = r < rows && !tail ? w[r] : 0.0f;", "K1q8"),
    "cell_c_mask_h_salt": (
        "fused_train_decoder.cu",
        "reg.salt_c) < reg.th_c;",
        "reg.salt_h) < reg.th_c;", "K3"),
    "cell_on_split_partial": (
        "fused_train_decoder.cu",
        "  return product_launch(a, lda, 0, b, ldb, b_kn, M, H, K, slices, "
        "kslice,\n                        scratch,\n                        "
        "CellOut<bf16>{(const float*)add, ldadd,\n"
        "                                      CELL_ARGS(bf16)},\n"
        "                        0, stream);",
        "  const CellOut<bf16> epi{(const float*)add, ldadd, "
        "CELL_ARGS(bf16)};\n"
        "  splitk_kernel<false, false, CellOut<bf16>>\n"
        "      <<<dim3((H + SK_BN - 1) / SK_BN, (M + SK_BM - 1) / SK_BM, "
        "slices),\n         SK_THREADS, 0, (cudaStream_t)stream>>>(\n"
        "          (const bf16*)a, lda, vec_ok(a, lda), (const bf16*)b, ldb,"
        "\n          vec_ok(b, ldb), M, H, K, kslice, nullptr, epi);\n"
        "  return (int)cudaGetLastError();", "K3"),
    # the training decoder's float32 instances, one fault in each (run
    # under their float32 phase, K2f32 or K3f32: every K2/K3 kernel, or the
    # family's two at its kind): the gate routine's cluster (two CTAs at
    # B=50) leaving its last CTA's partial tile out of the sum; the split-K
    # routine in one TF32 pass (the query and the heads) or with the second
    # word of its transposed fragments ("KN" B, "KM" A: the dgates
    # products, dWq) read 4 k-rows off; a float32 stream stored in bf16 (the
    # LSTM activations, the cells' gate gradients, att_bwd's dz, the
    # family's energy terms and shifted weights); an operand of a small
    # FFMA product rounded to bf16 (the prenet's input, bwd_head's
    # dframe_tot, bwd_prenet's da); the last chunk of each float32 memory
    # row left out of the context
    "f32_train_gates_rank_dropped": (
        "tile.cuh", "        for (int peer = 1; peer < T::CL; ++peer) {",
        "        for (int peer = 1; peer < T::CL - 1; ++peer) {", "K2f32"),
    "f32_splitk_one_tf32_pass": (
        "tile.cuh", "      warp_tf32x3(stage_acc, af, bfr);",
        "      " + _one_tf32_pass("af", "bfr"), "K2f32"),
    "f32_splitk_kn_row_off": (
        "tile.cuh", "  f[1] = __float_as_uint(p[4 * ld]);",
        "  f[1] = __float_as_uint(p[0]);", "K3f32"),
    "f32_lstm_act_stored_bf16": (
        "fused_train_decoder.cu", "      a[0] = from_float<CT>(gi);",
        "      a[0] = from_float<CT>(round_bf16(gi));", "K2f32"),
    "f32_prenet_input_bf16": (
        "tile.cuh", "        v = reinterpret_cast<const float*>(xr)[k];",
        "        v = round_bf16(reinterpret_cast<const float*>(xr)[k]);",
        "K2f32"),
    "f32_ctx_last_chunk_skipped": (
        "tile.cuh",
        "        acc[j] += ROUND ? round_bf16(x[j] * wt) : x[j] * wt;",
        "        acc[j] += V == 4 && c == C - 1 ? 0.0f\n"
        "                  : ROUND ? round_bf16(x[j] * wt) : x[j] * wt;",
        "K2f32"),
    "f32_fwd_shift_rounded_bf16": (
        "fused_train_decoder.cu",
        "const float sh = round_to<CT>(i > 0 ? s_cumf[i - 1] : s_stat[7]);",
        "const float sh = round_bf16(i > 0 ? s_cumf[i - 1] : s_stat[7]);",
        "K2f32:forward"),
    "f32_bwd_head_dft_bf16": (
        "fused_train_decoder.cu",
        "        tf32_split<4>(ah[mt], al[mt], ah[mt]);",
        "        for (int i = 0; i < 4; ++i)\n"
        "          ah[mt][i] = __float_as_uint(round_bf16("
        "__uint_as_float(ah[mt][i])));\n"
        "        tf32_split<4>(ah[mt], al[mt], ah[mt]);", "K3f32"),
    "f32_cell_dg_stored_bf16": (
        "fused_train_decoder.cu",
        [Alt(("    d[0] = from_float<CT>(dc_new * gg * i * (1.0f - i));",
              "    d[0] = from_float<CT>(round_bf16(dc_new * gg * i * "
              "(1.0f - i)));"),
             ("               {dc_new * gg * i * (1.0f - i), ",
              "               {round_bf16(dc_new * gg * i * (1.0f - i)), "))],
        "K3f32"),
    "f32_att_bwd_dz_bf16": (
        "fused_train_decoder.cu",
        "                make_float2(dz0, dz1);\n"
        "          }",
        "                make_float2(round_bf16(dz0), round_bf16(dz1));\n"
        "          }",
        "K3f32"),
    # K3's float32 head and band products on the tensor cores: each
    # product in one TF32 pass (bwd_head; att_bwd's loc, P and dlc), the
    # Hankel fragment of cum one tap off, the second word of a swizzled
    # "KN" fragment read from its first row, one cluster rank's dlc
    # partial left out of the row's sum, lc's lo halves dropped
    "f32_bwd_head_one_tf32_pass": (
        "fused_train_decoder.cu",
        "          mma_tf32x3(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);",
        "          mma_tf32(acc[mt][nt], ah[mt], bh[nt]);", "K3f32"),
    "f32_att_loc_one_tf32_pass": (
        "fused_train_decoder.cu",
        "            band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, lane);\n"
        "            mma_tf32x3(acc, ah, al, bh[ks], bl[ks]);\n"
        "          }",
        "            band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, lane);\n"
        "            mma_tf32(acc, ah, bh[ks]);\n"
        "          }",
        "K3f32"),
    "f32_att_p_one_tf32_pass": (
        "fused_train_decoder.cu",
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h) {\n"
        "            uint32_t ah[4], al[4];\n"
        "            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +\n"
        "                                            ((lane >> 3) & 1) * 8,\n"
        "                                        kk + 8 * h + (lane >> 4) *"
        " 4, A));\n"
        "            tf32_split<4>(ah, al, ah);\n"
        "            mma_tf32x3(acc[h], ah, al, bh + 2 * h, bl + 2 * h);\n"
        "          }\n"
        "        }\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          s_p[(m0 + g + 8 * (e >> 1)) * BAND_K + n0 + 2 * qd + (e &"
        " 1)] =\n"
        "              acc[0][e] + acc[1][e];\n"
        "      }\n"
        "      __syncthreads();",
        "#pragma unroll\n"
        "          for (int h = 0; h < 2; ++h) {\n"
        "            uint32_t ah[4], al[4];\n"
        "            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +\n"
        "                                            ((lane >> 3) & 1) * 8,\n"
        "                                        kk + 8 * h + (lane >> 4) *"
        " 4, A));\n"
        "            tf32_split<4>(ah, al, ah);\n"
        "            mma_tf32(acc[h], ah, bh + 2 * h);\n"
        "          }\n"
        "        }\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          s_p[(m0 + g + 8 * (e >> 1)) * BAND_K + n0 + 2 * qd + (e &"
        " 1)] =\n"
        "              acc[0][e] + acc[1][e];\n"
        "      }\n"
        "      __syncthreads();",
        "K3f32"),
    "f32_att_dlc_one_tf32_pass": (
        "fused_train_decoder.cu",
        "              band_frag_tf32(al, s_cum_lo + k0 + 16 * kh, lane);\n"
        "              mma_tf32x3(st[kh], ah, al, bh, bl);\n"
        "            }",
        "              band_frag_tf32(al, s_cum_lo + k0 + 16 * kh, lane);\n"
        "              mma_tf32(st[kh], ah, bh);\n"
        "            }",
        "K3f32"),
    "f32_att_hankel_tap_off": (
        "tile.cuh", "  const int i = (lane >> 2) + (lane & 3);\n"
        "  a[0] = __float_as_uint(p[i]);",
        "  const int i = (lane >> 2) + (lane & 3) + 1;\n"
        "  a[0] = __float_as_uint(p[i]);", "K3f32"),
    "f32_att_kn_row_off": (
        "tile.cuh", "  b[1] = __float_as_uint(s[band_swz(k + 4, n, ld)]);",
        "  b[1] = __float_as_uint(s[band_swz(k, n, ld)]);", "K3f32"),
    "f32_att_dlc_rank_dropped": (
        "fused_train_decoder.cu",
        "      for (int j = 0; j < cl; ++j) sum += cluster_peer(s_dlcp, j)[idx];",
        "      for (int j = 0; j < cl - 1; ++j)\n"
        "        sum += cluster_peer(s_dlcp, j)[idx];", "K3f32"),
    "f32_att_lc_lo_dropped": (
        "tile.cuh", "    tf32_split_store(s + i, s + n + i, s[i]);",
        "  {\n    tf32_split_store(s + i, s + n + i, s[i]);\n"
        "    s[n + i] = 0.0f;\n  }", "K3f32"),
    "f32_fwd_att_bwd_tz_bf16": (
        "fused_train_decoder.cu",
        "            if constexpr (!SUB) s_tz[i * A + a] = tz;",
        "            if constexpr (!SUB) s_tz[i * A + a] = round_bf16(tz);",
        "K3f32:forward_transition_agent"),
    "f32_bwd_prenet_da_bf16": (
        "tile.cuh",
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n",
        "    for (int i = 0; i < 4; ++i)\n"
        "      ah[i] = __float_as_uint(round_bf16(__uint_as_float(ah[i])));\n"
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n",
        "K3f32"),
    # K2's float32 location conv and K3's float32 prenet backward on the
    # tensor cores: each product in one TF32 pass, the Hankel fragment of
    # cum one tap off (train_attention's own reads), lc's or da's TF32 lo
    # halves dropped, one warp's partial energy left out of a position's
    # sum, one K slice's partial left out of bwd_prenet's sum
    "f32_train_attention_one_tf32_pass": (
        "fused_train_decoder.cu",
        "            mma_tf32x3(acc[h], ah, al, bh, bl);",
        "            mma_tf32(acc[h], ah, bh);", "K2f32"),
    "f32_train_attention_hankel_tap_off": (
        "fused_train_decoder.cu",
        "\n          band_frag_tf32(ah, s_cum + mt * 16 + 8 * ks, lane);\n"
        "          band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, lane);",
        "\n          band_frag_tf32(ah, s_cum + mt * 16 + 8 * ks + 1, lane);\n"
        "          band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks + 1, lane);",
        "K2f32"),
    "f32_train_attention_lc_lo_dropped": (
        "fused_train_decoder.cu",
        "            tf32_split<2>(bh, bl, bh);\n"
        "            mma_tf32x3(acc[h],",
        "            tf32_split<2>(bh, bl, bh);\n"
        "            bl[0] = bl[1] = 0u;\n"
        "            mma_tf32x3(acc[h],", "K2f32"),
    "f32_train_attention_warp_energy_dropped": (
        "fused_train_decoder.cu",
        "e += s_ep[w * tile + i];\n      s_e[i] = e + s_mask[i];",
        "e += w < TA_WARPS - 1 ? s_ep[w * tile + i] : 0.0f;\n"
        "      s_e[i] = e + s_mask[i];", "K2f32"),
    "f32_bwd_prenet_one_tf32_pass": (
        "tile.cuh", "    mma_tf32(c[0], al, bh);\n    mma_tf32(c[1], ah, bl);\n",
        "", "K3f32"),
    "f32_bwd_prenet_da_lo_dropped": (
        "tile.cuh",
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n",
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n"
        "    al[0] = al[1] = al[2] = al[3] = 0u;\n", "K3f32"),
    "f32_bwd_prenet_k_partial_dropped": (
        "tile.cuh", "  for (int ks = 1; ks < splits; ++ks) acc +=",
        "  for (int ks = 1; ks < splits - 1; ++ks) acc +=", "K3f32"),
    # the forward prenet's float32 products (tf32x3_kslices, shared with
    # bwd_prenet, run under K2's float32 checks): one TF32 pass, one K
    # slice's partial left out of the sum, the weights' TF32 lo halves
    # dropped
    "f32_prenet_one_tf32_pass": (
        "tile.cuh", "    mma_tf32(c[0], al, bh);\n    mma_tf32(c[1], ah, bl);\n",
        "", "K2f32"),
    "f32_prenet_k_partial_dropped": (
        "tile.cuh", "  for (int ks = 1; ks < splits; ++ks) acc +=",
        "  for (int ks = 1; ks < splits - 1; ++ks) acc +=", "K2f32"),
    "f32_prenet_w_lo_dropped": (
        "tile.cuh",
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n",
        "    tf32_split<4>(ah, al, ah);\n    tf32_split<2>(bh, bl, bh);\n"
        "    bl[0] = bl[1] = 0u;\n", "K2f32"),
    # the redesigned forward family's train_attention (each under K2's
    # family phase): each tile's softmax terms taken on its own maximum
    # (the pairs combined, but the tile's exp(e - m_j) not rescaled to the
    # row's maximum); the transition agent's prologue share of h_att . wq
    # left out; the context partials summed without waiting for their
    # message to land; and in the cluster-barrier alternative, the exit
    # barrier's arrive moved before the CTA's reads of its peers' context
    # partials, with a probe that overwrites a CTA's own partials once its
    # exit wait returns (harmless where the arrive follows the reads:
    # train_attention_fam_exit_probe)
    "fam_tile_stats_local_max": (
        "fused_train_decoder.cu",
        "    __syncthreads();\n    mx = s_stat[2];\n    sum = s_stat[3];",
        "    __syncthreads();\n    sum = s_stat[3];",
        "K2:forward_transition_agent"),
    "fam_agent_prologue_dropped": (
        "fused_train_decoder.cu",
        "    for (int k = tid; k < n_h; k += TA_THREADS)\n"
        "      lin = fmaf(s_ag[Mem + k], s_ag[Mem + sh_h + k], lin);",
        "", "K2f32:forward_transition_agent"),
    "fam_ctx_message_wait_dropped": (
        "fused_train_decoder.cu", "    mbar_wait0(s_bar + 2);\n", "",
        "K2:forward_transition_agent"),
    "fam_exit_arrive_early": (
        "fused_train_decoder.cu",
        _TA_FAM_BARRIER_SPANS + [
         ("    // (every thread's reads of s_cpart above precede the barrier)\n"
          "    cluster_sync();\n",
          "    // (every thread's reads of s_cpart above precede the barrier)\n"
          "    cluster_sync();\n    cluster_arrive();\n"),
         ("      for (int j = 0; j < cl; ++j) z += __shfl_sync(0xffffffffu, "
          "x, j);\n    }\n    cluster_arrive();",
          "      for (int j = 0; j < cl; ++j) z += __shfl_sync(0xffffffffu, "
          "x, j);\n    }"),
         ("    cluster_wait();\n  }\n}\n",
          "    cluster_wait();\n"
          "    for (int m = tid; m < Mem; m += TA_THREADS) "
          "s_ctxp[m] = CUDART_NAN_F;\n  }\n}\n")],
        "K2:forward_transition_agent"),
    # K1's staged instances (bf16 on int8 streams, the family on bf16
    # streams): each ring's mbarrier wait moved after its tile's reads; the
    # context's tiles past the first one position off; a scale pair
    # swapped; the softmax's (max, sum) pairs summed without their rescale
    # by exp(m_j - M); the transition agent's prologue share of h_att and x
    # dropped; the ragged tail of a tile left uncopied
    "staged_wait_after_read": (
        "fused_decoder.cu",
        [("      ring_wait(mt_bars, L.mt, j);\n", ""),
         ("      __syncthreads();\n      if (warp == 0 && j + L.mt.stages < "
          "n_mt)\n",
          "      ring_wait(mt_bars, L.mt, j);\n      __syncthreads();\n"
          "      if (warp == 0 && j + L.mt.stages < n_mt)\n"),
         ("      ring_wait(mem_bars, L.mem, j);\n", ""),
         ("      __syncthreads();\n      if (warp == 0 && j + L.mem.stages < "
          "n_mem)\n",
          "      ring_wait(mem_bars, L.mem, j);\n      __syncthreads();\n"
          "      if (warp == 0 && j + L.mem.stages < n_mem)\n")],
        "K1:forward"),
    "staged_tile_off_by_one": (
        "fused_decoder.cu",
        "      const int lo = j * L.mem.tile, rows = min(L.mem.tile, T - lo);",
        "      const int lo = j * L.mem.tile + (j > 0),\n"
        "                rows = min(L.mem.tile, T - lo);", "K1q8"),
    "staged_scale_pair_swapped": (
        "fused_decoder.cu",
        "        s8[2 * k] = s.x;\n        s8[2 * k + 1] = s.y;\n",
        "        s8[2 * k] = s.y;\n        s8[2 * k + 1] = s.x;\n", "K1q8"),
    "staged_softmax_no_rescale": (
        "fused_decoder.cu",
        [("  float ws = m == -CUDART_INF_F ? 0.0f : s * expf(m - wm);\n",
          "  float ws = m == -CUDART_INF_F ? 0.0f : s;\n"),
         ("    s += mw == -CUDART_INF_F ? 0.0f : scratch[2 * w + 1] * "
          "expf(mw - m);\n",
          "    s += mw == -CUDART_INF_F ? 0.0f : scratch[2 * w + 1];\n")],
        "K1q8"),
    "staged_agent_prologue_dropped": (
        "fused_decoder.cu",
        "  if (KIND == ATT_FWD_TRANS && live) {\n#pragma unroll 4\n"
        "    for (int k = tid; k < H; k += LSA_THREADS)\n"
        "      lin = fmaf(round_bf16(h_att",
        "  if (false) {\n#pragma unroll 4\n"
        "    for (int k = tid; k < H; k += LSA_THREADS)\n"
        "      lin = fmaf(round_bf16(h_att",
        "K1:forward_transition_agent"),
    "staged_ragged_tail_dropped": (
        "fused_decoder.cu", "  const int tail = bulk ? (int)(u + n - z) : 0;\n",
        "  const int tail = 0;\n", "K1q8"),
    # K1's forward family (fam_energies: a lane per group of 4 float32
    # channels or 8 int8 codes or bf16, U positions' reads in flight; the
    # float32 step's one (max, sum) reduction and agent's terms in the
    # prologue): the last lane's partial of each position dropped; each
    # lane's stream group read one group on (its q and v its own); the
    # (max, sum) pairs summed without their rescale; the agent's prologue
    # share of h_att and x dropped; an int8 lane's scales taken a channel
    # off.  And K3's cell backward: the attention cell's c_prev read one
    # unit off in the reduction's prefetch; a four-unit cell's c_prev taken
    # from the next unit (CellBwd::apply4, the generator cell in bwd_head)
    "f32fam_position_partial_dropped": (
        "fused_decoder.cu",
        "    for (int off = lpr >> 1; off > 0; off >>= 1)\n#pragma unroll\n"
        "      for (int u = 0; u < U; ++u)\n",
        "#pragma unroll\n    for (int u = 0; u < U; ++u)\n"
        "      if (sub == lpr - 1) e[u] = 0.0f;\n"
        "    for (int off = lpr >> 1; off > 0; off >>= 1)\n#pragma unroll\n"
        "      for (int u = 0; u < U; ++u)\n", "K1f32:forward"),
    "f32fam_channel_group_off": (
        "fused_decoder.cu",
        "        m[u] = mt_group(rows + (size_t)(t - lo) * A + FW * sub, "
        "aligned);",
        "        m[u] = mt_group(rows + (size_t)(t - lo) * A + FW * ((sub + 1) "
        "% ng),\n                        aligned);", "K1f32:forward"),
    "f32fam_softmax_no_rescale": (
        "fused_decoder.cu",
        [("  float ws = m == -CUDART_INF_F ? 0.0f : s * expf(m - wm);\n",
          "  float ws = m == -CUDART_INF_F ? 0.0f : s;\n"),
         ("    s += mw == -CUDART_INF_F ? 0.0f : scratch[2 * w + 1] * "
          "expf(mw - m);\n",
          "    s += mw == -CUDART_INF_F ? 0.0f : scratch[2 * w + 1];\n")],
        "K1f32:forward"),
    "f32fam_agent_prologue_dropped": (
        "fused_decoder.cu",
        "  if (KIND == ATT_FWD_TRANS && live) {\n#pragma unroll 4\n"
        "    for (int k = tid; k < H; k += LSA_THREADS)\n"
        "      lin = fmaf(h_att[",
        "  if (false) {\n#pragma unroll 4\n"
        "    for (int k = tid; k < H; k += LSA_THREADS)\n"
        "      lin = fmaf(h_att[",
        "K1f32:forward_transition_agent"),
    "f32fam_q8_scale_off": (
        "fused_decoder.cu",
        "    sr[i] = own && q8 ? s_mts[a] : 1.0f;",
        "    sr[i] = own && q8 ? s_mts[a ^ 1] : 1.0f;", "K1q8:forward"),
    "cell_prefetch_unit_off": (
        "fused_train_decoder.cu",
        "               cell.c_prev != nullptr ? to_float(cell.c_prev[o]) : "
        "0.0f,",
        "               cell.c_prev != nullptr ? to_float(cell.c_prev[o + 1])"
        " : 0.0f,", "K3f32"),
    "cell_apply4_unit_off": (
        "fused_train_decoder.cu",
        "                     elem4(cp, j), elem4(dct, j));",
        "                     elem4(cp, (j + 1) & 3), elem4(dct, j));", "K3f32"),
    # the staged instances with smaller rings (the memory transform in one
    # slot of 16 KB, the memory in two of 19 KB): three CTAs an SM
    "staged_small_rings": (
        "fused_decoder.py",
        "_MT_RING_BYTES, _MT_SLOTS = 32 * 1024, 2\n"
        "_MEM_RING_BYTES, _MEM_SLOTS = 56 * 1024, 3\n",
        "_MT_RING_BYTES, _MT_SLOTS = 16 * 1024, 1\n"
        "_MEM_RING_BYTES, _MEM_SLOTS = 38 * 1024, 2\n", "time K1q8,K1fam"),
    # what the parts of the staged instances cost (wrong results; timing
    # only): the rings' mbarrier waits left out (the copies still issued),
    # the context's sums left out, the energies left out
    "staged_no_waits": (
        "fused_decoder.cu",
        [("      ring_wait(mt_bars, L.mt, j);\n", ""),
         ("      ring_wait(mem_bars, L.mem, j);\n", "")], "time K1fam"),
    "staged_no_ctx": (
        "fused_decoder.cu",
        "      if (tid < G * C)\n        staged_ctx_tile<ST>(acc,",
        "      if (false)\n        staged_ctx_tile<ST>(acc,", "time K1fam"),
    "staged_no_energy": (
        "fused_decoder.cu", "      else\n        fam_energies<FE_UNROLL, bf16>(",
        "      else if (false)\n        fam_energies<FE_UNROLL, bf16>(",
        "time K1fam"),
    # the staged step's phases on each CTA's clock (cycles from its start,
    # thread 0's, written over the first weights of its row): the
    # prologue, the query, the cluster exchange, the energies, the softmax,
    # the context, the tail
    "staged_phase_clock": (
        "fused_decoder.cu",
        [("  // 0. the rings' mbarriers\n",
          "  long long clk[11];\n  clk[0] = clock64();\n"
          "  // 0. the rings' mbarriers\n"),
         ("  // 1. the query's partial over this CTA's slice of H, rows g < 8\n"
          "  for (int n0",
          "  clk[1] = clock64();\n"
          "  // 1. the query's partial over this CTA's slice of H, rows g < 8\n"
          "  for (int n0"),
         ("  // Wq's slice and h_att's rows are read: the memory's first tiles "
          "over them\n  __syncthreads();\n",
          "  // Wq's slice and h_att's rows are read: the memory's first tiles "
          "over them\n  __syncthreads();\n  clk[2] = clock64();\n"),
         ("    // 2. energies, a tile of the memory transform's ring at a time\n",
          "    clk[3] = clock64();\n"
          "    // 2. energies, a tile of the memory transform's ring at a time\n"),
         ("    // 3. softmax, its max and sum in one block reduction; ls: cum' = "
          "cum\n",
          "    clk[4] = clock64();\n"
          "    // 3. softmax, its max and sum in one block reduction; ls: cum' = "
          "cum\n"),
         ("    // 4. context from the memory's ring: CtxScheme's slots (group, "
          "chunk\n",
          "    clk[5] = clock64();\n"
          "    // 4. context from the memory's ring: CtxScheme's slots (group, "
          "chunk\n"),
         ("      ring_wait(mt_bars, L.mt, j);\n",
          "      ring_wait(mt_bars, L.mt, j);\n"
          "      if (j == 0) clk[8] = clock64();\n"),
         ("      ring_wait(mem_bars, L.mem, j);\n",
          "      ring_wait(mem_bars, L.mem, j);\n"
          "      if (j == 0) clk[9] = clock64();\n"
          "      clk[10] = clock64();\n"),
         ("    for (int m = tid; m < M; m += LSA_THREADS) {\n"
          "      float ctx = ctx_column(L.cs, s_cpart, M, m);",
          "    clk[6] = clock64();\n"
          "    for (int m = tid; m < M; m += LSA_THREADS) {\n"
          "      float ctx = ctx_column(L.cs, s_cpart, M, m);"),
         ("      // bf16(x)] . [wc | wq | wx]\n"
          "      lin = block_reduce<false>(lin, s_red);\n"
          "      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + "
          "fa.bias[0])));\n    }\n",
          "      // bf16(x)] . [wc | wq | wx]\n"
          "      lin = block_reduce<false>(lin, s_red);\n"
          "      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + "
          "fa.bias[0])));\n    }\n    __syncthreads();\n"
          "    clk[7] = clock64();\n    if (tid == 0) {\n"
          "      for (int k = 1; k < 11; ++k)\n"
          "        cum_out[(size_t)b * T + k] = (float)(clk[k] - clk[0]);\n"
          "      cum_out[(size_t)b * T] = -1.0f;\n    }\n")],
        "time K1trace"),
    # the parent kernel's phases on each CTA's clock, as
    # staged_phase_clock reads the staged step's (run with --root PARENT)
    "parent_phase_clock": (
        "fused_decoder.cu",
        [("  const ST* mem_b = memory + (size_t)b * T * M;\n",
          "  long long clk[8];\n  clk[0] = clock64();\n"
          "  const ST* mem_b = memory + (size_t)b * T * M;\n"),
         ("  cp_async_wait<0>();\n  __syncthreads();\n\n"
          "  // 1. the query's partial over this CTA's slice of H, rows g < 8\n"
          "  if constexpr (F32) {",
          "  cp_async_wait<0>();\n  __syncthreads();\n  clk[1] = clock64();\n"
          "\n  // 1. the query's partial over this CTA's slice of H, rows g < "
          "8\n  if constexpr (F32) {"),
         ("  cluster_sync();\n  for (int a = tid; a < A; a += LSA_THREADS) {",
          "  clk[2] = clock64();\n"
          "  cluster_sync();\n  for (int a = tid; a < A; a += LSA_THREADS) {"),
         ("  if (live) {\n    // 2. energies\n",
          "  if (live) {\n    clk[3] = clock64();\n    // 2. energies\n"),
         ("    // 3. softmax; ls: cum' = cum + w; the forward family: the "
          "recurrence,",
          "    clk[4] = clock64();\n"
          "    // 3. softmax; ls: cum' = cum + w; the forward family: the "
          "recurrence,"),
         ("    // 4. context (csrc/tile.cuh: ctx_partials, ctx_column), int8 "
          "streams",
          "    clk[5] = clock64();\n"
          "    // 4. context (csrc/tile.cuh: ctx_partials, ctx_column), int8 "
          "streams"),
         ("    float lin = 0.0f;\n    for (int m = tid; m < M; m += "
          "LSA_THREADS) {\n",
          "    clk[6] = clock64();\n"
          "    float lin = 0.0f;\n    for (int m = tid; m < M; m += "
          "LSA_THREADS) {\n"),
         ("      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + "
          "fa.bias[0])));\n    }\n  }\n  cluster_wait();\n}",
          "      if (tid == 0) fa.tp_out[b] = 1.0f / (1.0f + expf(-(lin + "
          "fa.bias[0])));\n    }\n    __syncthreads();\n"
          "    clk[7] = clock64();\n    if (tid == 0) {\n"
          "      for (int k = 1; k < 8; ++k)\n"
          "        cum_out[(size_t)b * T + k] = (float)(clk[k] - clk[0]);\n"
          "      for (int k = 8; k < 11; ++k) cum_out[(size_t)b * T + k] = "
          "0.0f;\n      cum_out[(size_t)b * T] = -1.0f;\n    }\n"
          "  }\n  cluster_wait();\n}")],
        "time K1trace"),
    # the memory transform's first tiles issued at the kernel's start,
    # ahead of Wq's copy (the order the measured design replaced)
    "staged_mt_at_start": (
        "fused_decoder.cu",
        [("    __syncwarp();\n  }\n",
          "    __syncwarp();\n"
          "    for (int j = 0; j < min(L.mt.stages, n_mt); ++j)\n"
          "      ring_issue(lsa_smem, mt_bars, L.mt, mtb_b, T, j, lane);\n"
          "  }\n"),
         ("  if (warp == 0 && live)\n"
          "    for (int j = 0; j < min(L.mt.stages, n_mt); ++j)\n"
          "      ring_issue(lsa_smem, mt_bars, L.mt, mtb_b, T, j, lane);\n", "")],
        "time K1q8,K1fam"),
    # the rings filled by warp 0's 16-byte cp.async copies, each lane's
    # completion an arrival on the slot's mbarrier, in place of one bulk
    # copy (timing only: 16-byte-aligned tiles, as at B=240, T=128)
    "staged_cp_async": (
        "fused_decoder.cu",
        [("__device__ void ring_issue(", "// tile j landed\n",
          "__device__ void ring_issue(uint8_t* smem, uint64_t* bars,\n"
          "                           const StreamRing& R, const uint8_t* "
          "src, int T,\n                           int j, int lane) {\n"
          "  const int t0 = j * R.tile, n = min(R.tile, T - t0) * R.row;\n"
          "  const uint8_t* s = src + (size_t)t0 * R.row;\n"
          "  uint8_t* d = ring_tile(smem, R, src, j);\n"
          "  for (int i = lane * 16; i < n; i += 32 * 16)\n"
          "    cp_async16(d + i, s + i, min(16, n - i));\n"
          "  asm volatile(\"cp.async.mbarrier.arrive.noinc.shared::cta.b64 "
          "[%0];\\n\" ::\"r\"(smem_addr(bars + j % R.stages)) : "
          "\"memory\");\n}\n\n")],
        "time K1q8,K1fam"),
    # the flagship's bf16 location-sensitive instance staged too: its time
    # against the checkout's (unstaged) in turns, and its checks
    "lsa_flagship_staged": (
        "fused_decoder.cu", _FLAGSHIP_STAGED[0], _FLAGSHIP_STAGED[1],
        "time K1q8"),
    "lsa_flagship_staged_checks": (
        "fused_decoder.cu", _FLAGSHIP_STAGED[0], _FLAGSHIP_STAGED[1],
        "design K1"),
    # K1's float32 location-sensitive band without lc's TF32 lo halves
    "lsa_f32_lc_lo_dropped": (
        "fused_decoder.cu",
        "          tf32_split<2>(bh[ks][h], bl[ks][h], bh[ks][h]);",
        "          tf32_split<2>(bh[ks][h], bl[ks][h], bh[ks][h]);\n"
        "          bl[ks][h][0] = bl[ks][h][1] = 0u;", "K1f32"),
    "train_attention_taps": (
        "fused_train_decoder.cu",
        [("  // 1. energies: loc = band(cum) @ lc",
          "  // 2. the row's masked softmax", _TA_TAPS_ENERGIES)],
        "design K2"),
    # the float32 products with their TF32 passes summed straight into the
    # float32 sums on the tensor cores, without tf32x3_promote's stage sums
    # the forward family's exchanges as cluster barriers and reads of the
    # peers' shared memory, with a split exit, instead of one-way messages
    # (the checkout's; an earlier checkout's package, --root, takes the
    # other alternative): its times, and its checks
    "train_attention_fam_cluster_barriers": (
        "fused_train_decoder.cu", _TA_FAM_BARRIER_SPANS, "time K2fam"),
    "train_attention_fam_cluster_barriers_checks": (
        "fused_train_decoder.cu", _TA_FAM_BARRIER_SPANS,
        "design K2:forward,K2:forward_transition_agent,"
        "K2f32:forward_transition_agent"),
    # the exit probe of fam_exit_arrive_early alone (in the cluster-barrier
    # alternative): every check passes
    "train_attention_fam_exit_probe": (
        "fused_train_decoder.cu",
        _TA_FAM_BARRIER_SPANS + [
         ("    cluster_wait();\n  }\n}\n",
          "    cluster_wait();\n"
          "    for (int m = tid; m < Mem; m += TA_THREADS) "
          "s_ctxp[m] = CUDART_NAN_F;\n  }\n}\n")],
        "design K2:forward_transition_agent,K2f32:forward_transition_agent"),
    "tf32x3_in_place": (
        "tile.cuh",
        [("        warp_tf32x3(stage_acc, af, bf);",
          "        warp_tf32x3(acc, af, bf);"),
         ("      warp_tf32x3(stage_acc, af, bfr);",
          "      warp_tf32x3(acc, af, bfr);")],
        "design K1f32,K2f32,K3f32"),
    # the float32 gate routine's ring in 128-byte stages (32 values, as
    # bf16's) at every rows a block, where the checkout takes 256 at up to
    # 64 rows
    "gate_f32_stage_128": (
        "tile.cuh",
        "  static constexpr int BK = F32 && WM <= 2 ? 256 : 128;",
        "  static constexpr int BK = 128;", "time gates"),
    # its K split over clusters of one or of four CTAs, where the checkout
    # splits it over two
    "gate_f32_cluster_1": (
        "tile.cuh", "constexpr int GT_F32_CL = 2;",
        "constexpr int GT_F32_CL = 1;", "time gates"),
    "gate_f32_cluster_4": (
        "tile.cuh", "constexpr int GT_F32_CL = 2;",
        "constexpr int GT_F32_CL = 4;", "time gates"),
    # blocks of half the rows that the launcher picks above 32 rows
    "gate_rows_halved": (
        "tile.cuh",
        [("  if (M > 128)\n    return gate_tile_run<E, 4>(",
          "  return gate_tile_run<E, 1>(",
          "  if (M > 128)\n    return gate_tile_run<E, 2>(a, lda, w, ldw, "
          "kbytes, M, H, epi, stream);\n"
          "  if (M > 32)\n    return gate_tile_run<E, 1>(a, lda, w, ldw, "
          "kbytes, M, H, epi, stream);\n")],
        "time gates"),
    # K3's float32 att_bwd with lc and cum split into their TF32 halves in
    # registers where each fragment is read, as dz is, instead of once when
    # staged (their lo tiles then unread)
    "att_bwd_f32_split_in_registers": ({
        "fused_train_decoder.cu": [
            ("  if constexpr (KIND == ATT_LS && F32) tf32_split_words(s_lc, "
             "BAND_K * A);\n", ""),
            ("          band_frag_kn(bl[ks], lc_lo, A, 8 * ks, n0, lane);",
             "          tf32_split<2>(bh[ks], bl[ks], bh[ks]);"),
            ("            band_frag_tf32(al, s_cum_lo + mt * 16 + 8 * ks, "
             "lane);", "            tf32_split<4>(ah, al, ah);"),
            ('      // K = A, lc\'s "NK" fragments of two K steps by one '
             'ldmatrix\n'
             "      for (int it = warp; it < mtiles * 4; it += AB_WARPS) {\n"
             "        const int m0 = (it >> 2) * 16, n0 = (it & 3) * 8;\n"
             "        float acc[2][4] = {};\n"
             "        for (int kk = 0; kk < A; kk += 16) {\n"
             "          uint32_t bh[4], bl[4];\n"
             "          const int lc_at = band_swz(n0 + (lane & 7), kk +"
             " (lane >> 3) * 4, A);\n"
             "          ldsm_x4(bh, s_lc + lc_at);\n"
             "          ldsm_x4(bl, lc_lo + lc_at);\n"
             "#pragma unroll\n"
             "          for (int h = 0; h < 2; ++h) {\n"
             "            uint32_t ah[4], al[4];\n"
             "            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +\n"
             "                                            ((lane >> 3) & 1)"
             " * 8,\n"
             "                                        kk + 8 * h + (lane >>"
             " 4) * 4, A));\n"
             "            tf32_split<4>(ah, al, ah);\n"
             "            mma_tf32x3(acc[h], ah, al, bh + 2 * h, bl + 2 * h);",
             '      // K = A, lc\'s "NK" fragments of two K steps by one '
             'ldmatrix\n'
             "      for (int it = warp; it < mtiles * 4; it += AB_WARPS) {\n"
             "        const int m0 = (it >> 2) * 16, n0 = (it & 3) * 8;\n"
             "        float acc[2][4] = {};\n"
             "        for (int kk = 0; kk < A; kk += 16) {\n"
             "          uint32_t bh[4], bl[4];\n"
             "          const int lc_at = band_swz(n0 + (lane & 7), kk +"
             " (lane >> 3) * 4, A);\n"
             "          ldsm_x4(bh, s_lc + lc_at);\n"
             "          tf32_split<4>(bh, bl, bh);\n"
             "#pragma unroll\n"
             "          for (int h = 0; h < 2; ++h) {\n"
             "            uint32_t ah[4], al[4];\n"
             "            ldsm_x4(ah, s_dz + band_swz(m0 + (lane & 7) +\n"
             "                                            ((lane >> 3) & 1)"
             " * 8,\n"
             "                                        kk + 8 * h + (lane >>"
             " 4) * 4, A));\n"
             "            tf32_split<4>(ah, al, ah);\n"
             "            mma_tf32x3(acc[h], ah, al, bh + 2 * h, bl + 2 *"
             " h);"),
            ("              band_frag_tf32(al, s_cum_lo + k0 + 16 * kh, "
             "lane);", "              tf32_split<4>(ah, al, ah);")],
        "tile.cuh": [
            ("    tf32_split_store(hi + i, lo + i, t >= 0 && t < T ? cum[t] "
             ": 0.0f);", "    hi[i] = t >= 0 && t < T ? cum[t] : 0.0f;")]},
        "time K3"),
    # bwd_head in blocks of 32 columns and two warps (168 blocks at B=50),
    # where the checkout's are of 64 and four (84)
    "bwd_head_cols_32": (
        "fused_train_decoder.cu",
        "constexpr int BH_BM = 16, BH_BN = 64, BH_THREADS = 128;",
        "constexpr int BH_BM = 16, BH_BN = 32, BH_THREADS = 64;", "time K3"),
    # the float32 operand tiles of att_bwd unswizzled (rows of A words:
    # four-way conflicts on the "KN" reads, eight-way on ldmatrix's)
    "band_swz_off": (
        "tile.cuh",
        "  return (row * ld + col) ^ (((row & 3) << 3) | (((row >> 2) & 1) "
        "<< 2));", "  return row * ld + col;", "time K3"),
    # what each part of the float32 train_attention and bwd_prenet costs:
    # the kernel with one part left out (wrong results; timing only).
    # train_attention: the location conv (loc = 0), the tanh of the energy
    # (the sum of v * z), the context sum (its partials unwritten);
    # bwd_prenet: the product (each output from one da and one weight),
    # the gather of the da rows over distributed shared memory
    "train_attention_f32_no_band": (
        "fused_train_decoder.cu", [Alt(
            ("? (band_loc_f32(s_cum + i, s_lc + a, ld) + s_q[a]) + mt",
             "? (0.0f + s_q[a]) + mt"),
            ("            mma_tf32x3(acc[h], ah, al, bh, bl);",
             "            ;"))],
        "time K2"),
    "train_attention_f32_no_tanh": (
        "fused_train_decoder.cu", [Alt(
            ("e = fmaf(s_v[a], tanhf(z), e);", "e = fmaf(s_v[a], z, e);"),
            ("          e0 = fmaf(v0, band_energy_tanh<float>(acc[h][0], q0, "
             "m0.x), e0);\n"
             "          e0 = fmaf(v1, band_energy_tanh<float>(acc[h][1], q1, "
             "m0.y), e0);\n"
             "          e1 = fmaf(v0, band_energy_tanh<float>(acc[h][2], q0, "
             "m1.x), e1);\n"
             "          e1 = fmaf(v1, band_energy_tanh<float>(acc[h][3], q1, "
             "m1.y), e1);",
             "          e0 = fmaf(v0, (acc[h][0] + q0) + m0.x, e0);\n"
             "          e0 = fmaf(v1, (acc[h][1] + q1) + m0.y, e0);\n"
             "          e1 = fmaf(v0, (acc[h][2] + q0) + m1.x, e1);\n"
             "          e1 = fmaf(v1, (acc[h][3] + q1) + m1.y, e1);"))],
        "time K2"),
    "train_attention_f32_no_ctx": (
        "fused_train_decoder.cu",
        [Alt(("  ctx_partials<!F32>(L.cs, s_cpart,",
              "  if constexpr (!F32)\n  ctx_partials<!F32>(L.cs, s_cpart,"),
             ("    ctx_partials<!F32>(L.cs, s_cpart, mem_staged ? s_mem : "
              "mem_tile, s_e,\n                       rows, Mem, vec, "
              "TA_THREADS);\n    __syncthreads();\n    for (int m = tid; m "
              "< Mem; m += TA_THREADS)\n      s_ctxp[m]",
              "    if constexpr (!F32)\n"
              "    ctx_partials<!F32>(L.cs, s_cpart, mem_staged ? s_mem : "
              "mem_tile, s_e,\n                       rows, Mem, vec, "
              "TA_THREADS);\n    __syncthreads();\n    for (int m = tid; m "
              "< Mem; m += TA_THREADS)\n      s_ctxp[m]"))],
        "time K2"),
    "bwd_prenet_f32_no_product": (
        "fused_train_decoder.cu", [Alt(
            ("        for (int k = 0; k < kp; k += 4) {\n"
             "          const float4 x",
             "        for (int k = 0; k < 0; k += 4) {\n"
             "          const float4 x"),
            ("        for (; k + 8 < k_hi; k += 16) {",
             "        for (k = k_hi; k + 8 < k_hi; k += 16) {"),
            ("      tf32x3_kslices<false>(s_part, s_a, ldw, w_l, ldw, n_l, kp,",
             "      tf32x3_kslices<false>(s_part, s_a, ldw, w_l, ldw, n_l, 0,"))],
        "time K3"),
    "bwd_prenet_f32_no_gather": (
        "fused_train_decoder.cu",
        [("    cluster_gather_rows(s_a, ldw, own, ldo, np, cl, mtiles * 16,",
          "    if constexpr (!F32)\n"
          "    cluster_gather_rows(s_a, ldw, own, ldo, np, cl, mtiles * 16,")],
        "time K3"),
    # the float32 prenet products (tf32x3_kslices: the forward prenets and
    # bwd_prenet) with one accumulator a warp, the three passes summed
    # straight in (one chain of up to 48 dependent mma.sync), where the
    # checkout keeps six; train_attention's float32 instance without its
    # launch bound (80 registers, three CTAs an SM)
    "bwd_prenet_f32_one_chain": (
        "tile.cuh",
        [("    mma_tf32(c[0], al, bh);\n    mma_tf32(c[1], ah, bl);\n"
          "    mma_tf32(c[2], ah, bh);",
          "    mma_tf32x3(c[0], ah, al, bh, bl);"),
         ("    step(k + 8, acc[1]);", "    step(k + 8, acc[0]);")],
        "time K3"),
    # the prenet backward with 512 threads a CTA (both instances; float32:
    # twice the K slices)
    "bwd_prenet_threads_512": (
        "fused_train_decoder.cu",
        "constexpr int BP_ROWS = 16, BP_THREADS = 256,",
        "constexpr int BP_ROWS = 16, BP_THREADS = 512,", "time K3"),
    # what each part of the float32 forward prenet and of the forward
    # family's att_bwd costs (wrong results; timing only): the prenet's
    # product left out (each output its bias alone, the epilogue kept); the
    # family's dz/dmt/dv/dq pass left out; its energy pass left out; every
    # cluster barrier of its replay but the first made a CTA barrier
    "train_prenet_f32_no_product": (
        "tile.cuh", [Alt(
            ("        for (int k = 0; k < kp; ++k)\n"
             "          acc = fmaf(ar[k], w_l[(size_t)k * ldw + c], acc);",
             "        for (int k = 0; k < 0; ++k)\n"
             "          acc = fmaf(ar[k], w_l[(size_t)k * ldw + c], acc);"),
            ("      tf32x3_kslices<true>(s_part, s_a, lda, w_l, ldw, np, kp, "
             "warp,",
             "      tf32x3_kslices<true>(s_part, s_a, lda, w_l, ldw, np, 0, "
             "warp,"))],
        "time prenet"),
    # the float32 forward prenets in clusters of 8 CTAs of np = 32 at every
    # B, where the checkout takes non-portable clusters of 16 of np = 16 at
    # up to 64 rows
    "prenet_not_wide": (
        "fused_decoder.py",
        "_PRENET_CLUSTER_MAX, _PRENET_WIDE_CLUSTER_MAX, _PRENET_WIDE_ROWS = "
        "8, 16, 64",
        "_PRENET_CLUSTER_MAX, _PRENET_WIDE_CLUSTER_MAX, _PRENET_WIDE_ROWS = "
        "8, 16, 0", "time prenet"),
    # the family's instances without their launch bound (74 to 78
    # registers, three CTAs an SM), where the checkout holds them to 64 and
    # four
    "att_bwd_fwd_unbounded": (
        "fused_train_decoder.cu",
        "__global__ void __launch_bounds__(AB_THREADS, 4)\n"
        "    att_bwd_family_kernel(",
        "__global__ void __launch_bounds__(AB_THREADS)\n"
        "    att_bwd_family_kernel(", "time K3fam"),
    "att_bwd_fwd_no_dz": (
        "fused_train_decoder.cu", [Alt(
            ("      for (int i = 0; i < rows; ++i) {\n"
             "        const float tz = to_float(s_tz[i * A + a]);",
             "      for (int i = 0; i < 0; ++i) {\n"
             "        const float tz = to_float(s_tz[i * A + a]);"),
            ("    for (int c = tid; c < fm.pairs * fm.groups; c += AB_THREADS) {",
             "    for (int c = tid; c < 0; c += AB_THREADS) {"))],
        "time K3fam"),
    "att_bwd_fwd_no_energy": (
        "fused_train_decoder.cu",
        [("          for (int a = lane; a < A; a += 32) {\n"
          "            const float tz = fwd_energy_tanh<CT>(",
          "          for (int a = lane; a < 0; a += 32) {\n"
          "            const float tz = fwd_energy_tanh<CT>("),
         ("          for (int a = 2 * lane; a < A; a += 64) {",
          "          for (int a = 2 * lane; a < 0; a += 64) {")],
        "time K3fam"),
    # (the parent's five exchanges, or the checkout's three)
    "att_bwd_fwd_one_exchange": (
        "fused_train_decoder.cu",
        [Alt(("    if (tid == 0) s_s1[2] = psum;\n    cluster_sync();",
              "    if (tid == 0) s_s1[2] = psum;\n    __syncthreads();"),
             ("    const AbFamMap fm(A, rows);",
              "    const AbFamMap fm(A, rows);")),
         Alt(("    if (tid == 0) s_s1[3] = nsum;\n    cluster_sync();",
              "    if (tid == 0) s_s1[3] = nsum;\n    __syncthreads();"),
             ("    pe /= nsum;", "    pe /= nsum;")),
         ("      s_s1[5] = pt;\n    }\n    cluster_sync();",
          "      s_s1[5] = pt;\n    }\n    __syncthreads();"),
         ("      s_dqp[a] = pdq;\n    }\n    cluster_sync();",
          "      s_dqp[a] = pdq;\n    }\n    __syncthreads();")],
        "time K3fam"),
    "train_attention_f32_unbounded": (
        "fused_train_decoder.cu",
        "__global__ void __launch_bounds__(TA_THREADS, 4)",
        "__global__ void __launch_bounds__(TA_THREADS)", "time K2"),
    # what the forward family's train_attention spends on its exchanges
    # (wrong results; timing only): the tile sums' cluster barrier made a
    # CTA barrier (one softmax exchange, as the online softmax has); the
    # transition agent's tail (its dot products, block sum and barrier) left
    # out; both
    "train_attention_fam_no_sum_exchange": (
        "fused_train_decoder.cu",
        "  if (tid == 0) s_stat[1] = sum;\n  cluster_sync();",
        "  if (tid == 0) s_stat[1] = sum;\n  __syncthreads();", "time K2fam"),
    "train_attention_fam_no_agent_tail": (
        "fused_train_decoder.cu",
        "  if (KIND == ATT_FWD_TRANS) {\n    // 4. the transition agent",
        "  if (false) {\n    // 4. the transition agent", "time K2fam"),
    "train_attention_fam_floor": (
        "fused_train_decoder.cu",
        [("  if (tid == 0) s_stat[1] = sum;\n  cluster_sync();",
          "  if (tid == 0) s_stat[1] = sum;\n  __syncthreads();"),
         ("  if (KIND == ATT_FWD_TRANS) {\n    // 4. the transition agent",
          "  if (false) {\n    // 4. the transition agent")],
        "time K2fam"),
    # what each product of K1's float32 attention costs (wrong results;
    # timing only): the location conv's band left out (loc = 0), the
    # query's product left out (each partial 0), both
    "lsa_f32_no_band": (
        "fused_decoder.cu",
        "? (band_loc_f32(s_cum + t, s_lc + a, L.ld) + s_q[a]) + mt",
        "? (0.0f + s_q[a]) + mt", "time K1f32"),
    "lsa_f32_no_query": (
        "fused_decoder.cu",
        "      for (int k = 0; k < L.kq; ++k)\n"
        "        acc = fmaf(hr[k], s_wq[k * L.ld + a], acc);",
        "      for (int k = 0; k < 0; ++k)\n"
        "        acc = fmaf(hr[k], s_wq[k * L.ld + a], acc);", "time K1f32"),
    "lsa_f32_no_products": (
        "fused_decoder.cu",
        [("? (band_loc_f32(s_cum + t, s_lc + a, L.ld) + s_q[a]) + mt",
          "? (0.0f + s_q[a]) + mt"),
         ("      for (int k = 0; k < L.kq; ++k)\n"
          "        acc = fmaf(hr[k], s_wq[k * L.ld + a], acc);",
          "      for (int k = 0; k < 0; ++k)\n"
          "        acc = fmaf(hr[k], s_wq[k * L.ld + a], acc);")],
        "time K1f32"),
    # what the parts of K1's bf16 attention step cost on int8 streams and
    # in the forward family (wrong results; timing only, on the parent's
    # kernel): both streams read from shared memory (the dead slice of Wq,
    # the memory's indices wrapped into its first 8192 elements) instead
    # of device memory; the transition agent's tail left out; the
    # softmax's max reduction left out (each thread's own maximum); all
    # three
    "lsa_streams_in_smem": ({
        "fused_decoder.cu": [_LSA_STREAMS_IN_SMEM],
        "tile.cuh": _CTX_WRAPPED},
        "time K1q8,K1fam"),
    "fwd_no_agent_tail": (
        "fused_decoder.cu", _LSA_NO_AGENT_TAIL[0], _LSA_NO_AGENT_TAIL[1],
        "time K1fam"),
    "lsa_one_reduction_fewer": (
        "fused_decoder.cu", _LSA_NO_MAX_REDUCTION[0],
        _LSA_NO_MAX_REDUCTION[1], "time K1q8,K1fam"),
    "lsa_step0_all": ({
        "fused_decoder.cu": [_LSA_STREAMS_IN_SMEM, _LSA_NO_AGENT_TAIL,
                             _LSA_NO_MAX_REDUCTION],
        "tile.cuh": _CTX_WRAPPED},
        "time K1q8,K1fam"),
    # what the parts of K1's float32 forward-family step cost (wrong
    # results; timing only, on the parent's kernel: a warp a position in
    # the energy loop): the energy loop left out (s_e zero), its tanhf left
    # out (the identity), the softmax's max reduction left out, the context
    # left out (ctx_partials), the transition agent's tail left out; the
    # energy loop and the context both left out
    "f32fam_no_energy": (
        "fused_decoder.cu",
        [("      // a warp a position, a lane every 32nd channel\n",
          "    } else {\n      // one warp per 16 positions",
          "      for (int t = tid; t < T; t += LSA_THREADS) s_e[t] = 0.0f;\n")],
        "time K1f32fam"),
    "f32fam_no_tanh": (
        "fused_decoder.cu",
        "          e = fmaf(s_v[a], tanhf(s_q[a] + mt), e);",
        "          e = fmaf(s_v[a], s_q[a] + mt, e);", "time K1f32fam"),
    "f32fam_one_reduction_fewer": (
        "fused_decoder.cu", _LSA_NO_MAX_REDUCTION[0],
        _LSA_NO_MAX_REDUCTION[1], "time K1f32fam"),
    "f32fam_no_ctx": (
        "fused_decoder.cu", _F32FAM_CTX, "", "time K1f32fam"),
    "f32fam_no_agent_tail": (
        "fused_decoder.cu", _LSA_NO_AGENT_TAIL[0], _LSA_NO_AGENT_TAIL[1],
        "time K1f32fam"),
    "f32fam_floor": (
        "fused_decoder.cu",
        [("      // a warp a position, a lane every 32nd channel\n",
          "    } else {\n      // one warp per 16 positions",
          "      for (int t = tid; t < T; t += LSA_THREADS) s_e[t] = 0.0f;\n"),
         (_F32FAM_CTX, "")],
        "time K1f32fam"),
    # the redesigned float32 family step with a part left out (timing
    # only): its energy loop, its context; and with hints to L2 of the
    # streams it reads later: the row's memory transform at the start, its
    # memory once the query has run
    "f32fam_new_no_energy": (
        "fused_decoder.cu",
        [("      fam_energies<FE32_UNROLL, float>(", "    } else {",
          "      for (int t = tid; t < T; t += LSA_THREADS) s_e[t] = 0.0f;\n")],
        "time K1f32fam"),
    "f32fam_new_no_ctx": (
        "fused_decoder.cu",
        "    ctx_partials<!F32, KIND != ATT_LS ? ctx32_batch<ST>() : 1>(",
        "    if (KIND == ATT_LS)\n"
        "      ctx_partials<!F32, KIND != ATT_LS ? ctx32_batch<ST>() : 1>(",
        "time K1f32fam"),
    "f32fam_l2_prefetch": (
        "fused_decoder.cu",
        [("  float* s_prev = reinterpret_cast<float*>(s_cum);\n",
          "  float* s_prev = reinterpret_cast<float*>(s_cum);\n"
          "  if (KIND != ATT_LS && live)\n"
          "    for (size_t off = tid * 128; off < (size_t)T * A * sizeof(ST);"
          "\n         off += LSA_THREADS * 128)\n"
          "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
          "(const char*)mtb_b + off));\n"),
         ("  // the peers' partials are read: they may exit once this CTA has "
          "too\n  cluster_arrive();\n  __syncthreads();\n\n  if (live) {\n"
          "    // 2. energies\n",
          "  // the peers' partials are read: they may exit once this CTA has "
          "too\n  cluster_arrive();\n  __syncthreads();\n\n  if (live) {\n"
          "    if (KIND != ATT_LS)\n"
          "      for (size_t off = tid * 128; off < (size_t)T * M * sizeof(ST);"
          "\n           off += LSA_THREADS * 128)\n"
          "        asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
          "(const char*)mem_b + off));\n"
          "    // 2. energies\n")],
        "time K1f32fam"),
    # the memory transform's row alone hinted to L2: at the start (once
    # Wq's copy is issued), or once the query has run (before the cluster
    # exchange)
    "f32fam_l2_prefetch_mt": (
        "fused_decoder.cu",
        "  float* s_prev = reinterpret_cast<float*>(s_cum);\n",
        "  float* s_prev = reinterpret_cast<float*>(s_cum);\n"
        "  if (KIND != ATT_LS && live)\n"
        "    for (size_t off = tid * 128; off < (size_t)T * A * sizeof(ST);"
        "\n         off += LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mtb_b + off));\n", "time K1f32fam"),
    "f32fam_l2_prefetch_mt_late": (
        "fused_decoder.cu",
        "  cluster_sync();\n  for (int a = tid; a < A; a += LSA_THREADS) {\n"
        "    float sum = 0.0f;\n    for (int j = 0; j < LSA_ROWS; ++j)\n"
        "      sum += cluster_peer(s_qp, j)[rank * A + a];\n"
        "    s_q[a] = round_to<CT>(sum);",
        "  if (KIND != ATT_LS && live)\n"
        "    for (size_t off = tid * 128; off < (size_t)T * A * sizeof(ST);"
        "\n         off += LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mtb_b + off));\n"
        "  cluster_sync();\n  for (int a = tid; a < A; a += LSA_THREADS) {\n"
        "    float sum = 0.0f;\n    for (int j = 0; j < LSA_ROWS; ++j)\n"
        "      sum += cluster_peer(s_qp, j)[rank * A + a];\n"
        "    s_q[a] = round_to<CT>(sum);", "time K1f32fam"),
    # the float32 family's reads in flight: 16 positions a lane in the
    # energy loop (8 in the checkout), 16 or 4 periods a slot in the
    # context on either stream (8 of float32, 4 of int8 in the checkout)
    "f32fam_unroll_16": (
        "fused_decoder.cu", "constexpr int FE32_UNROLL = 8;",
        "constexpr int FE32_UNROLL = 16;", "time K1f32fam"),
    "f32fam_ctx_batch_16": (
        "fused_decoder.cu", "  return std::is_same<ST, int8_t>::value ? 4 : 8;",
        "  return 16;", "time K1f32fam"),
    "f32fam_ctx_batch_4": (
        "fused_decoder.cu", "  return std::is_same<ST, int8_t>::value ? 4 : 8;",
        "  return 4;", "time K1f32fam"),
    # what K3's LSTM cell backward costs with its tanhf left out (the
    # identity; wrong results, timing only), in both hosts and both types
    "cell_no_tanh": (
        "fused_train_decoder.cu",
        "    const float tanh_c = tanhf(f * cp + i * gg);",
        "    const float tanh_c = f * cp + i * gg;", "time K3cell"),
    # a hint to L2 at the start, one prefetch per 128-byte line, of the
    # bytes the kernel reads later (lsa_attention: the row's memory and
    # memory transform; att_bwd: its tile's memory transform and dmt)
    "lsa_l2_prefetch": (
        "fused_decoder.cu",
        "  const int k_lo = rank * L.kq, a_chunks = A / VC;\n",
        "  if (live) {\n"
        "    for (size_t off = tid * 128; off < (size_t)T * M * 2; off += "
        "LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mem_b + off));\n"
        "    for (size_t off = tid * 128; off < (size_t)T * A * 2; off += "
        "LSA_THREADS * 128)\n"
        "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)mtb_b + off));\n"
        "  }\n"
        "  const int k_lo = rank * L.kq, a_chunks = A / VC;\n", "time K1"),
    "att_bwd_l2_prefetch": (
        "fused_train_decoder.cu",
        "  for (int a = tid; a < A; a += AB_THREADS) {\n"
        "    s_q[a] = q[(size_t)b * A + a];\n",
        "  for (size_t off = tid * 128; off < (size_t)min(tile, T - t_lo) * A"
        " * 2; off += AB_THREADS * 128)\n"
        "    asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)(mtb + (rowT + t_lo) * A) + off));\n"
        "  for (size_t off = tid * 128; off < (size_t)min(tile, T - t_lo) * A"
        " * 4; off += AB_THREADS * 128)\n"
        "    asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"("
        "(const char*)(dmt + (rowT + t_lo) * A) + off));\n"
        "  for (int a = tid; a < A; a += AB_THREADS) {\n"
        "    s_q[a] = q[(size_t)b * A + a];\n", "time K3"),
}

_PRELUDE = r"""
import json, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK)
sd = cs.seeded_state_dict(hp)
"""

# the outputs of one run of `fn` from the tensors as given, as a number
# (the first 24 bits of their bytes' SHA-256), the tensors restored after
# it: two checkouts whose kernels agree bit for bit print the same
_DIGEST = r"""
import hashlib
def _digest(fn, outs):
    saved = [o.clone() for o in outs]
    fn()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for o in outs:
        h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    for o, s in zip(outs, saved):
        o.copy_(s)
    return float(int(h.hexdigest()[:6], 16))
"""

_CHECKS = _PRELUDE + r"""
failed = []
def record(msg):
    failed.append(msg)
    print("[variant] check failed: " + msg)
cs.fail = record
phase, _, attention = {phase!r}.partition(":")
# K2f32, K3f32: the training kernels' float32 instances
f32 = cs.F32 if phase in ("K2f32", "K3f32") else {{}}
if attention:
    # the forward family's kernels, at its own phases' configuration
    hp = cs.flagship(cs.FAMILY_FRAMES, cs.CHUNK, attention, **f32)
    sd = cs.seeded_state_dict(hp)
elif f32:
    hp = cs.flagship(cs.MAX_FRAMES, cs.CHUNK, **f32)
if phase == "K1":
    torch.set_grad_enabled(False)
    cs.phase_kernels(hp, sd)
elif phase in ("K1f32", "K1q8"):
    # K1's float32 (W8A8 and exact gates) or int8-stream (bf16 and float32)
    # instances at the flagship's widths; the streams also at the shared
    # strategy's 548-wide memory
    from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
    torch.set_grad_enabled(False)
    groups = ([(cs.F32, [(True, False), (False, False)])]
              if phase == "K1f32" else
              [(cs.Q8, [(True, True)]), (cs.F32_Q8, [(True, True)])])
    for cfg, variants in groups:
        h = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES,
                        attention or "location_sensitive", **cfg)
        cs.phase_variant_kernels(Synthesizer(h, sd, device="cuda"), h,
                                 variants)
    if phase == "K1q8":
        hs = cs.switching("shared", cs.SWITCHING_FRAMES, cs.CHUNK)
        cs.phase_shared_streams(cs.seeded_state_dict(hs))
else:
    cs.phase_train_kernels(
        hp, sd, only=cs.FAMILY_TRAIN_KERNELS if attention else None)
print("VARIANT_RESULT " + json.dumps({{"failed": failed}}))
"""

_TIME_K1 = _PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.set_grad_enabled(False)
syn = Synthesizer(hp, sd, device="cuda")
bundle, kw = syn.bundle, syn.decode_kwargs
memory, mt, mask, carry = cs.encoded_batch(syn, hp)
mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
alone = cs.device_ms(lambda: fd.lsa_attention(
    carry["h_att"], carry["att_state"]["weights"], mem, mtb, mask_add,
    bundle), ours_only=True)
steps = 32
def chunk():
    fd.decode_chunk(bundle, carry, memory, mt, mask, (1, 2), steps, **kw)
chunk()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    chunk()
    torch.cuda.synchronize()
busy = cs.device_busy(p)
in_chunk = None
if busy is not None:
    in_chunk = sum(v for k, v in busy[2].items()
                   if k.startswith("lsa_attention_kernel")) / steps
print("VARIANT_RESULT " + json.dumps({{"alone_ms": alone,
                                      "in_chunk_us": in_chunk}}))
"""

# att_bwd at B=50, T=128 and the flagship's widths (A=128, Mem=292, 31
# taps) on random inputs, the accumulators and dcum updated in place, in
# both compute types
_TIME_K3 = _PRELUDE + _DIGEST + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, t, a, mem, k = cs.TRAIN_B, cs.TRAIN_T, 128, 292, 31
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    args = (rnd(b, a).to(ct).float(), rnd(b, t).abs().to(ct),
            torch.softmax(rnd(b, t), -1), rnd(b, t, mem).to(ct),
            rnd(b, t, a, scale=0.5).to(ct), rnd(k, a, scale=0.1).to(ct),
            rnd(a, scale=a ** -0.5), rnd(b, mem), rnd(b, t, scale=0.1),
            rnd(b, t, scale=0.1), torch.zeros(b, t, a, device="cuda"),
            torch.zeros(b, k, a, device="cuda"),
            torch.zeros(b, a, device="cuda"),
            torch.empty(b, a, dtype=ct, device="cuda"),
            torch.empty(b, mem, dtype=ct, device="cuda"))
    res[f"alone_digest_{{name}}"] = _digest(lambda: ftd.att_bwd(*args),
                                            args[9:])
    res[f"alone_ms_{{name}}"] = cs.device_ms(lambda: ftd.att_bwd(*args),
                                             ours_only=True)
# bwd_head with the generator cell (zoneout) at B=50, M=80, H=1024, Mem=292
from types import SimpleNamespace
h, m = 1024, 80
cfg = SimpleNamespace(mmel=m, hidden=h, mem_dim=mem)
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    tc = ftd.TrainConfig(hidden=h, mem_dim=mem, prenet_dim=256, n_prenet=2,
                         mmel=m, att_dim=a, taps=k, dropout_rate=0.5,
                         zoneout_h=0.1, zoneout_c=0.1, use_zoneout=True,
                         dtype=ct)
    w = torch.zeros(m + 1, 1344, device="cuda")
    w[:, :h + mem] = rnd(m + 1, h + mem, scale=(h + mem) ** -0.5)
    cell = ftd.CellArgs(torch.sigmoid(rnd(b, 4 * h)).to(ct),
                        rnd(b, h).to(ct), rnd(b, h, scale=0.1),
                        torch.empty(b, 4 * h, dtype=ct, device="cuda"),
                        torch.empty(b, h, device="cuda"),
                        tc.reg("gen", (11, 12), 5))
    hargs = (rnd(b, m), rnd(b), rnd(b, m), w.to(ct),
             torch.empty(b, m, dtype=ct, device="cuda"), rnd(b, h),
             rnd(b, mem), None, torch.empty(b, mem, device="cuda"), cfg)
    res[f"bwd_head_ms_{{name}}"] = cs.device_ms(
        lambda: ftd.bwd_head(*hargs, cell=cell), ours_only=True)
# bwd_prenet at B=50, P=256, M=80, two layers, a teacher step, masks of
# half the values
p, n = 256, 2
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    tc = ftd.TrainConfig(hidden=h, mem_dim=mem, prenet_dim=p, n_prenet=n,
                         mmel=m, att_dim=a, taps=k, dropout_rate=0.5,
                         zoneout_h=0.1, zoneout_c=0.1, use_zoneout=True,
                         dtype=ct)
    pops = {{"pre_w": rnd(m * p + (n - 1) * p * p, scale=1 / 16).to(ct),
            "pre_b": torch.zeros(n * p, device="cuda")}}
    keep = torch.rand(n, b, p, device="cuda", generator=gen) < 0.5
    pre = (rnd(n, b, p).clamp(min=0.0) * keep).to(ct)
    pargs = (rnd(b, p, scale=0.1), pre, pops, tc, 1,
             torch.empty(n, b, p, dtype=ct, device="cuda"),
             torch.empty(b, m, dtype=ct, device="cuda"),
             torch.empty(b, m, device="cuda"))
    res[f"bwd_prenet_ms_{{name}}"] = cs.device_ms(
        lambda: ftd.bwd_prenet(*pargs), ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


# train_attention at B=50, T=128 and the flagship's widths on random
# inputs, the cum carry and the context updated in place, in both compute
# types
_TIME_K2 = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, t, a, mem, k = cs.TRAIN_B, cs.TRAIN_T, 128, 292, 31
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    cum = rnd(b, t).abs()
    ctx = torch.empty(b, mem, device="cuda")
    outs = (torch.empty(b, t, device="cuda"),
            torch.empty(b, t, dtype=ct, device="cuda"))
    dsts = [torch.empty(b, mem, dtype=ct, device="cuda") for _ in range(3)]
    args = (rnd(b, a).to(ct).float(), cum, rnd(b, t, mem).to(ct),
            rnd(b, t, a, scale=0.5).to(ct), torch.zeros(b, t, device="cuda"),
            rnd(k, a, scale=0.1).to(ct), rnd(a, scale=a ** -0.5), *outs, ctx,
            dsts)
    res[f"alone_ms_{{name}}"] = cs.device_ms(
        lambda: ftd.train_attention(*args), ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


# the forward family's att_bwd at B=50, T=128 and the flagship's widths
# (A=128, Mem=292, H=1024, P=256) on random inputs, both kinds (the
# transition agent's backward in its prologue) in both compute types, the
# accumulators and carries updated in place
_TIME_K3FAM = _PRELUDE + _DIGEST + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, t, a, mem, h, p = cs.TRAIN_B, cs.TRAIN_T, 128, 292, 1024, 256
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
mask_add = torch.zeros(b, t, device="cuda")
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    for kind in ("fwd", "trans"):
        w_s = torch.softmax(rnd(b, t), -1)
        prev = torch.softmax(rnd(b, t), -1).to(ct)
        fam = ftd.FamilyBwd(mask_add)
        if kind == "trans":
            fam = ftd.FamilyBwd(
                mask_add, torch.rand(b, device="cuda", generator=gen),
                torch.rand(b, device="cuda", generator=gen), rnd(b),
                torch.empty(b, device="cuda"), rnd(mem + h + p, scale=0.03),
                rnd(b, h), torch.empty(b, p, device="cuda"))
        args = (rnd(b, a).to(ct).float(), prev, w_s, rnd(b, t, mem).to(ct),
                rnd(b, t, a, scale=0.5).to(ct), None, rnd(a, scale=a ** -0.5),
                rnd(b, mem), rnd(b, t, scale=0.1), rnd(b, t, scale=0.1),
                torch.zeros(b, t, a, device="cuda"), None,
                torch.zeros(b, a, device="cuda"),
                torch.empty(b, a, dtype=ct, device="cuda"),
                torch.empty(b, mem, dtype=ct, device="cuda"))
        outs = [x for x in args[9:] if x is not None] + (
            [fam.dtp, fam.dlin, fam.dh_att, fam.dx] if kind == "trans"
            else [])
        res[f"{{kind}}_digest_{{name}}"] = _digest(
            lambda: ftd.att_bwd(*args, fam=fam), outs)
        res[f"{{kind}}_ms_{{name}}"] = cs.device_ms(
            lambda: ftd.att_bwd(*args, fam=fam), ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


# the forward family's train_attention at B=50, T=128 and the flagship's
# widths (A=128, Mem=292, H=1024, P=256) on random inputs, both kinds (the
# transition agent's t_prob carry updated in place) in both compute types,
# the weights carry and the context updated in place
_TIME_K2FAM = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, t, a, mem, h, p = cs.TRAIN_B, cs.TRAIN_T, 128, 292, 1024, 256
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    for kind in ("fwd", "trans"):
        prev = torch.softmax(rnd(b, t), -1)
        ctx = torch.empty(b, mem, device="cuda")
        outs = (torch.empty(b, t, device="cuda"),
                torch.empty(b, t, dtype=ct, device="cuda"))
        dsts = [torch.empty(b, mem, dtype=ct, device="cuda")
                for _ in range(3)]
        agent = None
        if kind == "trans":
            agent = ftd.AgentArgs(
                torch.rand(b, device="cuda", generator=gen),
                torch.empty(b, device="cuda"), rnd(b, h), rnd(b, p),
                rnd(mem + h + p, scale=0.03), rnd(1))
        args = (rnd(b, a).to(ct).float(), prev, rnd(b, t, mem).to(ct),
                rnd(b, t, a, scale=0.5).to(ct),
                torch.zeros(b, t, device="cuda"), None,
                rnd(a, scale=a ** -0.5), *outs, ctx, dsts)
        res[f"{{kind}}_ms_{{name}}"] = cs.device_ms(
            lambda: ftd.train_attention(*args, agent=agent), ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


# K1's float32 attention instances at the serving path's B=240, T=128 and
# the flagship's widths, alone (chip_smoke.device_ms): location-sensitive
# on float32 and on int8 streams, and the forward family's float32 fwd and
# agent; the location-sensitive float32 step also inside a 32-step chunk
# (torch.profiler)
_TIME_K1F32 = _PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.set_grad_enabled(False)
res = {{}}
for label, kind, cfg in (
        ("ls", "location_sensitive", cs.F32),
        ("ls_q8", "location_sensitive", cs.F32_Q8),
        ("fwd", "forward", cs.F32),
        ("trans", "forward_transition_agent", cs.F32)):
    h = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind, **cfg)
    s = hp if kind == "location_sensitive" else cs.flagship(
        cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind)
    syn = Synthesizer(h, cs.seeded_state_dict(s), device="cuda")
    bundle, kw = syn.bundle, syn.decode_kwargs
    memory, mt, mask, carry = cs.encoded_batch(syn, h)
    mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    st = carry["att_state"]
    if kind == "location_sensitive":
        call = lambda: fd.lsa_attention(carry["h_att"], st["weights"], mem,
                                        mtb, mask_add, bundle)
    else:
        x = fd.prenet_plain(carry["frame"], bundle, kw["dropout_rate"],
                            (1, 2), 0)
        call = lambda: fd.fwd_attention(carry["h_att"], st["weights"],
                                        st.get("t_prob"), mem, mtb,
                                        mask_add, x, bundle)
    res[f"{{label}}_ms"] = cs.device_ms(call, ours_only=True)
    if label == "ls":
        steps = 32
        def chunk():
            fd.decode_chunk(bundle, carry, memory, mt, mask, (1, 2), steps,
                            **kw)
        chunk()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            chunk()
            torch.cuda.synchronize()
        busy = cs.device_busy(p)
        if busy is not None:
            res["ls_in_chunk_us"] = sum(
                v for k, v in busy[2].items()
                if k.startswith("lsa_attention_kernel")) / steps
    del syn
print("VARIANT_RESULT " + json.dumps(res))
"""


# K1's bf16 attention instances at the serving path's B=240, T=128 and the
# flagship's widths, alone (chip_smoke.device_ms): each row (label,
# attention type, chip_smoke's configuration, strategy: the shared one's
# 548-wide memory) of @ROWS@
_TIME_K1_ROWS = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.set_grad_enabled(False)
res = {{}}
for label, kind, cfg, strategy in @ROWS@:
    settings = getattr(cs, cfg) if cfg else {{}}
    if strategy:
        s = cs.switching(strategy, cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES)
        h = cs.switching(strategy, cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES)
        s.attention_type = h.attention_type = kind
        for k, v in settings.items():
            setattr(h, k, v)
    else:
        s = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind)
        h = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind, **settings)
    syn = Synthesizer(h, cs.seeded_state_dict(s), device="cuda")
    bundle, kw = syn.bundle, syn.decode_kwargs
    memory, mt, mask, carry = cs.encoded_batch(syn, h)
    mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    st = carry["att_state"]
    if kind == "location_sensitive":
        call = lambda: fd.lsa_attention(carry["h_att"], st["weights"], mem,
                                        mtb, mask_add, bundle)
    else:
        x = fd.prenet_plain(carry["frame"], bundle, kw["dropout_rate"],
                            (1, 2), 0)
        call = lambda: fd.fwd_attention(carry["h_att"], st["weights"],
                                        st.get("t_prob"), mem, mtb,
                                        mask_add, x, bundle)
    res[f"{{label}}_ms"] = cs.device_ms(call, ours_only=True)
    if hasattr(fd, "attention_clusters"):
        b, t, e = getattr(mem, "q", mem).shape
        res[f"{{label}}_clusters"] = fd.attention_clusters(
            bundle.att_kind, bundle.dtype, bundle.q_streams, b, t,
            carry["h_att"].shape[1], getattr(mtb, "q", mtb).shape[-1], e)
    del syn
print("VARIANT_RESULT " + json.dumps(res))
"""
# K1's staged instances at B=240, T=128 (location-sensitive on int8
# streams, the family's bf16 fwd and agent), one call each on the copy of
# the variant staged_phase_clock: each phase's cycles (the mean over the
# CTAs of the cumulative clocks its rows carry back)
_TIME_K1TRACE = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer
torch.set_grad_enabled(False)
phases = ("prologue", "query", "exchange", "energies", "softmax",
          "context", "tail")
res = {{}}
for label, kind, cfg in (("ls_q8", "location_sensitive", cs.Q8),
                         ("fwd", "forward", {{}}),
                         ("trans", "forward_transition_agent", {{}})):
    s = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind)
    h = cs.flagship(cs.LAUNCH_FRAMES, cs.LAUNCH_FRAMES, kind, **cfg)
    syn = Synthesizer(h, cs.seeded_state_dict(s), device="cuda")
    bundle, kw = syn.bundle, syn.decode_kwargs
    memory, mt, mask, carry = cs.encoded_batch(syn, h)
    mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    st = carry["att_state"]
    for _ in range(3):
        if kind == "location_sensitive":
            w = fd.lsa_attention(carry["h_att"], st["weights"], mem, mtb,
                                 mask_add, bundle)[1]
        else:
            x = fd.prenet_plain(carry["frame"], bundle, kw["dropout_rate"],
                                (1, 2), 0)
            w = fd.fwd_attention(carry["h_att"], st["weights"],
                                 st.get("t_prob"), mem, mtb, mask_add, x,
                                 bundle)[1]
    torch.cuda.synchronize()
    if float(w[0, 0]) != -1.0:
        continue
    clk = w[:, 1:11].double().mean(0).tolist()
    prev = 0.0
    for name, c in zip(phases, clk):
        res[f"{{label}}_{{name}}_cycles"] = c - prev
        prev = c
    res[f"{{label}}_total_cycles"] = clk[6]
    # the ends of the first waits for each ring and of the last memory
    # wait, cycles from the start
    for name, c in zip(("mt_wait0_at", "mem_wait0_at", "mem_wait_last_at"),
                       clk[7:]):
        res[f"{{label}}_{{name}}"] = c
    del syn
print("VARIANT_RESULT " + json.dumps(res))
"""
# K1q8: location-sensitive on int8 streams (the 292- and the 548-wide
# memory) beside the flagship's bf16 streams, and the family on int8
# streams; K1fam: the family's bf16 fwd and agent
_TIME_K1Q8 = _TIME_K1_ROWS.replace("@ROWS@", repr([
    ("ls", "location_sensitive", "", ""),
    ("ls_q8", "location_sensitive", "Q8", ""),
    ("ls_q8_548", "location_sensitive", "Q8", "shared"),
    ("fwd_q8", "forward", "Q8", ""),
    ("trans_q8", "forward_transition_agent", "Q8", "")]))
_TIME_K1FAM = _TIME_K1_ROWS.replace("@ROWS@", repr([
    ("fwd", "forward", "", ""),
    ("trans", "forward_transition_agent", "", "")]))

# K1f32fam: the family's float32 instances on float32 and on int8
# streams; K1f32fam548: on float32 streams at the shared strategy's
# 548-wide memory
_TIME_K1F32FAM = _TIME_K1_ROWS.replace("@ROWS@", repr([
    ("fwd", "forward", "F32", ""),
    ("trans", "forward_transition_agent", "F32", ""),
    ("fwd_q8", "forward", "F32_Q8", ""),
    ("trans_q8", "forward_transition_agent", "F32_Q8", "")]))
_TIME_K1F32FAM548 = _TIME_K1_ROWS.replace("@ROWS@", repr([
    ("fwd_548", "forward", "F32", "shared"),
    ("trans_548", "forward_transition_agent", "F32", "shared")]))


# K3's LSTM cell backward at the training step's B=50 and the flagship's
# widths (H=1024, A=128, M=80, Mem=292; zoneout), in both compute types:
# its two hosts with and without their cell (the generator's in
# bwd_head, the attention cell in the dq @ Wq^T product, whose K = 128 is
# split in two: the cell runs in the reduction), what each cell adds, and
# both cells alone (bwd_cell's own launch), and a digest of each host's
# cell outputs
_TIME_K3CELL = _PRELUDE + r"""
import hashlib
from types import SimpleNamespace
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
b, a, mem, k, h, m = cs.TRAIN_B, 128, 292, 31, 1024, 80
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
cfg = SimpleNamespace(mmel=m, hidden=h, mem_dim=mem)
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    tc = ftd.TrainConfig(hidden=h, mem_dim=mem, prenet_dim=256, n_prenet=2,
                         mmel=m, att_dim=a, taps=k, dropout_rate=0.5,
                         zoneout_h=0.1, zoneout_c=0.1, use_zoneout=True,
                         dtype=ct)
    act = torch.sigmoid(rnd(b, 4 * h))
    act[:, 2 * h:3 * h] = torch.tanh(rnd(b, h))
    cell = ftd.CellArgs(act.to(ct), rnd(b, h).to(ct), rnd(b, h, scale=0.1),
                        torch.empty(b, 4 * h, dtype=ct, device="cuda"),
                        torch.empty(b, h, device="cuda"),
                        tc.reg("gen", (11, 12), 5))
    w = torch.zeros(m + 1, 1344, device="cuda")
    w[:, :h + mem] = rnd(m + 1, h + mem, scale=(h + mem) ** -0.5)
    hargs = (rnd(b, m), rnd(b), rnd(b, m), w.to(ct),
             torch.empty(b, m, dtype=ct, device="cuda"), rnd(b, h),
             rnd(b, mem))
    dht = torch.empty(b, h, device="cuda")
    dctx = torch.empty(b, mem, device="cuda")
    dq, wq = rnd(b, a, scale=0.1).to(ct), rnd(h, a, scale=a ** -0.5).to(ct)
    add, out = rnd(b, h, scale=0.1), torch.empty(b, h, device="cuda")
    runs = {{
        "head": lambda: ftd.bwd_head(*hargs, dht, dctx, cfg),
        "head_cell": lambda: ftd.bwd_head(*hargs, None, dctx, cfg,
                                          cell=cell),
        "dq": lambda: ftd.bwd_gemm(dq, wq, False, [(0, h, out, add)]),
        "dq_cell": lambda: ftd.bwd_gemm(dq, wq, False, [(0, h, None, add)],
                                        cell=cell),
        "alone": lambda: ftd.bwd_cell(cell.act, cell.c_prev, add, cell.dc,
                                      cell.dg, cell.dh_reg, cell.reg)}}
    # the outputs of one run of each host with its cell from the same dc,
    # as a number (the first 24 bits of their bytes' SHA-256): two
    # checkouts whose cells agree bit for bit print the same
    dc_init = cell.dc.clone()
    def digest(run):
        cell.dc.copy_(dc_init)
        run()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for o in (cell.dc, cell.dg, cell.dh_reg):
            h.update(o.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return float(int(h.hexdigest()[:6], 16))
    res[f"head_cell_digest_{{name}}"] = digest(runs["head_cell"])
    res[f"dq_cell_digest_{{name}}"] = digest(runs["dq_cell"])
    got = {{key: cs.device_ms(run, iters=50, ours_only=True)
           for key, run in runs.items()}}
    for key, v in got.items():
        res[f"{{key}}_ms_{{name}}"] = v
    res[f"gen_cell_ms_{{name}}"] = got["head_cell"] - got["head"]
    res[f"att_cell_ms_{{name}}"] = got["dq_cell"] - got["dq"]
    res[f"cells_ms_{{name}}"] = (res[f"gen_cell_ms_{{name}}"]
                                 + res[f"att_cell_ms_{{name}}"])
print("VARIANT_RESULT " + json.dumps(res))
"""


# the forward prenet of both decoders at the flagship's widths (M=80,
# P=256, two layers, dropout 0.5) on random inputs, in both compute types:
# K2's train_prenet at the training step's B=50 (a teacher step with its
# raw and per-layer streams), K1's prenet at serving's B=240 (with its keep
# masks)
_TIME_PRENET = _PRELUDE + r"""
import dataclasses
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
m, p, n = 80, 256, 2
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
seeds = (123456789, 987654321)
res = {{}}
for name, ct in (("bf16", torch.bfloat16), ("f32", torch.float32)):
    w = rnd(m * p + (n - 1) * p * p, scale=1 / 16).to(ct)
    bias = rnd(n * p, scale=0.1)
    b = cs.TRAIN_B
    tc = ftd.TrainConfig(hidden=1024, mem_dim=292, prenet_dim=p, n_prenet=n,
                         mmel=m, att_dim=128, taps=31, dropout_rate=0.5,
                         zoneout_h=0.1, zoneout_c=0.1, use_zoneout=True,
                         dtype=ct)
    row = torch.zeros(b, p + 96, dtype=ct, device="cuda")
    targs = (rnd(b, m).to(ct), rnd(b, m), 1, {{"pre_w": w, "pre_b": bias}},
             tc, seeds, 7, torch.empty(b, m, dtype=ct, device="cuda"),
             torch.empty(n, b, p, dtype=ct, device="cuda"), row[:, :p])
    res[f"train_prenet_ms_{{name}}"] = cs.device_ms(
        lambda: ftd.train_prenet(*targs), ours_only=True)
    fields = {{f.name: None for f in dataclasses.fields(fd.DecoderBundle)}}
    fields.update(dtype=ct, quantized=False, pre_w=w, pre_b=bias,
                  pre_dims=(m, p, n))
    bundle = fd.DecoderBundle(**fields)
    frame = rnd(240, m)
    keep = torch.empty(n, 240, p, dtype=torch.uint8, device="cuda")
    out = torch.empty(240, p, device="cuda")
    res[f"prenet_ms_{{name}}"] = cs.device_ms(
        lambda: fd.prenet(frame, bundle, 0.5, seeds, 3, keep_out=keep,
                          out=out), ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


# the float32 gate routine (both of the flagship's LSTMs: K = 1600 and 2368
# zero-padded, H = 1024, train mode) as the build launches it, at the
# training step's B=50 and serving's B=240: device ms of the two launches
_TIME_GATES = _PRELUDE + r"""
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
torch.set_grad_enabled(False)
gen = torch.Generator(device="cuda").manual_seed(0)
reg = (11, 12, 5, 6, 2 ** 31, 2 ** 31, 1, 1.0, 0.5, 0.5)
def rnd(*shape, scale=1.0):
    return torch.randn(*shape, device="cuda", generator=gen) * scale
res = {{}}
for b in (50, 240):
    ops = [(rnd(b, k), rnd(4096, k, scale=k ** -0.5), rnd(4096, scale=0.1),
            rnd(b, 1024), rnd(b, 1024), torch.empty(b, 4096, device="cuda"),
            *(torch.empty(b, 1024, device="cuda") for _ in range(3)))
           for k in (1600, 2368)]
    def run():
        for row, w, bias, h, c, act, c_out, d0, d1 in ops:
            ftd.train_gate_lstm(row, w, bias, reg, h, c, act, c_out, d0, d1)
    res[f"B={{b}}"] = cs.device_ms(run, ours_only=True)
print("VARIANT_RESULT " + json.dumps(res))
"""


def make_copy(name: str) -> Path:
    """The package under build/variants/<name>/ with the variant's pieces
    replaced; its own build directory starts empty."""
    source, *edits, _ = VARIANTS[name]
    if isinstance(source, dict):
        by_source = source
    else:
        by_source = {source: edits[0] if len(edits) == 1 else [tuple(edits)]}
    root = ROOT / "build" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, spans in by_source.items():
        path = root / PKG / ("ops" if source.endswith(".py") else "csrc") \
            / source
        text = path.read_text()
        for span in spans:
            if isinstance(span, Alt):
                span = next((x for x in span if text.count(x[0]) == 1),
                            span[0])
            start, end, repl = span if len(span) == 3 else (span[0], None,
                                                             span[1])
            if text.count(start) != 1:
                raise SystemExit(
                    f"kernel_variants: {name}: the piece to replace occurs "
                    f"{text.count(start)} times in {source}")
            i = text.index(start)
            j = i + len(start) if end is None else text.index(end, i)
            text = text[:i] + repl + text[j:]
        path.write_text(text)
    return root


def run(root: Path, script: str, fault: bool = False, **fmt) -> dict:
    """One run of ``script`` on ``root``'s package.  With ``fault``, a run
    that a kernel stops with a CUDA error (a planted fault that makes the
    kernel fault on the card) counts as one failed check."""
    code = script.format(repo=str(ROOT), root=str(root), **fmt)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(("[variant]", "[kernels", "[train:kernels]")):
            print(f"  {line}")
    for line in proc.stdout.splitlines():
        if line.startswith("VARIANT_RESULT "):
            return json.loads(line[len("VARIANT_RESULT "):])
    errors = [line for line in proc.stderr.splitlines()
              if "CUDA error" in line]
    if fault and errors:
        print(f"  [variant] the run stopped: {errors[0]}")
        return {"failed": [f"the run stopped: {errors[0]}"]}
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    raise SystemExit(f"kernel_variants: the run in {root} failed")


def _kind(name: str) -> str:
    return VARIANTS[name][-1]


# planted faults built at once, one nvcc each (the chip machine's 8 cores)
BUILD_JOBS = 6


def build_copies(roots: dict) -> None:
    """Build each copy's library of the source its phase loads
    (``fused_decoder`` for K1's phases, ``fused_train_decoder`` for K2's
    and K3's, both for the prenets'), BUILD_JOBS copies at a time."""
    from concurrent.futures import ThreadPoolExecutor

    def build(name):
        kind = _kind(name)
        sources = (["fused_decoder", "fused_train_decoder"]
                   if "prenet" in kind else
                   ["fused_decoder"] if "K1" in kind
                   else ["fused_train_decoder"])
        code = (f"import sys; sys.path.insert(0, {str(roots[name])!r}); "
                f"from {PKG}.ops import _build; _build.build({sources!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=roots[name],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: {name} does not build:\n"
                             + proc.stdout[-4000:] + proc.stderr[-4000:])

    with ThreadPoolExecutor(max_workers=BUILD_JOBS) as pool:
        list(pool.map(build, roots))


def faults(names=()) -> dict:
    """Every planted fault, or those of ``names``: the copies built
    BUILD_JOBS at a time, then each fault's checks in turn."""
    out, caught = {}, True
    todo = [name for name in VARIANTS
            if not _kind(name).startswith(("time", "design"))
            and (not names or name in names)]
    roots = {name: make_copy(name) for name in todo}
    build_copies(roots)
    for name in todo:
        phase = _kind(name)
        print(f"[faults] {name} ({phase})")
        res = run(roots[name], _CHECKS, fault=True, phase=phase)
        out[name] = res["failed"]
        caught = caught and bool(res["failed"])
        print(f"[faults] {name}: {len(res['failed'])} check(s) failed")
    if not caught:
        raise SystemExit("kernel_variants: a planted fault passed every "
                         "check: " + json.dumps(out))
    return out


def checks(names) -> dict:
    out = {}
    for name in names:
        if name not in VARIANTS or not _kind(name).startswith("design"):
            raise SystemExit(f"kernel_variants: {name} is not a design "
                             "variant")
        print(f"[checks] {name} ({_kind(name)})")
        root, out[name] = make_copy(name), []
        # the phases, comma-separated
        for phase in _kind(name).split()[1].split(","):
            out[name] += run(root, _CHECKS, phase=phase)["failed"]
        print(f"[checks] {name}: {len(out[name])} check(s) failed")
    return out


def time_variants(names) -> dict:
    out = {}
    copies = {name: make_copy(name) for name in names if name in VARIANTS}
    build_copies(copies)
    for name in names:
        # the variant's timing scripts, comma-separated
        timers = (_kind(name).split()[1].split(",") if name in VARIANTS
                  else [])
        scripts = [globals().get(_TIMERS.get(t, "")) for t in timers]
        if (not scripts or None in scripts
                or not _kind(name).startswith(("time", "design"))):
            raise SystemExit(f"kernel_variants: {name} is not a timing "
                             "variant")
        roots = {"as is": ROOT, name: copies[name]}
        out[name] = {k: [] for k in roots}
        for script in scripts:
            for which in ("as is", name, name, "as is"):
                res = run(roots[which], script)
                out[name][which].append(res)
                print(f"[time] {which}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in res.items()
                    if v is not None))
    return out


# the timing scripts by name, for ``ab``
_TIMERS = {"K1": "_TIME_K1", "K1f32": "_TIME_K1F32", "K1q8": "_TIME_K1Q8",
           "K1fam": "_TIME_K1FAM", "K1trace": "_TIME_K1TRACE", "K2": "_TIME_K2",
           "K2fam": "_TIME_K2FAM", "K3": "_TIME_K3", "K3fam": "_TIME_K3FAM",
           "prenet": "_TIME_PRENET", "gates": "_TIME_GATES",
           "K1f32fam": "_TIME_K1F32FAM", "K1f32fam548": "_TIME_K1F32FAM548",
           "K3cell": "_TIME_K3CELL"}


def ab(base: Path, names) -> dict:
    """Each named timing script on ``base``'s package and on this
    checkout's, in turns (base, this, this, base)."""
    out = {}
    for name in names:
        if name not in _TIMERS:
            raise SystemExit(f"kernel_variants: {name} is not a timing "
                             "script: " + ", ".join(_TIMERS))
        roots = {"base": base.resolve(), "change": ROOT}
        out[name] = {k: [] for k in roots}
        for which in ("base", "change", "change", "base"):
            res = run(roots[which], globals()[_TIMERS[name]])
            out[name][which].append(res)
            print(f"[ab] {name} {which}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in res.items() if v is not None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("faults", "checks", "time", "ab"))
    ap.add_argument("names", nargs="*", help="the faults to plant (all "
                    "when none is named), or the variants to check or "
                    "time: " + ", ".join(
                        k for k in VARIANTS
                        if _kind(k).startswith(("time", "design"))))
    ap.add_argument("--base", type=Path, default=None,
                    help="ab: the other checkout, e.g. the parent commit "
                    "unpacked under build/")
    ap.add_argument("--root", type=Path, default=None,
                    help="the checkout whose package is copied and timed "
                    "as is (default: this one), e.g. the parent commit "
                    "unpacked under build/")
    args = ap.parse_intermixed_args()
    if args.root is not None:
        global ROOT
        ROOT = args.root.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    print(f"[variants] {card}")
    run_mode = {"faults": lambda: faults(args.names),
                "checks": lambda: checks(args.names),
                "time": lambda: time_variants(args.names),
                "ab": lambda: ab(args.base, args.names)}[args.what]
    result = {"card": card, args.what: run_mode()}
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"kernel_variants_{args.what}.json").write_text(
        json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
