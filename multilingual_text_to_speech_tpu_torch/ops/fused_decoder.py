"""The serving decoder chunk: CUDA kernels for Hopper and their plain version.

This replaces the JAX package's TPU kernel ``ops/pallas_decoder.py::
_build_kernel`` (driven by ``fused_decode_chunk``), which runs S free-running
decoder steps with all state on chip.  The port keeps WHAT that kernel
computes and none of its Mosaic layout (no A-major flattened band
matrix, lane replication, T-blocked fold or VMEM model).  The Python
wrapper loops over the S steps of a chunk, and each step calls
four kernel functions of ``csrc/fused_decoder.cu``:

1. ``prenet``: the prenet layers with ReLU and the always-on hashed
   dropout, in one launch of thread-block clusters of up to 8 CTAs for each
   16 rows, each CTA a column slice of every layer on the tensor cores, the
   bf16 rows exchanged over distributed shared memory
   (``csrc/tile.cuh::prenet_tile_kernel``, shared with the training
   decoder's ``train_prenet``);
2. ``gate_lstm`` (twice): one fused-gate LSTM in two launches.  A row pass
   assembles each concat row ``[x | context | h]`` once in the compute type
   and, in W8A8 mode, quantizes it per row into an int8 scratch row and its
   scale (``quantize_rows_plain``); the product runs on the tensor cores
   (int8 x int8 -> int32 with mma.sync, or bf16 with float32 sums),
   dequantizes with ``g*rs*ws + b`` and runs the LSTM pointwise step and
   zoneout in its epilogue.  Blocks own whole hidden units, so the i/f/g/o
   columns ``j, H+j, 2H+j, 3H+j`` of a unit meet in one block;
3. ``lsa_attention``: one block per batch row, in thread-block clusters of
   8 rows: the query product on the tensor cores, each CTA over an eighth
   of H for the cluster's 8 rows, summed across the cluster; the 31-tap
   location conv (``lc`` = loc_filter x location_kernel, folded once on
   the host in float32) as a tensor-core product with the band matrix of
   ``cum``, as the TPU kernel folds it; the energy, the masked softmax,
   ``cum += w`` and the context over 16-byte loads of ``memory``; with
   the forward-attention family (``hp.attention_type`` ``forward`` or
   ``forward_transition_agent``) the same kernel without the location conv
   runs as ``fwd_attention``: the unmasked softmax energy, the monotonic
   shift recurrence (gated by the transition agent's ``t_prob``), the
   mask, the 1e-6 floor, the L1 renorm, the context and the agent's next
   ``t_prob``;
4. ``head``: the fused frame and stop projection over the head row
   ``[h_gen | ctx]`` in the compute type, split over K like the
   training decoder's products (``csrc/tile.cuh::splitk_kernel`` and its
   ordered reduction, ``ops/_splitk.py``).  In a chunk the generator LSTM's
   epilogue and ``lsa_attention`` write that row as they finish, so it
   costs no launch of its own.

Every product of the step runs in these kernels; none goes to cuBLAS.  A
chunk allocates every buffer its kernels write once (``_ChunkKernels``):
the row-pass and split-K scratch, the head row, and two of each carry that
the steps take in turns.

What bounds it on the H100: the two gate products, 2*B*(K_att+K_gen)*4H int8
operations a step (7.7 G at the flagship's B=240), are 3.9 us at the card's
1,979 TOP/s int8 tensor rate; a 256-step chunk reads about 42 MB of weights
and attention memory once (12.7 us at 3.35 TB/s), so the chunk is bound by
operations.  The gate products run on the tensor cores but re-read the
gate weights from L2 every step, and every kernel pays a launch a step;
PERF.md has the measured times.

Random bits: the prenet dropout keeps a unit when the lowbias32 counter
hash ``rand_bits(row, col; seed0, seed1, salt = step*n_prenet + layer + 1)``
is below ``keep * 2^32``, as the TPU kernel does.  There the rows are local
to a VMEM batch block; here one block is the whole batch, so the masks equal
the TPU kernel's run with ``block_cap >= B``.

The compute type is bfloat16 or float32 (``DecoderBundle.dtype``, the TPU
kernel's ``dtype``), each kernel a template instance on it: float32 rounds
nothing and keeps every product float32-accurate (the prenet, the exact
gates, the head and the attention's query and location conv on the tensor
cores in three TF32 passes; W8A8's int8 gate product stays).  With ``DecoderBundle.q_streams`` (the TPU
kernel's ``q_streams``) the attention kernels read the memory and the
memory transform as int8 with per-channel scales (``Int8Stream``,
quantized per chunk by ``chunk_operands``).  ``LAUNCHES`` counts each
instance under its own name (``instance``: ``_f32``, ``_q8``).

On a CPU tensor every kernel function runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.  ``decode_chunk_plain`` runs
the plain version on any device and is what the kernels are held against.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from multilingual_text_to_speech_tpu_torch.models.attention import NEG_INF
from multilingual_text_to_speech_tpu_torch.models.rnn import (
    lstm_pointwise,
    zoneout,
)
from multilingual_text_to_speech_tpu_torch.ops import _splitk

Seeds = Tuple[int, int]

_M32 = 0xFFFFFFFF
_K_ALIGN = 64          # gate weight rows are zero-padded to this many inputs
# the head's split aims at one block per SM, not the training products' two:
# at B=240 its 8 output tiles would take 21 slices of the shortest length
# (64), and each block would write as many partial bytes as it reads; one
# block per SM gives 14 slices of 96 (csrc/tile.cuh::splitk_kernel)
_HEAD_BLOCKS_PER_SM = 1

_KERNELS = ("prenet", "gate_lstm", "lsa_attention", "fwd_attention", "head")
_STREAM_KERNELS = ("lsa_attention", "fwd_attention")


def instance(kernel: str, dtype: torch.dtype = torch.bfloat16,
             q_streams: bool = False) -> str:
    """The ``LAUNCHES`` key of ``kernel``'s instance for a compute type and,
    for the attention kernels, int8 streams: ``lsa_attention``,
    ``lsa_attention_f32``, ``lsa_attention_q8``, ``lsa_attention_f32_q8``."""
    name = kernel + ("_f32" if dtype == torch.float32 else "")
    return name + ("_q8" if q_streams and kernel in _STREAM_KERNELS else "")


# launches of each kernel instance since the last reset (kernel launches
# only)
LAUNCHES: Dict[str, int] = {
    instance(k, d, q): 0 for k in _KERNELS
    for d in (torch.bfloat16, torch.float32) for q in (False, True)}


def path_kernels(att_kind: str, dtype: torch.dtype = torch.bfloat16,
                 q_streams: bool = False) -> Tuple[str, ...]:
    """The kernel instances (``LAUNCHES`` keys) that a serving chunk at
    ``att_kind``, compute type ``dtype`` and ``q_streams`` launches: the
    location-sensitive path's ``lsa_attention``, or the forward family's
    ``fwd_attention``."""
    att = "lsa_attention" if att_kind == "ls" else "fwd_attention"
    return tuple(instance(k, dtype, q_streams)
                 for k in ("prenet", "gate_lstm", att, "head"))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the counter hash
# ---------------------------------------------------------------------------

def rand_bits(shape: Tuple[int, int], seed0: int, seed1: int, salt: int,
              device=None) -> torch.Tensor:
    """lowbias32 over ``row*width + col + seed0 + salt*0x9E3779B9`` XOR
    ``seed1*0x85EBCA6B``, as uint32 values held in int64.  int64 products
    wrap, but their low 32 bits are right, and every step masks to them."""
    rows, width = shape
    x = (torch.arange(rows, device=device)[:, None] * width
         + torch.arange(width, device=device)[None, :]) & _M32
    x = (x + seed0 + ((salt * 0x9E3779B9) & _M32)) & _M32
    x = x ^ ((seed1 * 0x85EBCA6B) & _M32)
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def keep_threshold(dropout_rate: float) -> int:
    return min(int((1.0 - dropout_rate) * float(2 ** 32)), 2 ** 32 - 1)


def hashed_dropout(x: torch.Tensor, rate: float, seeds: Seeds, salt: int,
                   keep_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout of a [B, W] tensor with the counter hash's mask."""
    if rate <= 0.0:
        return x
    keep = rand_bits(tuple(x.shape), seeds[0], seeds[1], salt,
                     x.device) < keep_threshold(rate)
    if keep_out is not None:
        keep_out.copy_(keep)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def draw_seeds(generator: torch.Generator) -> Seeds:
    """One chunk's (seed0, seed1) pair of uint32 from a CPU generator."""
    s = torch.randint(0, 2 ** 32, (2,), generator=generator,
                      dtype=torch.int64)
    return int(s[0]), int(s[1])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@dataclass
class DecoderBundle:
    """The decoder weights in the layouts the kernels read.  Gate weights
    are ``[4H, K_pad]`` and the frame and stop head ``[M + 1, K_pad]`` (one
    row per output column, inputs contiguous, zero columns padding K to a
    multiple of 64); the prenet kernels are ``[in, out]``.  Zero padding
    changes neither the per-column scales nor the per-row activation
    amax."""
    dtype: torch.dtype
    quantized: bool
    pre_w: torch.Tensor          # flat concat of the [in, out] kernels
    pre_b: torch.Tensor          # flat concat of the biases, float32
    pre_dims: Tuple[int, int, int]   # (input width, prenet width, layers)
    att_w: torch.Tensor
    att_ws: Optional[torch.Tensor]   # [4H] float32 column scales (W8A8)
    att_b: torch.Tensor
    gen_w: torch.Tensor
    gen_ws: Optional[torch.Tensor]
    gen_b: torch.Tensor
    wq: torch.Tensor             # [H, A]
    att_bias: torch.Tensor       # [A] float32
    lc: Optional[torch.Tensor]   # [K, A] folded location conv, compute
                                 # type (location-sensitive only)
    v: torch.Tensor              # [A] float32
    head_w: torch.Tensor         # [M + 1, K_pad], K = H + Mem
    head_b: torch.Tensor         # [M + 1] float32
    att_kind: str = "ls"         # "ls", "fwd" or "fwd_trans"
    # the transition agent's weight split as the TPU kernel splits it
    # (pallas_decoder.py:88-102): its context, h_att and prenet-output
    # rows in the compute type, and its bias [1] in float32
    ta_wc: Optional[torch.Tensor] = None     # [Mem]
    ta_wq: Optional[torch.Tensor] = None     # [H]
    ta_wx: Optional[torch.Tensor] = None     # [P]
    ta_b: Optional[torch.Tensor] = None      # [1]
    # int8 memory and memory-transform streams (``chunk_operands``)
    q_streams: bool = False

    def prenet_layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        in_dim, p, n = self.pre_dims
        layers, wo, bo = [], 0, 0
        for i in range(n):
            k = in_dim if i == 0 else p
            layers.append((self.pre_w[wo:wo + k * p].view(k, p),
                           self.pre_b[bo:bo + p]))
            wo, bo = wo + k * p, bo + p
        return layers


def _div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127`` as an IEEE division on every device: PyTorch divides a
    CUDA tensor by a Python scalar as a product with its reciprocal, which
    can differ by an ulp from the JAX package's division."""
    return x / torch.full_like(x, 127.0)


def _quantize_columns(w: torch.Tensor):
    """Symmetric per-output-column int8: ``w ~= q * scale``.  ``w`` is
    [4H, K] (one row per output column)."""
    wf = w.float()
    scale = _div127(torch.clamp(wf.abs().amax(dim=1), min=1e-8))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def _pad_k(w: torch.Tensor) -> torch.Tensor:
    pad = (-w.shape[1]) % _K_ALIGN
    return torch.nn.functional.pad(w, (0, pad)).contiguous()


@torch.no_grad()
def extract_decoder_bundle(cell, dtype: torch.dtype, quantize_gates: bool,
                           q_streams: bool = False) -> DecoderBundle:
    """Slice a ``DecoderCell``'s parameters into the kernels' operands;
    ``q_streams``: the attention reads int8 streams."""
    fcs = [getattr(cell.prenet, f"fc{i}")
           for i in range(cell.prenet.num_layers)]
    att = cell.attention
    f32 = torch.float32

    def gates(lstm):
        w = lstm.cell.gates.weight                     # [4H, K]
        if quantize_gates:
            q, scale = _quantize_columns(w)
            return _pad_k(q), scale.contiguous(), lstm.cell.gates.bias.float()
        return _pad_k(w.to(dtype)), None, lstm.cell.gates.bias.float()

    att_w, att_ws, att_b = gates(cell.attention_lstm)
    gen_w, gen_ws, gen_b = gates(cell.generator_lstm)
    head_w = torch.cat([cell.frame_prediction.weight,
                        cell.stop_prediction.weight], 0)
    head_b = torch.cat([cell.frame_prediction.bias,
                        cell.stop_prediction.bias])
    if hasattr(att, "energy_net"):          # the forward family
        en = att.energy_net
        wq, v, lc = en.query.weight.t(), en.energy.weight.reshape(-1), None
        kind = "fwd_trans" if hasattr(att, "transition_agent") else "fwd"
    else:
        wq, v, kind = att.query_kernel, att.energy_kernel.reshape(-1), "ls"
        lc = (att.loc_filter[:, 0, :].float()
              @ att.location_kernel.float()).to(dtype).contiguous()
    agent = {}
    if kind == "fwd_trans":
        mem = cell.generator_lstm.cell.gates.in_features - 2 * wq.shape[0]
        ta = att.transition_agent.weight.reshape(-1)
        parts = torch.split(ta, [mem, wq.shape[0], ta.numel() - mem
                                 - wq.shape[0]])
        agent = dict(zip(("ta_wc", "ta_wq", "ta_wx"),
                         (p.to(dtype).contiguous() for p in parts)))
        agent["ta_b"] = att.transition_agent.bias.float().contiguous()
    return DecoderBundle(
        dtype=dtype, quantized=quantize_gates,
        pre_w=torch.cat([fc.weight.t().reshape(-1) for fc in fcs]).to(dtype),
        pre_b=torch.cat([fc.bias for fc in fcs]).to(f32),
        pre_dims=(fcs[0].in_features, fcs[0].out_features, len(fcs)),
        att_w=att_w, att_ws=att_ws, att_b=att_b,
        gen_w=gen_w, gen_ws=gen_ws, gen_b=gen_b,
        wq=wq.to(dtype).contiguous(),
        att_bias=att.energy_bias.reshape(-1).float().contiguous(),
        lc=lc, v=v.float().contiguous(),
        head_w=_pad_k(head_w.to(dtype)),
        head_b=head_b.float().contiguous(), att_kind=kind,
        q_streams=bool(q_streams), **agent)


class Int8Stream(NamedTuple):
    """A stream of the attention stored as int8 with a scale per channel
    (its last dimension), ``x ~= q * scale`` (the TPU kernel's
    ``q_streams``): ``q`` [B, T, C] int8; ``scale`` [C], float32 for the
    memory, whose scale multiplies the context after the sum over T, and in
    the compute type for the memory transform, which is dequantized in the
    compute type (``pallas_decoder.py:571-572``, ``:626-634``, ``:1002``)."""
    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


Stream = Union[torch.Tensor, Int8Stream]

# the JAX kernel pads T past 256 to a multiple of 128 before it quantizes
# the memory transform (ops/pallas_decoder.py:143-149, :931-937)
_SINGLE_FOLD_MAX, _T_BLOCK = 256, 128


def quantize_lastdim(x: torch.Tensor, floor: Optional[torch.Tensor] = None):
    """Symmetric int8 per last-dimension channel over every leading axis,
    ``x ~= q * scale``, in ``_quantize_lastdim``'s op order (pallas_decoder.
    py:257-266): ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x /
    scale), -127, 127)`` -> (q int8, scale [C] float32).  ``floor`` [C]
    joins the amax (values the JAX kernel's padding adds)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(x.dim() - 1)))
    if floor is not None:
        amax = torch.maximum(amax, floor.abs())
    scale = _div127(torch.clamp(amax, min=1e-8))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale.contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the compute type, held in float32."""
    return x.to(dtype).float()


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Compute-type inputs, float32 sums (a float32 product of the rounded
    values)."""
    return _rounded(x, w.dtype) @ w.float()


_INV127 = 1.0 / 127.0


def prenet_plain(frame: torch.Tensor, bundle: DecoderBundle,
                 dropout_rate: float, seeds: Seeds, step: int,
                 keep_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, M] previous frame -> [B, P] float32.  ``keep_out`` (uint8
    [layers, B, P]) receives the dropout keep masks."""
    layers = bundle.prenet_layers()
    x = frame
    for i, (w, b) in enumerate(layers):
        x = torch.relu(_mm(x, w) + b)
        x = hashed_dropout(x, dropout_rate, seeds,
                           step * len(layers) + i + 1,
                           None if keep_out is None else keep_out[i])
    return x


def quantize_rows_plain(row: torch.Tensor):
    """W8A8's per-row activation quantization, the row pass of
    ``gate_lstm``: ``rs = max(amax, 1e-6) * (1/127)`` and ``q = clip(
    round(row * (1/rs)), -127, 127)`` in that op order -> (q [B, K] holding
    integers in float32, rs [B, 1])."""
    amax = row.abs().amax(dim=1, keepdim=True)
    rs = torch.clamp(amax, min=1e-6) * torch.tensor(
        _INV127, dtype=torch.float32, device=row.device)
    q = torch.clamp(torch.round(row * torch.reciprocal(rs)), -127, 127)
    return q, rs


def gate_lstm_plain(segments: Tuple[torch.Tensor, ...], h: torch.Tensor,
                    c: torch.Tensor, bundle: DecoderBundle, which: str,
                    zoneout_h: float, zoneout_c: float,
                    q_out: Optional[torch.Tensor] = None):
    """One fused-gate LSTM over the concat row of ``segments`` (float32
    [B, K_i] each) -> (h_new, c_new).  ``which`` is "att" or "gen".
    ``q_out`` (int8 [B, K]) receives the quantized row in W8A8 mode."""
    w, ws, b = (getattr(bundle, f"{which}_{n}") for n in ("w", "ws", "b"))
    row = _rounded(torch.cat(segments, dim=1), bundle.dtype)
    k = row.shape[1]
    if bundle.quantized:
        q, rs = quantize_rows_plain(row)
        if q_out is not None:
            q_out.copy_(q.to(torch.int8))
        # exact integer sums: |sum| < 2^31 fits a float64 mantissa
        acc = (q.double() @ w[:, :k].double().t()).float()
        gates = acc * rs * ws + b
    else:
        gates = row @ w[:, :k].float().t() + b
    h_new, c_new = lstm_pointwise(gates, c)
    return zoneout(h, h_new, zoneout_h), zoneout(c, c_new, zoneout_c)


def _mt_values(mtb: Stream, d: torch.dtype) -> torch.Tensor:
    """The memory transform plus bias as the energy reads it, float32
    holding compute-type values: int8 streams dequantized in the compute
    type with the scale row already in it (``pallas_decoder.py:571-572``)."""
    if isinstance(mtb, Int8Stream):
        return _rounded(mtb.q.float() * mtb.scale.float(), d)
    return mtb.float()


def _context(memory: Stream, w: torch.Tensor, d: torch.dtype):
    """sum_t round_d(memory[t] * round_d(w[t])) in float32; int8 streams
    multiply the float32 channel scale after the sum
    (``pallas_decoder.py:626-634``)."""
    if isinstance(memory, Int8Stream):
        ctx = _rounded(memory.q.float() * _rounded(w, d)[:, :, None],
                       d).sum(1)
        return ctx * memory.scale
    return _rounded(memory.float() * _rounded(w, d)[:, :, None], d).sum(1)


def _location_conv(cum: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """[B, T] (compute-type values) x the folded filter [K, A] -> [B, T, A]
    float32: ``loc[t] = sum_k cum[t + k - (K - 1) // 2] lc[k]`` (zero
    outside [0, T)) as a float32 product of the windows, which PyTorch
    runs in full float32 on the card too (a cuDNN convolution may take
    TF32 or a transform algorithm)."""
    k = lc.shape[0]
    half = (k - 1) // 2
    windows = torch.nn.functional.pad(cum, (half, k - 1 - half)).unfold(
        1, k, 1)                                                  # [B, T, K]
    return windows @ lc.float()


def lsa_attention_plain(h_att: torch.Tensor, cum: torch.Tensor,
                        memory: Stream, mtb: Stream,
                        mask_add: torch.Tensor, bundle: DecoderBundle):
    """Location-sensitive attention step -> (context [B, Mem], cum [B, T]).
    ``memory`` [B, T, Mem] and ``mtb`` (memory transform plus the attention
    bias) [B, T, A] are in the compute type, or ``Int8Stream``s;
    ``mask_add`` is 0 or -1e9.  Rounds to the compute type where the TPU
    kernel does."""
    d = bundle.dtype
    q = _rounded(_mm(h_att, bundle.wq), d)                        # [B, A]
    loc = _location_conv(_rounded(cum, d), bundle.lc)
    z = _rounded(_rounded(_rounded(loc, d) + q[:, None, :], d)
                 + _mt_values(mtb, d), d)
    e = (_rounded(torch.tanh(z), d) * bundle.v).sum(-1) + mask_add
    w = torch.softmax(e, dim=-1)
    return _context(memory, w, d), cum + w


def fwd_attention_plain(h_att: torch.Tensor, prev: torch.Tensor,
                        t_prob: Optional[torch.Tensor], memory: Stream,
                        mtb: Stream, mask_add: torch.Tensor,
                        x: torch.Tensor, bundle: DecoderBundle):
    """The forward family's attention step -> (context [B, Mem], weights
    [B, T], next t_prob [B, 1] or None).  ``prev`` [B, T] are the last
    step's weights, ``t_prob`` [B, 1] the transition probability (the agent
    only), ``x`` [B, P] the prenet output of this step; the other operands
    as ``lsa_attention_plain``'s.  The softmax energy is unmasked over the
    T positions given; the mask zeroes the recurrence's weights, which are
    then floored at 1e-6 and L1-renormalized (``pallas_decoder.py:
    593-624``).  Rounds to the compute type where the TPU kernel does: the
    shifted weights are a compute-type product, and the agent's three
    products take compute-type operands with float32 sums."""
    d = bundle.dtype
    q = _rounded(_mm(h_att, bundle.wq), d)                        # [B, A]
    z = _rounded(q[:, None, :] + _mt_values(mtb, d), d)
    energy = torch.softmax((_rounded(torch.tanh(z), d) * bundle.v).sum(-1),
                           dim=-1)
    shifted = torch.nn.functional.pad(_rounded(prev, d), (1, 0))[:, :-1]
    if t_prob is None:
        comb = prev + shifted
    else:
        comb = (1.0 - t_prob) * prev + t_prob * shifted
    w = torch.where(mask_add > -0.5, comb * energy, torch.zeros_like(comb))
    w = torch.clamp(w, min=1e-6)
    w = w / w.sum(-1, keepdim=True)
    ctx = _context(memory, w, d)
    if t_prob is None:
        return ctx, w, None
    lin = (_mm(ctx, bundle.ta_wc[:, None]) + _mm(h_att, bundle.ta_wq[:, None])
           + _mm(x, bundle.ta_wx[:, None]) + bundle.ta_b)
    return ctx, w, torch.sigmoid(lin)


def attention_plain(h_att: torch.Tensor, state, x: torch.Tensor,
                    memory: Stream, mtb: Stream,
                    mask_add: torch.Tensor, bundle: DecoderBundle):
    """The attention step of ``bundle.att_kind`` on the carry's attention
    ``state`` -> (context, new state), the plain versions of
    ``lsa_attention`` and ``fwd_attention``."""
    if bundle.att_kind == "ls":
        ctx, cum = lsa_attention_plain(h_att, state["weights"], memory, mtb,
                                       mask_add, bundle)
        return ctx, {"weights": cum}
    ctx, w, tp = fwd_attention_plain(h_att, state["weights"],
                                     state.get("t_prob"), memory, mtb,
                                     mask_add, x, bundle)
    return ctx, _fwd_state(w, tp)


def _fwd_state(w: torch.Tensor, t_prob: Optional[torch.Tensor]):
    """The forward family's carried attention state."""
    return {"weights": w} if t_prob is None else {"weights": w,
                                                   "t_prob": t_prob}


def head_plain(h_gen: torch.Tensor, ctx: torch.Tensor,
               bundle: DecoderBundle):
    """Frame and stop heads over ``[h_gen | ctx]`` -> (frame [B, M],
    stop logit [B])."""
    row = torch.cat([h_gen, ctx], dim=1)
    fv = _mm(row, bundle.head_w[:, :row.shape[1]].t()) + bundle.head_b
    mmel = fv.shape[1] - 1
    return fv[:, :mmel], fv[:, mmel]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    "prenet_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _I, _U,
                      _F, _I, _I, _I, _I, _P],
    "gate_lstm_launch": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P,
                         _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _P],
    "lsa_attention_launch": [_P] * 11 + [_I] * 8 + [_P] * 2 + [_I] * 4
    + [_P],
    "fwd_attention_launch": [_P] * 17 + [_I] * 9 + [_P] * 2 + [_I] * 4
    + [_P],
    "head_launch": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _P, _I, _P],
    "attention_clusters": [_I] * 12,
}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from multilingual_text_to_speech_tpu_torch.ops import _build

        lib = _build.load("fused_decoder")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def _check(name: str, *tensors: Optional[torch.Tensor]) -> None:
    for t in tensors:
        if t is not None and (not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name}: operands must be contiguous CUDA "
                             "tensors")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _f32(bundle: DecoderBundle, *weights: Optional[torch.Tensor]) -> int:
    """The kernels' compute-type flag (1: the float32 instances), after
    checking that ``weights`` are in the bundle's compute type."""
    d = bundle.dtype
    if d not in (torch.bfloat16, torch.float32):
        raise ValueError("the CUDA decoder kernels take bfloat16 or float32 "
                         f"compute; got {d}")
    if any(w is not None and w.dtype != d for w in weights):
        raise ValueError(f"the kernel's weights must be {d}")
    return int(d == torch.float32)


def _q8(bundle: DecoderBundle) -> bool:
    return bool(getattr(bundle, "q_streams", False))


def _streams(name: str, bundle: DecoderBundle, memory: Stream, mtb: Stream):
    """(memory, mtb, memory scale, mtb scale) as an attention launch takes
    them: int8 ``Int8Stream``s with their scales exactly when the bundle
    has ``q_streams``, else compute-type tensors and no scales."""
    q8 = _q8(bundle)
    if q8 != isinstance(memory, Int8Stream) or q8 != isinstance(mtb,
                                                                 Int8Stream):
        raise ValueError(f"{name}: int8 streams (Int8Stream memory and "
                         "memory transform) exactly when the bundle's "
                         "q_streams is set")
    if not q8:
        if memory.dtype != bundle.dtype or mtb.dtype != bundle.dtype:
            raise ValueError(f"{name}: memory and memory transform must be "
                             f"{bundle.dtype}")
        return memory, mtb, None, None
    if (memory.q.dtype != torch.int8 or mtb.q.dtype != torch.int8
            or memory.scale.dtype != torch.float32
            or mtb.scale.dtype != bundle.dtype):
        raise ValueError(f"{name}: int8 streams with a float32 memory scale "
                         f"and a {bundle.dtype} memory-transform scale")
    return memory.q, mtb.q, memory.scale, mtb.scale


def _row_view(name: str, t: Optional[torch.Tensor],
              dtype: torch.dtype) -> int:
    """The row stride of a destination view ``t`` in the compute type (rows
    of a larger buffer, unit stride in the last dimension); 0 for None."""
    if t is None:
        return 0
    if not t.is_cuda or t.dtype != dtype or t.stride(-1) != 1:
        raise ValueError(f"{name}: the head row must be a {dtype} CUDA "
                         "view with unit stride in its last dimension")
    return t.stride(0)


def _outputs(out, *like: Tuple):
    """``out`` (the caller's float32 output tensors, checked) or new ones:
    each of ``like`` is ``(shape, reference tensor)``."""
    if out is None:
        return tuple(torch.empty(shape, device=ref.device)
                     for shape, ref in like)
    _check("out", *out)
    if any(o.dtype != torch.float32 or tuple(o.shape) != tuple(shape)
           for o, (shape, _) in zip(out, like)):
        raise ValueError("out: float32 tensors of shapes "
                         f"{[tuple(s) for s, _ in like]} expected")
    return out


# the prenet kernels' cluster (csrc/tile.cuh prenet_tile_kernel, the
# training decoder's bwd_prenet): at most this many CTAs, each whole 8-column
# mma tiles of every layer's output; the float32 forward prenets at up to
# _PRENET_WIDE_ROWS rows take non-portable clusters of up to 16 (on an
# H100 at B=50, 0.0107 -> 0.0090 ms in float32 and no change in bf16; at
# B=240 16 read slower, 0.0109 -> 0.0138: PERF.md)
_PRENET_CLUSTER_MAX, _PRENET_WIDE_CLUSTER_MAX, _PRENET_WIDE_ROWS = 8, 16, 64


def prenet_wide(dtype: torch.dtype, b: int) -> bool:
    """Whether a forward prenet launch over ``b`` rows in ``dtype`` takes
    the wide clusters (``prenet_split``'s ``wide``)."""
    return dtype == torch.float32 and b <= _PRENET_WIDE_ROWS


def prenet_split(in_dim: int, p: int, wide: bool = False
                 ) -> Tuple[int, int, int]:
    """``(cluster, cols_p, cols_in)`` of the prenet kernels (this module's
    ``prenet``, the training decoder's ``train_prenet`` and ``bwd_prenet``):
    each CTA's share of P's columns, the fewest whole 8-column tiles such
    that at most 8 CTAs (16 when ``wide``: the forward prenets only) cover
    P, as many CTAs as that needs (none empty), and each CTA's share of the
    input frame's columns, which only the backward splits (the last shares
    may reach past M, or be empty).  P=256, M=80 gives 8 CTAs of 32 and 16
    columns, or 16 of 16 when wide."""
    if in_dim < 1 or p < 1:
        raise ValueError(f"the prenet needs M, P >= 1, got {in_dim}, {p}")
    cdiv = _splitk._cdiv
    tiles = cdiv(p, 8)
    per = cdiv(tiles, _PRENET_WIDE_CLUSTER_MAX if wide
               else _PRENET_CLUSTER_MAX)
    cluster = cdiv(tiles, per)
    return cluster, 8 * per, 8 * cdiv(cdiv(in_dim, 8), cluster)


def prenet(frame, bundle, dropout_rate, seeds, step, keep_out=None,
           out=None):
    """Kernel ``prenet`` (see ``prenet_plain``); writes ``out`` [B, P] when
    given.  One launch: a cluster of CTAs for each 16 rows, each CTA a
    column slice of every layer (``prenet_split``)."""
    if not _is_cuda(frame):
        return prenet_plain(frame, bundle, dropout_rate, seeds, step,
                            keep_out)
    f32 = _f32(bundle, bundle.pre_w)
    frame = frame.float().contiguous()
    in_dim, p, n = bundle.pre_dims
    b = frame.shape[0]
    (out,) = _outputs(None if out is None else (out,), ((b, p), frame))
    if keep_out is not None and keep_out.dtype != torch.uint8:
        raise ValueError("keep_out must be uint8")
    _check("prenet", frame, bundle.pre_w, bundle.pre_b, keep_out)
    drop = dropout_rate > 0.0
    cluster, cols_p, _ = prenet_split(in_dim, p,
                                      prenet_wide(bundle.dtype, b))
    err = _lib().prenet_launch(
        _ptr(frame), _ptr(bundle.pre_w), _ptr(bundle.pre_b), _ptr(out),
        _ptr(keep_out), b, in_dim, p, n, seeds[0] & _M32, seeds[1] & _M32,
        step, keep_threshold(dropout_rate) if drop else 0,
        1.0 / (1.0 - dropout_rate) if drop else 1.0, int(drop), cluster,
        cols_p, f32, _stream())
    _launched(instance("prenet", bundle.dtype), err)
    return out


def gate_row_scratch(b: int, weights, device):
    """Scratch of ``gate_lstm``'s row pass, for any of the gate ``weights``
    ([4H, K_pad] each): the concat row of each of ``b`` batch rows in the
    weights' type (int8, bf16 or float32), zero padded to K_pad and held as
    bytes, and the row scales [b] (read only in W8A8)."""
    width = max(w.shape[1] * w.element_size() for w in weights)
    return (torch.empty(b, width, dtype=torch.uint8, device=device),
            torch.empty(b, dtype=torch.float32, device=device))


def gate_lstm(segments, h, c, bundle, which, zoneout_h, zoneout_c,
              q_out=None, scratch=None, h_row=None, out=None):
    """Kernel ``gate_lstm`` (see ``gate_lstm_plain``).  ``scratch`` is the
    row pass's (``gate_row_scratch``); without one the call gets its own.
    ``h_row`` (a [B, H] view in the compute type) also receives h_new;
    ``out`` are the (h_new, c_new) to write, new ones if None."""
    if not _is_cuda(h):
        return gate_lstm_plain(segments, h, c, bundle, which, zoneout_h,
                               zoneout_c, q_out)
    f32 = _f32(bundle)
    w, ws, bias = (getattr(bundle, f"{which}_{n}") for n in ("w", "ws", "b"))
    if w.dtype != (torch.int8 if bundle.quantized else bundle.dtype):
        raise ValueError(f"gate_lstm: {which} gate weights of {w.dtype}")
    s0, s1, s2 = (s.float().contiguous() for s in segments)
    b, hidden = h.shape
    h = h.contiguous()
    c = c.contiguous()
    h_new, c_new = _outputs(out, (h.shape, h), (c.shape, c))
    if q_out is not None and q_out.dtype != torch.int8:
        raise ValueError("q_out must be int8")
    _check("gate_lstm", s0, s1, s2, w, ws, bias, h, c, q_out)
    ld_row = _row_view("gate_lstm", h_row, bundle.dtype)
    row_buf, rs_buf = (gate_row_scratch(b, (w,), h.device) if scratch is None
                       else scratch)
    if (row_buf.numel() < b * w.shape[1] * w.element_size()
            or rs_buf.numel() < b):
        raise ValueError("gate_lstm: the row scratch is too small")
    err = _lib().gate_lstm_launch(
        _ptr(s0), s0.shape[1], _ptr(s1), s1.shape[1], _ptr(s2), s2.shape[1],
        _ptr(w), _ptr(ws), _ptr(bias), w.shape[1], int(bundle.quantized),
        f32, _ptr(row_buf), _ptr(rs_buf), _ptr(h), _ptr(c), _ptr(h_new),
        _ptr(c_new), _ptr(h_row), ld_row, _ptr(q_out), b, hidden,
        float(zoneout_h), float(zoneout_c), _stream())
    _launched(instance("gate_lstm", bundle.dtype), err)
    return h_new, c_new


# the staged attention instances' rings (csrc/fused_decoder.cu
# StreamPlan: bf16 compute on int8 streams, and the forward family on bf16
# streams): bytes of the memory transform's ring and of the memory's, and
# their slots at most
_MT_RING_BYTES, _MT_SLOTS = 32 * 1024, 2
_MEM_RING_BYTES, _MEM_SLOTS = 56 * 1024, 3


def ctx_period(mem_dim: int, stream_bytes: int) -> int:
    """The rows a period of the context's 16-byte chunk scheme
    (``csrc/tile.cuh`` CtxScheme): a row of ``mem_dim`` elements of
    ``stream_bytes`` is 16-byte aligned every that many rows."""
    v = 16 // stream_bytes
    return v // math.gcd(mem_dim, v)


def att_stream_tiles(t: int, a: int, mem_dim: int, stream_bytes: int
                     ) -> Tuple[int, int, int, int]:
    """``(mt_tile, mt_stages, mem_tile, mem_stages)``: the positions a tile
    and the slots of the rings in which the staged attention instances
    copy a row's memory transform ([T, A]) and memory ([T, Mem]) streams of
    ``stream_bytes`` an element into shared memory (the launchers take a
    plan for every instance; the unstaged ones, float32 streams among
    them, ignore it).  The memory
    transform's tiles are whole 16-position mma tiles, as many as fill half
    its ring's bytes (128 positions of int8 at A=128, 64 of bf16), in up to
    two slots; the memory's whole periods of the context's chunks
    (``ctx_period``), as many as fill a third of its ring's (64 positions
    of an int8 row of 292 bytes, 32 of bf16), in up to three.  Tile ``j``
    covers the positions ``[j * tile, min(T, (j + 1) * tile))`` and takes
    slot ``j % stages``."""
    if min(t, a, mem_dim) < 1 or stream_bytes not in (1, 2, 4):
        raise ValueError("att_stream_tiles: T, A, Mem >= 1 and streams of "
                         "1, 2 or 4 bytes")
    cdiv = _splitk._cdiv
    mt_rows = _MT_RING_BYTES // _MT_SLOTS // (a * stream_bytes)
    mt_tile = min(cdiv(t, 16) * 16, max(16, mt_rows // 16 * 16))
    period = ctx_period(mem_dim, stream_bytes)
    mem_rows = _MEM_RING_BYTES // _MEM_SLOTS // (mem_dim * stream_bytes)
    mem_tile = min(cdiv(t, period) * period,
                   max(period, mem_rows // period * period))
    return (mt_tile, min(_MT_SLOTS, cdiv(t, mt_tile)), mem_tile,
            min(_MEM_SLOTS, cdiv(t, mem_tile)))


def attention_clusters(att_kind: str, dtype: torch.dtype, q_streams: bool,
                       b: int, t: int, hidden: int, a: int,
                       mem_dim: int) -> int:
    """The clusters of 8 CTAs of one K1 attention launch (``lsa_attention``
    or ``fwd_attention``, ``att_kind`` "ls", "fwd" or "fwd_trans") at
    these shapes that the card holds at once
    (``cudaOccupancyMaxActiveClusters``); the launch has ceil(B / 8)."""
    kind = {"ls": 0, "fwd": 1, "fwd_trans": 2}[att_kind]
    ss = 1 if q_streams else torch.empty(0, dtype=dtype).element_size()
    n = _lib().attention_clusters(
        kind, int(dtype == torch.float32), int(q_streams), b, t, hidden, a,
        mem_dim, *att_stream_tiles(t, a, mem_dim, ss))
    if n < 0:
        raise RuntimeError(f"attention_clusters: CUDA error {-n}")
    return n


def lsa_attention(h_att, cum, memory, mtb, mask_add, bundle, ctx_row=None,
                  out=None):
    """Kernel ``lsa_attention`` (see ``lsa_attention_plain``).  ``ctx_row``
    (a [B, Mem] view in the compute type) also receives the context;
    ``out`` are the (context, cum) to write, new ones if None."""
    if not _is_cuda(h_att):
        return lsa_attention_plain(h_att, cum, memory, mtb, mask_add, bundle)
    f32 = _f32(bundle, bundle.wq, bundle.lc)
    mem, mt, mem_scale, mt_scale = _streams("lsa_attention", bundle, memory,
                                            mtb)
    b, t, mem_dim = mem.shape
    h_att, cum, mask_add = (x.float().contiguous()
                            for x in (h_att, cum, mask_add))
    ctx, cum_new = _outputs(out, ((b, mem_dim), h_att), (cum.shape, cum))
    _check("lsa_attention", h_att, cum, mem, mt, mask_add, bundle.wq,
           bundle.lc, bundle.v, mem_scale, mt_scale)
    ld_row = _row_view("lsa_attention", ctx_row, bundle.dtype)
    err = _lib().lsa_attention_launch(
        _ptr(h_att), _ptr(cum), _ptr(mem), _ptr(mt), _ptr(mask_add),
        _ptr(bundle.wq), _ptr(bundle.lc), _ptr(bundle.v), _ptr(ctx),
        _ptr(cum_new), _ptr(ctx_row), ld_row, b, t, h_att.shape[1],
        bundle.wq.shape[1], mem_dim, bundle.lc.shape[0], f32,
        _ptr(mem_scale), _ptr(mt_scale),
        *att_stream_tiles(t, bundle.wq.shape[1], mem_dim, mem.element_size()),
        _stream())
    _launched(instance("lsa_attention", bundle.dtype, _q8(bundle)), err)
    return ctx, cum_new


def fwd_attention(h_att, prev, t_prob, memory, mtb, mask_add, x, bundle,
                  ctx_row=None, out=None):
    """Kernel ``fwd_attention`` (see ``fwd_attention_plain``): the forward
    family's step, ``lsa_attention``'s kernel without the location conv.
    ``x`` is the prenet output of the step, read by the transition agent
    only.  ``ctx_row`` as ``lsa_attention``'s; ``out`` are the (context,
    weights, t_prob [B, 1] or None) to write, new ones if None."""
    if not _is_cuda(h_att):
        return fwd_attention_plain(h_att, prev, t_prob, memory, mtb,
                                   mask_add, x, bundle)
    trans = bundle.att_kind == "fwd_trans"
    f32 = _f32(bundle, bundle.wq, *((bundle.ta_wc, bundle.ta_wq,
                                     bundle.ta_wx) if trans else ()))
    if bundle.att_kind not in ("fwd", "fwd_trans") or trans != (
            t_prob is not None):
        raise ValueError("fwd_attention: a forward-family bundle, and a "
                         "t_prob exactly with the transition agent")
    mem, mt, mem_scale, mt_scale = _streams("fwd_attention", bundle, memory,
                                            mtb)
    b, t, mem_dim = mem.shape
    h_att, prev, mask_add = (v.float().contiguous()
                             for v in (h_att, prev, mask_add))
    like = [((b, mem_dim), h_att), (prev.shape, prev)]
    if trans:
        t_prob, x = t_prob.float().contiguous(), x.float().contiguous()
        like.append(((b, 1), t_prob))
    ctx, w, *tp = _outputs(None if out is None else out[:len(like)], *like)
    tp = tp[0] if trans else None
    _check("fwd_attention", h_att, prev, mem, mt, mask_add, bundle.wq,
           bundle.v, mem_scale, mt_scale,
           *((t_prob, x, bundle.ta_wc, bundle.ta_wq, bundle.ta_wx,
              bundle.ta_b) if trans else ()))
    ld_row = _row_view("fwd_attention", ctx_row, bundle.dtype)
    agent = ((x, bundle.ta_wc, bundle.ta_wq, bundle.ta_wx, bundle.ta_b)
             if trans else (None,) * 5)
    err = _lib().fwd_attention_launch(
        _ptr(h_att), _ptr(prev), _ptr(t_prob), _ptr(mem), _ptr(mt),
        _ptr(mask_add), _ptr(agent[0]), _ptr(bundle.wq), _ptr(bundle.v),
        *(_ptr(a) for a in agent[1:]), _ptr(ctx), _ptr(w), _ptr(tp),
        _ptr(ctx_row), ld_row, b, t, h_att.shape[1], bundle.wq.shape[1],
        mem_dim, bundle.pre_dims[1], int(trans), f32, _ptr(mem_scale),
        _ptr(mt_scale),
        *att_stream_tiles(t, bundle.wq.shape[1], mem_dim, mem.element_size()),
        _stream())
    _launched(instance("fwd_attention", bundle.dtype, _q8(bundle)), err)
    return ctx, w, tp


def head_row(h_gen: torch.Tensor, ctx: torch.Tensor,
             bundle: DecoderBundle) -> torch.Tensor:
    """The head row ``[h_gen | ctx | 0]`` [B, K_pad] in the compute type
    that the ``head`` kernel reads, assembled by PyTorch; in a chunk the
    generator's ``gate_lstm`` and the attention kernel write it instead
    (``h_row``, ``ctx_row``)."""
    row = torch.zeros(h_gen.shape[0], bundle.head_w.shape[1],
                      dtype=bundle.head_w.dtype, device=h_gen.device)
    hidden = h_gen.shape[1]
    row[:, :hidden] = h_gen
    row[:, hidden:hidden + ctx.shape[1]] = ctx
    return row


def head(h_gen, ctx, bundle, row=None, scratch=None, out=None):
    """Kernel ``head`` (see ``head_plain``): the split-K product over the
    head ``row`` (``head_row``'s layout; assembled from ``h_gen`` and
    ``ctx`` if None, which the kernel then does not read) and its ordered
    reduction, split for ``_HEAD_BLOCKS_PER_SM``.  ``scratch`` holds the
    split's partials (``_splitk.split``: one of its own if None); ``out``
    are the (frame, stop) to write, new ones if None."""
    if not _is_cuda(h_gen):
        return head_plain(h_gen, ctx, bundle)
    f32 = _f32(bundle, bundle.head_w)
    b = h_gen.shape[0]
    (n_out, k), m_dim = bundle.head_w.shape, bundle.head_w.shape[0] - 1
    if row is None:
        row = head_row(h_gen, ctx, bundle)
    _row_view("head", row, bundle.dtype)
    if row.shape != (b, k):
        raise ValueError(f"head: the head row must be [{b}, {k}], got "
                         f"{list(row.shape)}")
    frame, stop = _outputs(out, ((b, m_dim), h_gen), ((b,), h_gen))
    _check("head", bundle.head_w, bundle.head_b)
    slices, kslice, part = _splitk.split(_lib(), b, n_out, k, scratch,
                                         h_gen.device, _HEAD_BLOCKS_PER_SM)
    err = _lib().head_launch(
        _ptr(row), row.stride(0), _ptr(bundle.head_w), k,
        _ptr(bundle.head_b), b, n_out, _ptr(frame), _ptr(stop), slices,
        kslice, _ptr(part), f32, _stream())
    _launched(instance("head", bundle.dtype), err)
    return frame, stop


# ---------------------------------------------------------------------------
# the chunk
# ---------------------------------------------------------------------------

def chunk_operands(bundle: DecoderBundle, memory: torch.Tensor,
                   memory_transform: torch.Tensor, mask: torch.Tensor):
    """The attention operands that stay fixed over a chunk, as
    ``lsa_attention`` takes them: ``(memory, memory transform plus the
    attention bias, additive mask 0 / -1e9)``.  The two streams are in the
    compute type, or with ``bundle.q_streams`` ``Int8Stream``s quantized as
    the TPU kernel quantizes them (``pallas_decoder.py:985-1003``): the
    memory in the compute type and the unrounded float32 ``mt + bias`` per
    channel over the whole call (every row of the batch), the memory
    transform's scale row cast to the compute type."""
    d = bundle.dtype
    mask_add = torch.where(mask, 0.0, NEG_INF).float()
    mtb = memory_transform.float() + bundle.att_bias
    if not bundle.q_streams:
        return memory.to(d).contiguous(), mtb.to(d).contiguous(), mask_add
    t = memory.shape[1]
    # rows of padding past T hold the bias alone in the JAX kernel's mtb
    pad = t > _SINGLE_FOLD_MAX and t % _T_BLOCK != 0
    mem_q, mem_scale = quantize_lastdim(memory.to(d))
    mt_q, mt_scale = quantize_lastdim(
        mtb, floor=bundle.att_bias if pad else None)
    return (Int8Stream(mem_q, mem_scale),
            Int8Stream(mt_q, mt_scale.to(d).contiguous()), mask_add)


def _run_chunk(ops, bundle, carry, memory, memory_transform, mask, seeds,
               chunk_frames, dropout_rate, zoneout_h, zoneout_c):
    pre, gate, attend, proj = ops
    memory, mtb, mask_add = chunk_operands(bundle, memory, memory_transform,
                                           mask)
    h_att, c_att = carry["h_att"], carry["c_att"]
    h_gen, c_gen = carry["h_gen"], carry["c_gen"]
    ctx, frame = carry["context"], carry["frame"]
    state = carry["att_state"]
    frames, stops = [], []
    for s in range(int(chunk_frames)):
        x = pre(frame, bundle, dropout_rate, seeds, s)
        h_att, c_att = gate((x, ctx, h_att), h_att, c_att, bundle, "att",
                            zoneout_h, zoneout_c)
        ctx, state = attend(h_att, state, x, memory, mtb, mask_add, bundle)
        h_gen, c_gen = gate((h_att, ctx, h_gen), h_gen, c_gen, bundle,
                            "gen", zoneout_h, zoneout_c)
        frame, stop = proj(h_gen, ctx, bundle)
        frames.append(frame)
        stops.append(stop)
    new_carry = {"h_att": h_att, "c_att": c_att, "h_gen": h_gen,
                 "c_gen": c_gen, "context": ctx, "frame": frame,
                 "att_state": state}
    return new_carry, (torch.stack(frames, 1), torch.stack(stops, 1))


class _ChunkKernels:
    """The kernel functions of one chunk on the card, with the
    signatures of the plain ones, and every buffer they write allocated once
    for the chunk: the row pass's scratch, the head's split-K scratch, the
    head row (written by the generator LSTM and ``lsa_attention``, read by
    ``head``; its pad columns stay zero), the prenet output, two of each
    carry, which the steps write in turns (a step reads the one the step
    before wrote), and one frame and stop logit per step."""

    def __init__(self, bundle: DecoderBundle, carry, memory: torch.Tensor,
                 steps: int):
        h = carry["h_att"]
        b, hidden = h.shape
        dev = h.device

        def pair(*shape):
            return [torch.empty(*shape, device=dev) for _ in range(2)]

        self.gate_scratch = gate_row_scratch(
            b, (bundle.att_w, bundle.gen_w), dev)
        self.head_scratch = _splitk.splitk_scratch(
            _lib(), [(b, *bundle.head_w.shape)], h, _HEAD_BLOCKS_PER_SM)
        self.row = torch.zeros(b, bundle.head_w.shape[1],
                               dtype=bundle.head_w.dtype, device=dev)
        self.h_row = self.row[:, :hidden]
        self.ctx_row = self.row[:, hidden:hidden + memory.shape[2]]
        self.x = torch.empty(b, bundle.pre_dims[1], device=dev)
        self.carries = {"att": (pair(b, hidden), pair(b, hidden)),
                        "gen": (pair(b, hidden), pair(b, hidden)),
                        "ctx": (pair(b, memory.shape[2]),
                                pair(b, memory.shape[1]), pair(b, 1))}
        self.frames = torch.empty(steps, b, bundle.head_w.shape[0] - 1,
                                  device=dev)
        self.stops = torch.empty(steps, b, device=dev)
        self.calls = {"att": 0, "gen": 0, "ctx": 0, "head": 0}

    def _next(self, which: str):
        i = self.calls[which] % 2
        self.calls[which] += 1
        return tuple(c[i] for c in self.carries[which])

    def pre(self, frame, bundle, dropout_rate, seeds, step):
        return prenet(frame, bundle, dropout_rate, seeds, step, out=self.x)

    def gate(self, segments, h, c, bundle, which, zoneout_h, zoneout_c):
        return gate_lstm(segments, h, c, bundle, which, zoneout_h, zoneout_c,
                         scratch=self.gate_scratch,
                         h_row=self.h_row if which == "gen" else None,
                         out=self._next(which))

    def attend(self, h_att, state, x, memory, mtb, mask_add, bundle):
        ctx, w, tp = self._next("ctx")
        if bundle.att_kind == "ls":
            ctx, cum = lsa_attention(h_att, state["weights"], memory, mtb,
                                     mask_add, bundle, ctx_row=self.ctx_row,
                                     out=(ctx, w))
            return ctx, {"weights": cum}
        ctx, w, tp = fwd_attention(h_att, state["weights"],
                                   state.get("t_prob"), memory, mtb, mask_add,
                                   x, bundle, ctx_row=self.ctx_row,
                                   out=(ctx, w, tp))
        return ctx, _fwd_state(w, tp)

    def proj(self, h_gen, ctx, bundle):
        s = self.calls["head"]
        self.calls["head"] += 1
        return head(h_gen, ctx, bundle, row=self.row,
                    scratch=self.head_scratch,
                    out=(self.frames[s], self.stops[s]))


_PLAIN = (prenet_plain, gate_lstm_plain, attention_plain, head_plain)


@torch.no_grad()
def decode_chunk(bundle: DecoderBundle, carry, memory, memory_transform,
                 mask, seeds: Seeds, chunk_frames: int, *,
                 dropout_rate: float, zoneout_h: float, zoneout_c: float):
    """``chunk_frames`` free-running steps -> ``(carry, (spec [B, S, M],
    stop logits [B, S]))``, the contract of the JAX package's
    ``fused_decode_chunk``.  The carry keeps the JAX keys, so chunks chain
    across implementations.  CUDA tensors run the kernels; CPU tensors the
    plain version."""
    kernels = _PLAIN
    if _is_cuda(carry["h_att"]):
        k = _ChunkKernels(bundle, carry, memory, int(chunk_frames))
        kernels = (k.pre, k.gate, k.attend, k.proj)
    return _run_chunk(kernels, bundle, carry, memory, memory_transform,
                      mask, seeds, chunk_frames, dropout_rate, zoneout_h,
                      zoneout_c)


@torch.no_grad()
def decode_chunk_plain(bundle: DecoderBundle, carry, memory,
                       memory_transform, mask, seeds: Seeds,
                       chunk_frames: int, *, dropout_rate: float,
                       zoneout_h: float, zoneout_c: float):
    """The plain PyTorch chunk on any device: the reference the kernels are
    held against."""
    return _run_chunk(_PLAIN, bundle, carry, memory, memory_transform,
                      mask, seeds, chunk_frames, dropout_rate, zoneout_h,
                      zoneout_c)
