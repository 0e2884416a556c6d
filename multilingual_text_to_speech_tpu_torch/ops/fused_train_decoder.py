"""The teacher-forced training decoder: CUDA kernels for Hopper, their plain
versions, and the autograd function that joins them.

This replaces the JAX package's TPU kernels ``ops/pallas_train_decoder.py::
_build_fwd_kernel`` (K2, the forward over a chunk of teacher-forced steps,
writing per-step residuals) and ``::_build_bwd_kernel`` (K3, the reverse-time
backward over those residuals), which ``make_core`` wraps in a custom VJP.
The port keeps what they compute and none of their Mosaic layout (no 128-lane
padding, banded location-conv matrix, T-blocked fold or VMEM model).  A first,
simple design: the Python drivers loop over the steps, and each step
launches the kernels of ``csrc/fused_train_decoder.cu``:

- forward (K2): ``train_prenet`` (teacher selection, layers, hashed
  dropout; one clustered launch, each CTA a column slice of every layer,
  ``prenet_split``, on the tensor cores, as the serving ``prenet``),
  ``train_gate_lstm`` for each LSTM (the bf16 gate product on the
  tensor cores with the LSTM step and train-mode zoneout or dropout in its
  epilogue), ``train_query`` (``bf16(h_att @ Wq)``), ``train_attention``
  (location conv, energy, softmax, cumulative weights, context) and
  ``train_head``; the query and head products split K over the grid like
  ``bwd_gemm`` below; ``train_attention`` splits a batch row over a
  thread-block cluster of CTAs over tiles of its positions
  (``att_bwd_tiles``, as ``att_bwd``), its location conv on the tensor
  cores as a band product;
- backward (K3): ``bwd_head`` (the head backward, one tensor-core launch
  over column tiles of ``[h_gen | ctx]``, with the generator cell's
  backward in its epilogue), ``bwd_gemm`` (``dgates @ W^T`` and ``dq @
  Wq^T`` with the carry additions in its epilogue, K split over the grid
  and the partials summed by a second launch; the ``dq @ Wq^T`` product
  runs the attention cell's backward on its final sums), ``train_query``
  (the energy's query, recomputed),
  ``att_bwd`` (softmax, energy and location-conv backward, with the dmt,
  dlc and dv accumulators per batch row; a cluster of CTAs per batch row
  over tiles of its positions, ``att_bwd_tiles``, each tile whole or on
  long texts in sub-tiles, ``att_bwd_plan``; the location conv's three
  products on the tensor cores as band products) and
  ``bwd_prenet`` (one clustered launch over all rows, each CTA a column
  slice of every layer, ``prenet_split``, the products on the tensor
  cores); after the last step one ``bwd_gemm`` reduces dWq over all steps
  and rows.  The cell backward (``bwd_cell``: the LSTM backward over the
  stored i|f|g|o activations, masks regenerated from the hash) thus runs
  inside the launch that computes its input's last term; its wrapper runs
  it alone.

The forward-attention family (``TrainConfig.att_kind`` "fwd" or
"fwd_trans") runs the same loops with ``train_attention`` and ``att_bwd``
at their family variant: the unmasked softmax energy without a location
conv, the shift recurrence, the mask, the 1e-6 floor and the renorm, the
state ``w`` (not ``cum + w``); with the transition agent, K2 also computes
the next ``t_prob`` from the float32 context, ``h_att`` and prenet output
(a ``t_prob`` stream), and K3's ``att_bwd`` runs the agent's backward in
its prologue: ``dlin = dtp * tp * (1 - tp)``, its context term into the
context cotangent it consumes, its ``h_att`` term into the attention
cell's h cotangent (complete by then) and its prenet term into ``dx``,
to which the attention gates' product then adds.  The agent's weight
gradients are row sums over the streams outside the kernels
(``pallas_train_decoder.py:1472-1490``).

An eval forward (``TrainConfig.train`` False, the JAX package's
``make_train_decode_fn(train=False)``) runs the same K2 kernels with
zoneout's deterministic interpolation, no dropout on the LSTM outputs
(prenet dropout stays on) and no residual streams; it has no backward.

The concat rows the gate products read are residual streams themselves:
``att_in[s] = [x_s | ctx_{s-1} | h_att_{s-1}]``, ``gen_in[s] = [h_att_s |
ctx_s | h_gen_{s-1}]`` and ``head_in[s] = [h_gen_s | ctx_s]``, each zero
padded to a multiple of 64 columns, in the compute type.  The weight
gradients are then ``stream^T @ dgates`` over all F*B rows, large products
that the JAX package also leaves outside its kernel
(``pallas_train_decoder.py:1416-1497``) and that go to ``torch.mm`` here.

The compute type (``TrainConfig.dtype``; the JAX package's ``compute_dtype``)
is bfloat16 or float32.  Every kernel is a template instance on it: float32
rounds nothing, keeps its residual streams in float32 (the JAX kernels write
them "in the compute dtype", ``pallas_train_decoder.py:12-17``) and keeps
every product float32-accurate, as the JAX kernels' float32 matmuls do
(``_mxu_precision``, ``pallas_train_decoder.py:230-239``): the gate, split-K,
head-backward, prenet, ``att_bwd`` and ``train_attention`` band products on
the tensor cores in three TF32 passes.
``LAUNCHES`` counts each instance under its own name (``train_prenet`` and
``train_prenet_f32``, ...: ``instance``; ``path_kernels(att_kind, dtype)``).

Semantics kept exactly: mask element (row, col) of site ``salt`` at global
step ``gs`` draws ``rand_bits(row, col; seed0, seed1, gs*(n_prenet+4) +
salt)`` with prenet layer i at salt i, then att_h, att_c, gen_h, gen_c;
zoneout keeps the new state where the bits are below ``thresh(1-z)``; the
dropout cell drops h at rate ``zoneout_h`` and leaves c alone; the prenet
backward replays ReLU and dropout from ``post-dropout output > 0``.
Residuals are stored in the compute type and read back as such; the plain
versions round at the same places.

On a CPU tensor every kernel function runs its plain version; on a CUDA
tensor it launches the kernel or raises.  ``PLAIN`` holds the plain versions
with the kernels' signatures; the drivers run them with ``plain=True``, on
any device, as the reference the kernels are held against.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multilingual_text_to_speech_tpu_torch.models.attention import (
    NEG_INF,
    att_kind_of,
)
from multilingual_text_to_speech_tpu_torch.ops import _splitk
from multilingual_text_to_speech_tpu_torch.ops.fused_decoder import (
    _M32,
    Seeds,
    _is_cuda,
    _mm,
    _rounded,
    _stream,
    instance,
    keep_threshold,
    prenet_split,
    prenet_wide,
    rand_bits,
)

_K_ALIGN = 64   # concat rows and gate weights are zero-padded to this

_KERNELS = ("train_prenet", "train_gate_lstm", "train_query",
            "train_attention", "train_attention_fwd", "train_head",
            "bwd_head", "bwd_cell", "bwd_gemm", "att_bwd", "att_bwd_fwd",
            "bwd_prenet")
_DTYPES = (torch.bfloat16, torch.float32)
# launches of each kernel instance since the last reset (kernel launches
# only; ``instance``: "train_prenet", "train_prenet_f32", ...).  "bwd_cell"
# counts the launches that run the cell backward: one launch of bwd_cell
# alone, or a bwd_head or bwd_gemm launch with the cell in its epilogue,
# which its own kernel's count holds too
LAUNCHES: Dict[str, int] = {instance(k, d): 0 for k in _KERNELS
                            for d in _DTYPES}
# the kernels of the location-sensitive path; the forward family's path
# runs the "_fwd" variants of the attention kernels instead (path_kernels)
K2_KERNELS = ("train_prenet", "train_gate_lstm", "train_query",
              "train_attention", "train_head")
K3_KERNELS = ("bwd_head", "bwd_cell", "bwd_gemm", "att_bwd", "bwd_prenet")


def path_kernels(att_kind: str, dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The K2 and K3 kernel instances (``LAUNCHES`` keys) that a training
    decode at ``att_kind`` and compute type ``dtype`` launches."""
    fwd = ({} if att_kind == "ls" else
           {"train_attention": "train_attention_fwd",
            "att_bwd": "att_bwd_fwd"})
    return (tuple(instance(fwd.get(k, k), dtype) for k in K2_KERNELS),
            tuple(instance(fwd.get(k, k), dtype) for k in K3_KERNELS))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad64(n: int) -> int:
    return _cdiv(n, _K_ALIGN) * _K_ALIGN


# ---------------------------------------------------------------------------
# configuration and operands
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    """Static shapes and rates of the training decode
    (``pallas_train_decoder._make_cfg``)."""
    hidden: int
    mem_dim: int
    prenet_dim: int
    n_prenet: int
    mmel: int
    att_dim: int
    taps: int
    dropout_rate: float
    zoneout_h: float          # the h dropout rate of a dropout cell
    zoneout_c: float
    use_zoneout: bool
    dtype: torch.dtype
    train: bool = True        # False: the eval/GTA forward, no backward
    att_kind: str = "ls"      # "ls", "fwd" or "fwd_trans"

    @classmethod
    def from_hp(cls, hp, mem_dim: int, dtype: torch.dtype,
                train: bool = True) -> "TrainConfig":
        zo = hp.decoder_regularization == "zoneout"
        return cls(
            hidden=int(hp.decoder_dimension), mem_dim=int(mem_dim),
            prenet_dim=int(hp.prenet_dimension),
            n_prenet=int(hp.prenet_layers), mmel=int(hp.num_mels),
            att_dim=int(hp.attention_dimension),
            taps=int(hp.attention_kernel_size),
            dropout_rate=float(hp.dropout),
            zoneout_h=float(hp.zoneout_hidden if zo else hp.dropout_hidden),
            zoneout_c=float(hp.zoneout_cell) if zo else 0.0,
            use_zoneout=zo, dtype=dtype, train=bool(train),
            att_kind=att_kind_of(hp.attention_type))

    @property
    def kernels(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """The K2 and K3 kernel instances this configuration launches on
        the card (``path_kernels``)."""
        return path_kernels(self.att_kind, self.dtype)

    @property
    def family(self) -> bool:                  # the forward family
        return self.att_kind != "ls"

    @property
    def agent(self) -> bool:                   # the transition agent
        return self.att_kind == "fwd_trans"

    @property
    def ka(self) -> int:                       # [x | ctx | h_att]
        return self.prenet_dim + self.mem_dim + self.hidden

    @property
    def kg(self) -> int:                       # [h_att | ctx | h_gen]
        return 2 * self.hidden + self.mem_dim

    @property
    def kh(self) -> int:                       # [h_gen | ctx]
        return self.hidden + self.mem_dim

    def reg(self, which: str, seeds: Seeds, gs: int) -> Tuple:
        """(seed0, seed1, salt_h, salt_c, thresh_h, thresh_c, mode, scale,
        zh, zc) of one LSTM's regularization at global step ``gs``; in
        train mode, mode 0 none, 1 zoneout, 2 dropout on h; in eval mode, 3
        zoneout's interpolation ``z * old + (1 - z) * new`` and 0 for a
        dropout cell (``pallas_train_decoder.py:376-384``)."""
        n = self.n_prenet
        site_h, site_c = (n, n + 1) if which == "att" else (n + 2, n + 3)
        base = gs * (n + 4)
        zh, zc = self.zoneout_h, self.zoneout_c
        if not self.train:
            mode = 3 if self.use_zoneout else 0
        elif self.use_zoneout:
            mode = 0 if zh == 0.0 and zc == 0.0 else 1
        else:
            mode = 0 if zh == 0.0 else 2
        return (seeds[0] & _M32, seeds[1] & _M32, (base + site_h) & _M32,
                (base + site_c) & _M32, keep_threshold(zh),
                keep_threshold(zc), mode,
                1.0 / (1.0 - zh) if zh < 1.0 else 0.0, zh, zc)

    def prenet_salt(self, gs: int) -> int:
        return (gs * (self.n_prenet + 4)) & _M32


class CellArgs(NamedTuple):
    """The LSTM cell backward's operands besides its h cotangent: the
    stored activations ``act`` [B, 4H] and previous cell state ``c_prev``
    [B, H] (compute type; None at the first step), the cell cotangent carry
    ``dc`` (float32, updated in place), the outputs ``dg`` [B, 4H]
    (compute type) and ``dh_reg`` [B, H] (float32), and ``reg``
    (``TrainConfig.reg``)."""
    act: torch.Tensor
    c_prev: Optional[torch.Tensor]
    dc: torch.Tensor
    dg: torch.Tensor
    dh_reg: torch.Tensor
    reg: Tuple


class AgentArgs(NamedTuple):
    """The transition agent's operands in K2's ``train_attention``: the
    t_prob carry ``tp`` [B] (float32, updated in place), its stream
    ``tp_out`` [B] (float32; None in an eval forward), the step's ``h_att``
    [B, H] and prenet output ``x`` [B, P] (float32), and the agent's weight
    ``w`` [Mem + H + P] and bias ``b`` [1] (float32)."""
    tp: torch.Tensor
    tp_out: Optional[torch.Tensor]
    h_att: torch.Tensor
    x: torch.Tensor
    w: torch.Tensor
    b: torch.Tensor


class FamilyBwd(NamedTuple):
    """The forward family's operands in K3's ``att_bwd``: the additive
    ``mask_add`` [B, T]; with the transition agent, the t_prob that the
    step's recurrence read ``tp_prev`` [B] and the one the step made ``tp``
    [B] (float32 streams), the t_prob cotangent carry ``dtp`` [B] (float32,
    replaced), the pre-sigmoid gradient stream ``dlin`` [B] (float32,
    written), the agent's weight ``w`` [Mem + H + P] (float32), the
    attention LSTM's h cotangent ``dh_att`` [B, H] (float32, added to) and
    the prenet output's ``dx`` [B, P] (float32, written)."""
    mask_add: torch.Tensor
    tp_prev: Optional[torch.Tensor] = None
    tp: Optional[torch.Tensor] = None
    dtp: Optional[torch.Tensor] = None
    dlin: Optional[torch.Tensor] = None
    w: Optional[torch.Tensor] = None
    dh_att: Optional[torch.Tensor] = None
    dx: Optional[torch.Tensor] = None


# operand keys in the order ``TrainDecode`` takes them (location-sensitive;
# ``operand_keys`` gives each attention kind's); the biases, v and the
# transition agent stay float32, the rest is cast to the compute type
OPERAND_KEYS = ("pre_w", "pre_b", "att_w", "att_b", "gen_w", "gen_b", "wq",
                "lc", "v", "head_w", "head_b")
_F32_KEYS = ("pre_b", "att_b", "gen_b", "v", "head_b", "ta_w", "ta_b")


def operand_keys(cfg: "TrainConfig") -> Tuple[str, ...]:
    """``TrainDecode``'s operand keys at ``cfg.att_kind``: the forward
    family has no location conv ``lc``; the transition agent adds its
    weight ``ta_w`` [Mem + H + P] and bias ``ta_b`` [1]."""
    if not cfg.family:
        return OPERAND_KEYS
    keys = tuple(k for k in OPERAND_KEYS if k != "lc")
    return keys + (("ta_w", "ta_b") if cfg.agent else ())


def train_operands(cell, cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """The ``DecoderCell``'s parameters in the kernels' layouts, built by
    differentiable float32 ops so that gradients reach the parameters:
    prenet kernels ``[in, out]`` concatenated flat; gate weights ``[4H,
    K_pad]`` (the ``nn.Linear`` layout, zero columns to a multiple of 64);
    ``lc = loc_filter @ location_kernel`` ``[K, A]``; the fused frame and
    stop head ``[M + 1, K_pad]``; for the forward family the energy net's
    query ``wq`` [H, A] and ``v`` [A], and the transition agent's weight
    [context | h_att | prenet output] and bias."""
    fcs = [getattr(cell.prenet, f"fc{i}") for i in range(cfg.n_prenet)]
    att = cell.attention
    att_g = cell.attention_lstm.cell.gates
    gen_g = cell.generator_lstm.cell.gates
    head = torch.cat([cell.frame_prediction.weight,
                      cell.stop_prediction.weight], 0)
    ops = {
        "pre_w": torch.cat([fc.weight.t().reshape(-1) for fc in fcs]),
        "pre_b": torch.cat([fc.bias for fc in fcs]),
        "att_w": F.pad(att_g.weight, (0, _pad64(cfg.ka) - cfg.ka)),
        "att_b": att_g.bias,
        "gen_w": F.pad(gen_g.weight, (0, _pad64(cfg.kg) - cfg.kg)),
        "gen_b": gen_g.bias,
        "head_w": F.pad(head, (0, _pad64(cfg.kh) - cfg.kh)),
        "head_b": torch.cat([cell.frame_prediction.bias,
                             cell.stop_prediction.bias]),
    }
    if cfg.family:
        ops["wq"] = att.energy_net.query.weight.t()
        ops["v"] = att.energy_net.energy.weight.reshape(-1)
    else:
        ops["wq"] = att.query_kernel
        ops["lc"] = att.loc_filter[:, 0, :] @ att.location_kernel
        ops["v"] = att.energy_kernel.reshape(-1)
    if cfg.agent:
        ops["ta_w"] = att.transition_agent.weight.reshape(-1)
        ops["ta_b"] = att.transition_agent.bias
    return ops


def compute_operands(ops: Dict[str, torch.Tensor], cfg: TrainConfig
                     ) -> Dict[str, torch.Tensor]:
    """The operands as the kernels read them: biases, v and the transition
    agent in float32, the rest in the compute type, contiguous."""
    return {k: (w.float() if k in _F32_KEYS else w.to(cfg.dtype)).contiguous()
            for k, w in ops.items()}


def agent_parts(w: torch.Tensor, mem_dim: int, hidden: int):
    """The transition agent's weight [Mem + H + P] split into its context,
    h_att and prenet-output parts (views)."""
    return torch.split(w, [mem_dim, hidden, w.numel() - mem_dim - hidden])


def prenet_layers(ops, cfg: TrainConfig):
    """[(W [in, out], b [out])] views of the flat prenet operands."""
    layers, wo = [], 0
    p = cfg.prenet_dim
    for i in range(cfg.n_prenet):
        k = cfg.mmel if i == 0 else p
        layers.append((ops["pre_w"][wo:wo + k * p].view(k, p),
                       ops["pre_b"][i * p:(i + 1) * p]))
        wo += k * p
    return layers


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of compute-type operands with float32 sums and a float32
    result (a large weight-gradient product outside the kernels)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels (pure functions)
# ---------------------------------------------------------------------------

def train_prenet_plain(raw, ops, cfg: TrainConfig, seeds: Seeds, gs: int
                       ) -> List[torch.Tensor]:
    """[B, M] input frame -> each layer's post-dropout output [B, P]."""
    x, outs = raw, []
    rate = cfg.dropout_rate
    for i, (w, b) in enumerate(prenet_layers(ops, cfg)):
        r = torch.relu(_mm(x, w) + b)
        if rate > 0.0:
            keep = rand_bits(tuple(r.shape), seeds[0], seeds[1],
                             cfg.prenet_salt(gs) + i,
                             r.device) < keep_threshold(rate)
            r = torch.where(keep, r * (1.0 / (1.0 - rate)),
                            torch.zeros_like(r))
        outs.append(r)
        x = r
    return outs


def _masks(shape, reg, which: int, device):
    seed0, seed1, salt_h, salt_c, th_h, th_c = reg[:6]
    salt, th = (salt_h, th_h) if which == 0 else (salt_c, th_c)
    return rand_bits(shape, seed0, seed1, salt, device) < th


def train_gate_lstm_plain(row, w, b, h, c, reg):
    """gates = row @ W^T + b -> LSTM step -> regularization (``reg``:
    ``TrainConfig.reg``).  ``row`` [B, K_pad] in the compute type, ``w``
    [4H, K_pad], ``h``/``c`` the float32 carries -> (h, c, i|f|g|o
    activations [B, 4H])."""
    gates = _mm(row, w.t()) + b
    gi, gf, gg, go = gates.chunk(4, dim=1)
    gi, gf, go, gg = (torch.sigmoid(gi), torch.sigmoid(gf),
                      torch.sigmoid(go), torch.tanh(gg))
    c_new = gf * c + gi * gg
    h_new = go * torch.tanh(c_new)
    mode, scale, zh, zc = reg[6:10]
    if mode == 1:
        h_new = torch.where(_masks(h.shape, reg, 0, h.device), h_new, h)
        c_new = torch.where(_masks(c.shape, reg, 1, c.device), c_new, c)
    elif mode == 2:
        h_new = torch.where(_masks(h.shape, reg, 0, h.device), h_new * scale,
                            torch.zeros_like(h_new))
    elif mode == 3:
        h_new = zh * h + (1.0 - zh) * h_new
        c_new = zc * c + (1.0 - zc) * c_new
    return h_new, c_new, torch.cat([gi, gf, gg, go], dim=1)


def train_query_plain(h, wq):
    """q = bf16(h @ Wq), held in float32."""
    return _rounded(_mm(h, wq), wq.dtype)


def _energy_tanh(q, cum, mtb, lc, d):
    """bf16(tanh(bf16(bf16(bf16(loc) + q) + mtb))) [B, T, A], loc the
    location conv of the bf16 ``cum`` with ``lc`` [K, A]."""
    k = lc.shape[0]
    loc = F.conv1d(_rounded(cum, d)[:, None, :], lc.float().t()[:, None, :],
                   padding=(k - 1) // 2).transpose(1, 2)
    z = _rounded(_rounded(_rounded(loc, d) + q[:, None, :], d) + mtb.float(),
                 d)
    return _rounded(torch.tanh(z), d)


def train_attention_plain(q, cum, memory, mtb, mask_add, lc, v):
    """-> (w [B, T], cum + w, ctx [B, Mem]), float32."""
    d = memory.dtype
    tz = _energy_tanh(q, cum, mtb, lc, d)
    w = torch.softmax((tz * v).sum(-1) + mask_add, dim=-1)
    ctx = _rounded(memory.float() * _rounded(w, d)[:, :, None], d).sum(1)
    return w, cum + w, ctx


def fwd_energy_tanh(q, mtb, d):
    """The forward family's energy terms bf16(tanh(bf16(q + mtb))) [B, T,
    A]: no location conv."""
    return _rounded(torch.tanh(_rounded(q[:, None, :] + mtb.float(), d)), d)


def _shift(w: torch.Tensor) -> torch.Tensor:
    """``shift(w)[t] = w[t - 1]``, ``shift(w)[0] = 0``."""
    return F.pad(w, (1, 0))[:, :-1]


def _shift_t(w: torch.Tensor) -> torch.Tensor:
    """The transpose of ``_shift``: ``w[t + 1]``, 0 at the last position."""
    return F.pad(w[:, 1:], (0, 1))


def train_fwd_attention_plain(q, prev, tp, memory, mtb, mask_add, v):
    """The forward family's step (``pallas_train_decoder.py:483-521``) ->
    (w [B, T], ctx [B, Mem]), float32: the unmasked softmax energy, the
    recurrence on ``prev`` (the last step's weights, float32) with the
    compute-type shifted weights, gated by ``tp`` [B] (None without the
    transition agent), then the mask, the 1e-6 floor and the renorm.  The
    state after the step is ``w``."""
    d = memory.dtype
    energy = torch.softmax((fwd_energy_tanh(q, mtb, d) * v).sum(-1), dim=-1)
    shifted = _shift(_rounded(prev, d))
    comb = prev + shifted if tp is None else (
        (1.0 - tp[:, None]) * prev + tp[:, None] * shifted)
    w = torch.where(mask_add > -0.5, comb * energy, torch.zeros_like(comb))
    w = torch.clamp(w, min=1e-6)
    w = w / w.sum(-1, keepdim=True)
    ctx = _rounded(memory.float() * _rounded(w, d)[:, :, None], d).sum(1)
    return w, ctx


def transition_plain(ctx, h_att, x, w, b):
    """K2's transition agent (``pallas_train_decoder.py:523-536``): ``tp =
    sigmoid(ctx . w_c + h_att . w_q + x . w_x + b)`` [B], float32 row sums
    of float32 operands."""
    wc, wq, wx = agent_parts(w, ctx.shape[1], h_att.shape[1])
    lin = ((ctx.float() * wc).sum(-1) + (h_att.float() * wq).sum(-1)
           + (x.float() * wx).sum(-1))
    return torch.sigmoid(lin + b)


def train_head_plain(row, head_w, head_b):
    """[B, K_pad] head row -> (frame [B, M], stop logit [B])."""
    fv = _mm(row, head_w.t()) + head_b
    return fv[:, :-1], fv[:, -1]


def bwd_head_plain(dspec, dstop, dframe, head_w, dh_gen, dctx, cfg):
    """-> (dframe_tot [B, M], dh_gen_tot [B, H], dctx_tot [B, Mem])."""
    m, h = cfg.mmel, cfg.hidden
    dft = dspec + dframe
    dproto = _mm(dft, head_w[:m]) + dstop[:, None] * head_w[m].float()
    return dft, dh_gen + dproto[:, :h], dctx + dproto[:, h:h + cfg.mem_dim]


def bwd_cell_plain(act, c_prev, dh_tot, dc, reg):
    """LSTM and regularization backward over the stored activations ->
    (dgates [B, 4H], dh passed to the previous h, dc of the previous c)."""
    gi, gf, gg, go = act.float().chunk(4, dim=1)
    cp = torch.zeros_like(dc) if c_prev is None else c_prev.float()
    tanh_c = torch.tanh(gf * cp + gi * gg)
    mode, scale = reg[6], reg[7]
    zero = torch.zeros_like(dh_tot)
    dh_new, dh_prev, dc_state, dc_prev = dh_tot, zero, dc, zero
    if mode == 1:
        zh = _masks(dh_tot.shape, reg, 0, dh_tot.device)
        zc = _masks(dc.shape, reg, 1, dc.device)
        dh_new, dh_prev = torch.where(zh, dh_tot, zero), torch.where(
            zh, zero, dh_tot)
        dc_state, dc_prev = torch.where(zc, dc, zero), torch.where(
            zc, zero, dc)
    elif mode == 2:
        keep = _masks(dh_tot.shape, reg, 0, dh_tot.device)
        dh_new = torch.where(keep, dh_tot * scale, zero)
    dc_new = dc_state + dh_new * go * (1.0 - tanh_c * tanh_c)
    dg = torch.cat([dc_new * gg * gi * (1.0 - gi),
                    dc_new * cp * gf * (1.0 - gf),
                    dc_new * gi * (1.0 - gg * gg),
                    dh_new * tanh_c * go * (1.0 - go)], dim=1)
    return dg, dh_prev, dc_prev + dc_new * gf


def att_bwd_plain(q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out, dcum):
    """One step's attention backward -> (dq [B, A], dmt [B, T, A], dlc [B,
    K, A], dv [B, A], dcum [B, T]): the increments of the per-row
    accumulators and the new cum cotangent."""
    d = memory.dtype
    k = lc.shape[0]
    half = (k - 1) // 2
    t_len = cum_s.shape[1]
    dw = dw_out + dcum + (memory.float() * dctx[:, None, :]).sum(-1)
    de = w_s * (dw - (dw * w_s).sum(-1, keepdim=True))
    tz = _energy_tanh(q, cum_s.float(), mtb, lc, d)
    dz = de[:, :, None] * v * (1.0 - tz * tz)
    dzr = _rounded(dz, d)
    windows = F.pad(_rounded(cum_s.float(), d), (half, half)).unfold(
        1, t_len, 1)                                          # [B, K, T]
    dlc = torch.einsum("bkt,bta->bka", windows, dzr)
    dcum_inc = F.conv_transpose1d(dzr.transpose(1, 2),
                                  lc.float().t()[:, None, :],
                                  padding=half)[:, 0, :]
    return (dz.sum(1), dz, dlc, (tz * de[:, :, None]).sum(1),
            dcum + dcum_inc)


def fwd_att_bwd_plain(q, cum_s, w_s, memory, mtb, mask_add, v, dctx,
                      dw_out, dcum, tp_prev):
    """The forward family's attention backward of one step
    (``pallas_train_decoder.py:857-896``) -> (dq [B, A], dmt [B, T, A], dv
    [B, A], the cotangent of the state before the step [B, T], dtp [B] or
    None).  It replays the energy softmax and the recurrence from the
    stored state ``cum_s`` (compute type) and ``tp_prev`` [B] (None without
    the agent), then runs the renorm's, the floor's (where the masked
    weights exceed 1e-6), the recurrence's and the softmax's backward.  The
    state cotangent is assigned, not added: the state is ``w``."""
    d = memory.dtype
    dw = dw_out + dcum + (memory.float() * dctx[:, None, :]).sum(-1)
    tz = fwd_energy_tanh(q, mtb, d)
    energy = torch.softmax((tz * v).sum(-1), dim=-1)
    prev = cum_s.float()
    shifted = _shift(prev)
    comb = prev + shifted if tp_prev is None else (
        (1.0 - tp_prev[:, None]) * prev + tp_prev[:, None] * shifted)
    wm = torch.where(mask_add > -0.5, comb * energy, torch.zeros_like(comb))
    s_norm = torch.clamp(wm, min=1e-6).sum(-1, keepdim=True)
    dwc = (dw - (dw * w_s).sum(-1, keepdim=True)) / s_norm
    dw_raw = torch.where(wm > 1e-6, dwc, torch.zeros_like(dwc))
    denergy, dcomb = dw_raw * comb, dw_raw * energy
    if tp_prev is None:
        dcum_new, dtp = dcomb + _shift_t(_rounded(dcomb, d)), None
    else:
        t = tp_prev[:, None]
        dcum_new = (1.0 - t) * dcomb + _shift_t(_rounded(t * dcomb, d))
        dtp = (dcomb * (shifted - prev)).sum(-1)
    de = energy * (denergy - (denergy * energy).sum(-1, keepdim=True))
    dz = de[:, :, None] * v * (1.0 - tz * tz)
    return dz.sum(1), dz, (tz * de[:, :, None]).sum(1), dcum_new, dtp


def agent_bwd_plain(dtp, tp, w, mem_dim: int, hidden: int):
    """The transition agent's backward (``pallas_train_decoder.py:
    759-785``) -> (dlin [B], its context, h_att and prenet-output terms):
    ``dlin = dtp * tp * (1 - tp)`` times each weight part."""
    dlin = dtp * tp * (1.0 - tp)
    return (dlin, *(dlin[:, None] * part
                    for part in agent_parts(w, mem_dim, hidden)))


def bwd_prenet_plain(dx, outs, ops, cfg: TrainConfig):
    """Layers in reverse -> (pre-ReLU grads per layer, d input frame)."""
    rate = cfg.dropout_rate
    scale = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    das = [None] * cfg.n_prenet
    for i, (w, _) in reversed(list(enumerate(prenet_layers(ops, cfg)))):
        da = torch.where(outs[i].float() > 0.0, dx * scale,
                         torch.zeros_like(dx))
        das[i] = da
        dx = _mm(da, w.t())
    return das, dx


# ---------------------------------------------------------------------------
# the plain versions written into the kernels' outputs: the CPU path, and
# the reference the drivers run with plain=True
# ---------------------------------------------------------------------------

def _train_prenet_plain_into(shifted_s, frame, teacher: int, ops, cfg,
                             seeds, gs, raw_out, pre_out, dst, x_out=None):
    """``train_prenet``'s plain version, written into its outputs (the
    streams ``raw_out`` and ``pre_out`` and the float32 copy of the output
    ``x_out`` may be None)."""
    raw = shifted_s.float() if teacher else frame
    outs = train_prenet_plain(raw, ops, cfg, seeds, gs)
    _copy(raw_out, raw)
    if pre_out is not None:
        for i, o in enumerate(outs):
            pre_out[i].copy_(o)
    dst.copy_(outs[-1])
    _copy(x_out, outs[-1])


def _train_gate_lstm_plain_into(row, w, bias, reg, h, c, act_out, c_out,
                                h_dst0, h_dst1):
    """``train_gate_lstm``'s plain version, written into its outputs (the
    streams ``act_out`` and ``c_out`` may be None)."""
    hn, cn, act = train_gate_lstm_plain(row, w, bias, h, c, reg)
    h.copy_(hn)
    c.copy_(cn)
    _copy(act_out, act)
    _copy(c_out, cn)
    h_dst0.copy_(hn)
    _copy(h_dst1, hn)


def _train_query_plain_into(h, wq, q_out, scratch=None):
    """``train_query``'s plain version, written into its outputs (it needs
    no ``scratch``)."""
    q_out.copy_(train_query_plain(h, wq))


def _train_attention_plain_into(q, cum, memory, mtb, mask_add, lc, v, w_out,
                                cum_out, ctx, ctx_dsts,
                                agent: Optional[AgentArgs] = None):
    """``train_attention``'s plain version, written into its outputs (the
    stream ``cum_out`` may be None); ``lc`` None runs the forward family's
    step, with the transition ``agent`` when given."""
    if lc is None:
        w, c = train_fwd_attention_plain(
            q, cum, None if agent is None else agent.tp, memory, mtb,
            mask_add, v)
        cum_new = w
        if agent is not None:
            tp = transition_plain(c, agent.h_att, agent.x, agent.w, agent.b)
            agent.tp.copy_(tp)
            _copy(agent.tp_out, tp)
    else:
        w, cum_new, c = train_attention_plain(q, cum, memory, mtb, mask_add,
                                              lc, v)
    w_out.copy_(w)
    _copy(cum_out, cum)
    cum.copy_(cum_new)
    ctx.copy_(c)
    for dst in ctx_dsts:
        _copy(dst, c)


def _train_head_plain_into(row, head_w, head_b, spec_out, stop_out, frame,
                           scratch=None):
    """``train_head``'s plain version, written into its outputs (it needs no
    ``scratch``)."""
    fr, st = train_head_plain(row, head_w, head_b)
    spec_out.copy_(fr)
    stop_out.copy_(st)
    frame.copy_(fr)


def _bwd_head_plain_into(dspec, dstop, dframe, head_w, da_frame_out, dh_gen,
                         dctx, dh_gen_tot, dctx_tot, cfg,
                         cell: Optional[CellArgs] = None):
    """``bwd_head``'s plain version, written into its outputs; with a
    ``cell``, then the cell's backward on dh_gen_tot, which may be None."""
    dft, dht, dct = bwd_head_plain(dspec, dstop, dframe, head_w, dh_gen,
                                   dctx, cfg)
    da_frame_out.copy_(dft)
    _copy(dh_gen_tot, dht)
    dctx_tot.copy_(dct)
    if cell is not None:
        _bwd_cell_plain_into(cell.act, cell.c_prev, dht, cell.dc, cell.dg,
                             cell.dh_reg, cell.reg)


def _bwd_cell_plain_into(act, c_prev, dh_tot, dc, dg_out, dh_reg, reg):
    """``bwd_cell``'s plain version, written into its outputs."""
    dg, dhp, dcp = bwd_cell_plain(act, c_prev, dh_tot, dc, reg)
    dg_out.copy_(dg)
    dh_reg.copy_(dhp)
    dc.copy_(dcp)


def _bwd_gemm_plain_into(a, b, b_kn: bool, segments, a_km: bool = False,
                         scratch=None, cell: Optional[CellArgs] = None):
    """``bwd_gemm``'s plain version, written into its outputs (it needs no
    ``scratch``); with a ``cell``, the one segment's sum goes to the cell's
    backward instead."""
    aa = a.t() if a_km else a
    acc = _mm(aa, b if b_kn else b.t())
    for lo, hi, out, add in segments:
        v = acc[:, lo:hi]
        v = v if add is None else add + v
        if cell is None:
            out.copy_(v)
        else:
            _bwd_cell_plain_into(cell.act, cell.c_prev, v, cell.dc, cell.dg,
                                 cell.dh_reg, cell.reg)


def _att_bwd_plain_into(q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out,
                        dcum, dmt, dlc, dv, dq_out, dctx_out,
                        fam: Optional[FamilyBwd] = None):
    """``att_bwd``'s plain version, written into its outputs; with
    ``fam`` the forward family's (``lc`` and ``dlc`` None), the transition
    agent's backward first when ``fam.dtp`` is given."""
    if fam is not None:
        if fam.dtp is not None:
            dlin, d_c, d_h, d_x = agent_bwd_plain(
                fam.dtp, fam.tp, fam.w, dctx.shape[1], fam.dh_att.shape[1])
            dctx = dctx + d_c
            fam.dh_att.add_(d_h)
            fam.dx.copy_(d_x)
            fam.dlin.copy_(dlin)
        dq, dz, dvv, dcum_new, dtp = fwd_att_bwd_plain(
            q, cum_s, w_s, memory, mtb, fam.mask_add, v, dctx, dw_out, dcum,
            fam.tp_prev)
        if dtp is not None:
            fam.dtp.copy_(dtp)
    else:
        dq, dz, dl, dvv, dcum_new = att_bwd_plain(
            q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out, dcum)
        dlc += dl
    dmt += dz
    dv += dvv
    dcum.copy_(dcum_new)
    dq_out.copy_(dq)
    dctx_out.copy_(dctx)


def _bwd_prenet_plain_into(dx, pre_s, ops, cfg, teacher: int, da_out,
                           dshift_out, dframe):
    """``bwd_prenet``'s plain version, written into its outputs."""
    das, dxin = bwd_prenet_plain(dx, list(pre_s), ops, cfg)
    for i, da in enumerate(das):
        da_out[i].copy_(da)
    zero = torch.zeros_like(dxin)
    dshift_out.copy_(dxin if teacher else zero)
    dframe.copy_(zero if teacher else dxin)


# ---------------------------------------------------------------------------
# CUDA wrappers: each takes its outputs as tensors (views allowed, unit
# stride in the last dimension) and fills them
# ---------------------------------------------------------------------------

_P, _I, _U, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_longlong)
_REG = [_U, _U, _U, _U, _U, _U, _I, _F, _F, _F]
_CELL = [_P] * 5 + [_I] + _REG          # act, c_prev, dc, dg, dh_reg, H, reg
# each launcher's arguments, then the compute-type flag (1: float32) and the
# stream, which _lib adds
_SIGNATURES = {
    "train_prenet_launch": [_P, _P, _I, _P, _P, _P, _P, _L, _P, _I, _P, _I,
                            _I, _I, _I, _U, _U, _U, _U, _F, _I, _I, _I],
    "gate_lstm_launch": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I,
                         _P, _I] + _REG,
    "query_launch": [_P, _I, _P, _I, _I, _I, _P, _I, _I, _P],
    "head_launch": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
    "bwd_gemm_launch": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]
                       + [_I, _I, _P, _I, _P, _I] * 3,
    "train_attention_launch": [_P] * 10 + [_P, _I, _P, _I, _P, _I]
                              + [_I] * 7,
    "train_fwd_attention_launch": [_P] * 9 + [_P, _I, _P, _I, _P, _I]
                                  + [_P] * 6 + [_I] * 9,
    "bwd_head_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I]
                       + _CELL,
    "bwd_cell_launch": [_P, _I] + _CELL,
    "bwd_gemm_cell_launch": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I]
                            + _CELL,
    "att_bwd_launch": [_P] * 15 + [_I] * 8,
    "fwd_att_bwd_launch": [_P] * 21 + [_I] * 10,
    "bwd_prenet_launch": [_P, _P, _L, _P, _P, _L, _P, _P, _I, _I, _I, _I,
                          _I, _F, _I, _I, _I],
}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from multilingual_text_to_speech_tpu_torch.ops import _build

        lib = _build.load("fused_train_decoder")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes + [_I, _P]
            fn.restype = ctypes.c_int
        # att_bwd_smem_bytes' own count, which the mirror is held to
        lib.att_bwd_smem_bytes.argtypes = [_I] * 6
        lib.att_bwd_smem_bytes.restype = _L
        _LIB = lib
    return _LIB


def _launch(name: str, fn: str, dtype: torch.dtype, *args,
            cell: bool = False) -> None:
    """Launch ``fn``'s instance for the compute type ``dtype`` (its last
    argument before the stream) and count it as ``instance(name, dtype)``."""
    err = getattr(_lib(), fn)(*args, int(dtype == torch.float32), _stream())
    if err != 0:
        raise RuntimeError(f"{instance(name, dtype)} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[instance(name, dtype)] += 1
    if cell:
        LAUNCHES[instance("bwd_cell", dtype)] += 1


def _compute_type(name: str, weight: torch.Tensor,
                  *streams: Optional[torch.Tensor]) -> torch.dtype:
    """The compute type of a kernel call, its weight's: bfloat16 or
    float32, and every compute-type operand or stream in ``streams`` (None
    allowed) of the same type."""
    d = weight.dtype
    if d not in _DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take bfloat16 or float32 "
                         f"compute, got {d}")
    for t in streams:
        _require(t, d, f"{name} operands")
    return d


def _cell_args(cell: Optional[CellArgs], hidden: int,
               dtype: torch.dtype) -> list:
    """The cell operands of a launcher (all null without a cell)."""
    if cell is None:
        return [None] * 5 + [hidden] + [0] * 6 + [0, 0.0, 0.0, 0.0]
    for t in (cell.act, cell.c_prev, cell.dg):
        _require(t, dtype, "cell activations, state stream and gate "
                 "gradients")
    return [_ptr(cell.act), _ptr(cell.c_prev), _ptr(cell.dc), _ptr(cell.dg),
            _ptr(cell.dh_reg), hidden, *cell.reg]


def _ptr(t: Optional[torch.Tensor]):
    if t is None:
        return None
    if not t.is_cuda or (t.dim() > 0 and t.stride(-1) != 1):
        raise ValueError("kernel operands must be CUDA tensors with unit "
                         "stride in the last dimension")
    return t.data_ptr()


def _ld(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.stride(0)


def _require(t: Optional[torch.Tensor], dtype: torch.dtype, name: str
             ) -> None:
    if t is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _copy(out: Optional[torch.Tensor], value: torch.Tensor) -> None:
    if out is not None:
        out.copy_(value)


def train_prenet(shifted_s, frame, teacher: int, ops, cfg, seeds, gs,
                 raw_out, pre_out, dst, x_out=None):
    """Kernel ``train_prenet``: the input frame (``shifted_s`` at a teacher
    step, the ``frame`` carry otherwise) -> ``raw_out`` [B, M], each
    layer's output ``pre_out`` [layers, B, P] and the last layer into
    ``dst`` [B, P] (compute type; the streams ``raw_out`` and ``pre_out``
    may be None) and, when given, into ``x_out`` [B, P] in float32 (the
    transition agent's input).  One launch: a cluster of CTAs for each 16
    rows, each CTA a column slice of every layer (``prenet_split``), as the
    serving decoder's ``prenet``."""
    if not _is_cuda(frame):
        return _train_prenet_plain_into(shifted_s, frame, teacher, ops, cfg,
                                        seeds, gs, raw_out, pre_out, dst,
                                        x_out)
    d = _compute_type("train_prenet", ops["pre_w"], raw_out, pre_out, dst,
                      shifted_s)
    _require(x_out, torch.float32, "train_prenet x_out")
    b = frame.shape[0]
    rate = cfg.dropout_rate
    cluster, cols_p, _ = prenet_split(cfg.mmel, cfg.prenet_dim,
                                      prenet_wide(d, b))
    _launch("train_prenet", "train_prenet_launch", d,
            _ptr(shifted_s), _ptr(frame), int(bool(teacher)),
            _ptr(ops["pre_w"]), _ptr(ops["pre_b"]), _ptr(raw_out),
            _ptr(pre_out), _ld(pre_out), _ptr(dst), _ld(dst), _ptr(x_out), b,
            cfg.mmel, cfg.prenet_dim, cfg.n_prenet, seeds[0] & _M32,
            seeds[1] & _M32, cfg.prenet_salt(gs),
            keep_threshold(rate) if rate > 0.0 else 0,
            1.0 / (1.0 - rate) if rate > 0.0 else 1.0, int(rate > 0.0),
            cluster, cols_p)


def train_gate_lstm(row, w, bias, reg, h, c, act_out, c_out, h_dst0, h_dst1):
    """Kernel ``train_gate_lstm``: gates of the concat ``row`` [B, K_pad],
    the LSTM step and the regularization.  Updates the float32 carries
    ``h``, ``c`` in place and writes the activations ``act_out`` [B, 4H],
    ``c_out`` and h into ``h_dst0`` (and ``h_dst1`` if given), in the
    compute type; the streams ``act_out`` and ``c_out`` may be None."""
    if not _is_cuda(h):
        return _train_gate_lstm_plain_into(row, w, bias, reg, h, c, act_out,
                                           c_out, h_dst0, h_dst1)
    d = _compute_type("train_gate_lstm", w, row, act_out, c_out, h_dst0,
                      h_dst1)
    b, hidden = h.shape
    v = 16 // w.element_size()         # elements a 16-byte chunk
    if (w.shape[1] % v or row.stride(0) % v or w.stride(0) % v
            or row.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("train_gate_lstm needs K_pad of whole 16-byte "
                         "chunks and the row and weight rows 16-byte "
                         "aligned")
    _launch("train_gate_lstm", "gate_lstm_launch", d,
            _ptr(row), _ld(row), _ptr(w), w.shape[1], _ptr(bias), b, hidden,
            _ptr(h), _ptr(c), _ptr(act_out), _ptr(c_out), _ptr(h_dst0),
            _ld(h_dst0), _ptr(h_dst1), _ld(h_dst1), *reg)


def train_query(h, wq, q_out, scratch=None):
    """Kernel ``train_query``: ``q_out`` [B, A] = round(h @ Wq) in float32
    (rounded to the compute type); ``h`` [B, H] is a compute-type stream
    view.  K is split as ``bwd_gemm`` splits it."""
    if not _is_cuda(q_out):
        return _train_query_plain_into(h, wq, q_out)
    d = _compute_type("train_query", wq, h)
    b, hidden = h.shape
    a = wq.shape[1]
    slices, kslice, part = _splitk.split(_lib(), b, a, hidden, scratch,
                                         q_out.device)
    _launch("train_query", "query_launch", d, _ptr(h), _ld(h), _ptr(wq), b,
            hidden, a, _ptr(q_out), slices, kslice, _ptr(part))


def train_attention(q, cum, memory, mtb, mask_add, lc, v, w_out, cum_out,
                    ctx, ctx_dsts, agent: Optional[AgentArgs] = None):
    """Kernel ``train_attention``: updates the float32 carries ``cum`` and
    ``ctx`` in place, writes the weights ``w_out`` [B, T] (float32), the
    cum before the step ``cum_out`` (compute type; may be None) and the
    context into each of ``ctx_dsts`` (compute type; the last may be
    None).  Each batch row is a cluster of CTAs over tiles of its positions
    (``att_bwd_tiles``: any T).  With ``lc`` None it runs the forward
    family's variant (``LAUNCHES["train_attention_fwd"]``; the carry
    ``cum`` holds the last step's weights and receives the new ones), with
    the transition ``agent`` when given."""
    if not _is_cuda(q):
        return _train_attention_plain_into(q, cum, memory, mtb, mask_add, lc,
                                           v, w_out, cum_out, ctx, ctx_dsts,
                                           agent)
    d = _compute_type("train_attention", memory, mtb, lc, cum_out, *ctx_dsts)
    b, t_len, mem_dim = memory.shape
    tile, cluster = att_bwd_tiles(t_len)
    d0, d1, d2 = ctx_dsts
    if lc is None:
        a = agent
        if a is not None:
            for t in (a.tp, a.tp_out, a.h_att, a.x, a.w, a.b):
                _require(t, torch.float32, "train_attention agent operands")
            if not (a.h_att.is_contiguous() and a.x.is_contiguous()):
                raise ValueError("train_attention: the agent's h_att and x "
                                 "must be contiguous [B, H] and [B, P]")
        _launch("train_attention_fwd", "train_fwd_attention_launch", d,
                _ptr(q), _ptr(cum), _ptr(memory), _ptr(mtb), _ptr(mask_add),
                _ptr(v), _ptr(w_out), _ptr(cum_out), _ptr(ctx), _ptr(d0),
                _ld(d0), _ptr(d1), _ld(d1), _ptr(d2), _ld(d2),
                *(_ptr(None if a is None else getattr(a, k)) for k in (
                    "tp", "tp_out", "h_att", "x", "w", "b")),
                b, t_len, q.shape[1], mem_dim,
                0 if a is None else a.h_att.shape[1],
                0 if a is None else a.x.shape[1], tile, cluster,
                int(a is not None))
        return
    _launch("train_attention", "train_attention_launch", d,
            _ptr(q), _ptr(cum), _ptr(memory), _ptr(mtb), _ptr(mask_add),
            _ptr(lc), _ptr(v), _ptr(w_out), _ptr(cum_out), _ptr(ctx),
            _ptr(d0), _ld(d0), _ptr(d1), _ld(d1), _ptr(d2), _ld(d2), b,
            t_len, lc.shape[1], mem_dim, lc.shape[0], tile, cluster)


def train_head(row, head_w, head_b, spec_out, stop_out, frame,
               scratch=None):
    """Kernel ``train_head``: frame and stop heads over the head ``row`` ->
    ``spec_out`` [B, M], ``stop_out`` [B] and the ``frame`` carry.  K is
    split as ``bwd_gemm`` splits it."""
    if not _is_cuda(frame):
        return _train_head_plain_into(row, head_w, head_b, spec_out,
                                      stop_out, frame)
    d = _compute_type("train_head", head_w, row)
    (n, k), b = head_w.shape, row.shape[0]
    slices, kslice, part = _splitk.split(_lib(), b, n, k, scratch,
                                         frame.device)
    _launch("train_head", "head_launch", d, _ptr(row), _ld(row), _ptr(head_w),
            k, _ptr(head_b), b, n, _ptr(spec_out), _ptr(frame),
            _ptr(stop_out), slices, kslice, _ptr(part))


def bwd_head(dspec, dstop, dframe, head_w, da_frame_out, dh_gen, dctx,
             dh_gen_tot, dctx_tot, cfg, cell: Optional[CellArgs] = None):
    """Kernel ``bwd_head``: writes ``da_frame_out`` (compute type) and the
    float32
    ``dh_gen_tot``, ``dctx_tot``.  With a ``cell`` (the generator's), its
    epilogue runs the cell's backward on each dh_gen_tot value, and
    ``dh_gen_tot`` may be None (it is then not stored)."""
    if not _is_cuda(dspec):
        return _bwd_head_plain_into(dspec, dstop, dframe, head_w,
                                    da_frame_out, dh_gen, dctx, dh_gen_tot,
                                    dctx_tot, cfg, cell)
    d = _compute_type("bwd_head", head_w, da_frame_out)
    _launch("bwd_head", "bwd_head_launch", d, _ptr(dspec), _ptr(dstop),
            _ptr(dframe), _ptr(head_w), head_w.shape[1], _ptr(da_frame_out),
            _ptr(dh_gen), _ptr(dctx), _ptr(dh_gen_tot), _ptr(dctx_tot),
            dspec.shape[0], cfg.mmel, cfg.mem_dim,
            *_cell_args(cell, cfg.hidden, d), cell=cell is not None)


def bwd_cell(act, c_prev, dh_tot, dc, dg_out, dh_reg, reg):
    """Kernel ``bwd_cell`` alone: ``dg_out`` [B, 4H] (compute type),
    ``dh_reg`` and
    the cell cotangent carry ``dc`` (updated in place).  The training
    decode runs the cell inside ``bwd_head`` and ``bwd_gemm`` (``cell=``)."""
    if not _is_cuda(dc):
        return _bwd_cell_plain_into(act, c_prev, dh_tot, dc, dg_out, dh_reg,
                                    reg)
    b, hidden = dc.shape
    d = _compute_type("bwd_cell", act)
    _launch("bwd_cell", "bwd_cell_launch", d, _ptr(dh_tot), b,
            *_cell_args(CellArgs(act, c_prev, dc, dg_out, dh_reg, reg),
                        hidden, d))


def bwd_gemm(a, b, b_kn: bool, segments, a_km: bool = False, scratch=None,
             cell: Optional[CellArgs] = None):
    """Kernel ``bwd_gemm``: ``acc = a @ b`` (``a`` [M, K], or [K, M] when
    ``a_km``; ``b`` [K, N] when ``b_kn``, else [N, K]), and for each
    ``(lo, hi, out, add)`` of ``segments``: ``out = add + acc[:, lo:hi]``
    (``add`` may be None or ``out`` itself).  K is split as
    ``_splitk.splitk_slices`` says; the partials go to the float32
    ``scratch`` (at least [S, M, N]; one of its own if None) and a second
    launch sums them in slice order.  With a ``cell``, ``segments`` is the
    one ``(0, N, None, add)`` with N = H, and the cell's backward runs on
    each final ``add + acc`` value instead of a store."""
    if not _is_cuda(a):
        return _bwd_gemm_plain_into(a, b, b_kn, segments, a_km, cell=cell)
    d = _compute_type("bwd_gemm", b, a)
    m, k = (a.shape[1], a.shape[0]) if a_km else a.shape
    n = b.shape[1] if b_kn else b.shape[0]
    if cell is not None:
        (lo, hi, out, add), = segments
        if a_km or (lo, hi, out) != (0, n, None) or add is None:
            raise ValueError("a bwd_gemm with a cell takes one segment "
                             "(0, N, None, add) and an [M, K] a")
        slices, kslice, part = _splitk.split(_lib(), m, n, k, scratch,
                                             a.device)
        _launch("bwd_gemm", "bwd_gemm_cell_launch", d, _ptr(a), _ld(a),
                _ptr(b), _ld(b), int(b_kn), m, k, slices, kslice, _ptr(part),
                _ptr(add), _ld(add), *_cell_args(cell, n, d), cell=True)
        return
    segs = list(segments) + [(0, 0, None, None)] * (3 - len(segments))
    args = []
    for lo, hi, out, add in segs:
        args += [lo, hi, _ptr(out), _ld(out), _ptr(add), _ld(add)]
    slices, kslice, part = _splitk.split(_lib(), m, n, k, scratch, a.device)
    _launch("bwd_gemm", "bwd_gemm_launch", d, _ptr(a), _ld(a), int(a_km),
            _ptr(b), _ld(b), int(b_kn), m, n, k, slices, kslice,
            _ptr(part), *args)


# att_bwd splits a batch row's positions over a thread-block cluster of at
# most this many CTAs (the portable cluster size), in tiles of whole
# 16-row mma tiles
_ATT_CLUSTER_MAX, _ATT_TILE_ROWS = 8, 16
# the shared memory a CTA may opt in to on the H100
# (csrc/fused_train_decoder.cu SMEM_MAX), att_bwd's threads a CTA
# (AB_THREADS), the band product's taps (csrc/tile.cuh BAND_K) and the
# positions a sub-tile of att_bwd's sub-tiled layout
SMEM_MAX = 227 * 1024
_AB_THREADS, _BAND_K, _AB_SUB = 256, 32, 64


def att_bwd_tiles(t_len: int) -> Tuple[int, int]:
    """``(tile, cluster)`` of ``att_bwd`` and ``train_attention`` at T =
    ``t_len``: the fewest 16-row mma tiles a CTA such that at most 8 CTAs
    cover T, and as many CTAs as the tiles need (none empty).  T=128 gives
    8 CTAs of 16 positions; T=200, 7 of 32; T=512, 8 of 64; T=1500, 8 of
    192; T=8,192, 8 of 1,024.  ``att_bwd_plan`` picks ``att_bwd``'s layout
    of a tile."""
    if t_len < 1:
        raise ValueError(f"att_bwd needs T >= 1, got {t_len}")
    mma_tiles = _cdiv(t_len, _ATT_TILE_ROWS)
    tile = _ATT_TILE_ROWS * _cdiv(mma_tiles, _ATT_CLUSTER_MAX)
    return tile, _cdiv(t_len, tile)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def att_bwd_smem_bytes(tile: int, a: int, mem_dim: int, family: bool,
                       elem_bytes: int, sub: int = 0) -> int:
    """The shared memory of an ``att_bwd`` CTA at a tile of ``tile``
    positions: the mirror of ``csrc/fused_train_decoder.cu::AbLayout``'s
    ``total`` (which the C side exports as ``att_bwd_smem_bytes``), for the
    forward ``family`` or the location-sensitive kind, compute-type
    elements of ``elem_bytes``; ``sub`` 0 the single tile's layout, > 0 the
    sub-tiled one."""
    tf32 = elem_bytes == 4 and not family
    rows = sub if sub > 0 else tile
    ld = a if tf32 else a + 8
    n = 0 if family else (
        _align16((2 if tf32 else 1) * _BAND_K * ld * elem_bytes)
        + _align16(rows * ld * elem_bytes)            # lc, dz
        + _align16(rows * _BAND_K * 4)                # P
        + (0 if tf32 and sub == 0 else _align16(_BAND_K * a * 4)))  # dlc's
    n += 4 * _align16(a * 4)                          # q, v, dv's, dq's
    n += (0 if tf32 and sub == 0 else _align16(tile * 4))   # w
    n += _align16(tile * 4) + _align16(mem_dim * 4)   # de, dctx
    if not family:
        n += _align16((tile + _BAND_K) * elem_bytes)  # cum
        n += _align16((tile + _BAND_K) * 4) if tf32 else 0   # its lo halves
    n += 32 * 4 + 32                                  # reductions, sums
    if family:
        n += _align16(5 * tile * 4)                   # the tile's rows
        n += _align16(tile * a * elem_bytes) if sub == 0 else 0   # tanh
        n += 2 * _align16(max(a, 2 * _AB_THREADS) * 4)   # dv's, dq's groups
    elif sub > 0:
        n += _align16((tile + 2 * _BAND_K) * 4)       # the cum cotangent's
    return n


class AttBwdPlan(NamedTuple):
    """``att_bwd``'s launch at one T: ``cluster`` CTAs a batch row, each a
    ``tile`` of positions; ``sub`` 0 keeps the tile's rows in shared memory
    whole (the single tile's layout), ``sub`` > 0 walks it in sub-tiles of
    that many positions (the sub-tiled layout of long texts)."""
    tile: int
    cluster: int
    sub: int


def att_bwd_plan(t_len: int, a: int, mem_dim: int, family: bool,
                 dtype: torch.dtype, *, sub_tiled: bool = False
                 ) -> AttBwdPlan:
    """``att_bwd``'s plan at T = ``t_len`` (``att_bwd_tiles``): the single
    tile's layout wherever it fits a CTA's shared memory (at the
    flagship's widths, A = 128 and Mem = 292, up to T = 3,968 in bf16 and
    2,304 in float32, location-sensitive; 6,272 and 3,328 in the forward
    ``family``), the sub-tiled one of ``_AB_SUB`` positions past that, or
    with ``sub_tiled`` at any T.  Raises where even the sub-tiled layout
    does not fit (at A = 128 and the 548-wide memory past T = 54,912 in
    float32, 101,120 in bf16, location-sensitive, and 63,872 in the
    family)."""
    tile, cluster = att_bwd_tiles(t_len)
    es = torch.empty(0, dtype=dtype).element_size()
    if not sub_tiled and att_bwd_smem_bytes(
            tile, a, mem_dim, family, es) <= SMEM_MAX:
        return AttBwdPlan(tile, cluster, 0)
    sub = min(_AB_SUB, tile)
    need = att_bwd_smem_bytes(tile, a, mem_dim, family, es, sub)
    if need > SMEM_MAX:
        raise ValueError(
            f"att_bwd at T={t_len} (A={a}, Mem={mem_dim}, {dtype}): tiles of "
            f"{tile} positions need {need} bytes of shared memory a CTA even "
            f"in sub-tiles of {sub}, past the {SMEM_MAX} a CTA holds")
    return AttBwdPlan(tile, cluster, sub)


def att_bwd(q, cum_s, w_s, memory, mtb, lc, v, dctx, dw_out, dcum, dmt, dlc,
            dv, dq_out, dctx_out, fam: Optional[FamilyBwd] = None, *,
            sub_tiled: bool = False):
    """Kernel ``att_bwd``: adds into the per-row accumulators ``dmt`` [B, T,
    A], ``dlc`` [B, K, A], ``dv`` [B, A] and the cum cotangent ``dcum``;
    writes ``dq_out`` [B, A] and ``dctx_out`` [B, Mem] (compute type).  Each
    batch row is a cluster of CTAs over tiles of its positions, each tile
    whole or, on long texts, in sub-tiles (``att_bwd_plan``; ``sub_tiled``
    forces the sub-tiled layout, for the tests).  With ``fam`` it runs the
    forward family's variant (``LAUNCHES["att_bwd_fwd"]``; ``lc`` and
    ``dlc`` None; ``dcum`` is the state's cotangent and is replaced), with
    the transition agent's backward in its prologue when ``fam.dtp`` is
    given."""
    if not _is_cuda(q):
        return _att_bwd_plain_into(q, cum_s, w_s, memory, mtb, lc, v, dctx,
                                   dw_out, dcum, dmt, dlc, dv, dq_out,
                                   dctx_out, fam)
    d = _compute_type("att_bwd", memory, cum_s, mtb, lc, dq_out, dctx_out)
    b, t_len, mem_dim = memory.shape
    tile, cluster, sub = att_bwd_plan(t_len, q.shape[1], mem_dim,
                                      fam is not None, d,
                                      sub_tiled=sub_tiled)
    if fam is not None:
        trans = fam.dtp is not None
        for t in (fam.mask_add, *((fam.tp_prev, fam.tp, fam.dtp, fam.dlin,
                                   fam.w, fam.dh_att, fam.dx) if trans
                                  else ())):
            _require(t, torch.float32, "att_bwd family operands")
        _launch("att_bwd_fwd", "fwd_att_bwd_launch", d, _ptr(q),
                _ptr(cum_s),
                _ptr(w_s), _ptr(memory), _ptr(mtb), _ptr(fam.mask_add),
                _ptr(v), _ptr(dctx), _ptr(dw_out), _ptr(dcum), _ptr(dmt),
                _ptr(dv), _ptr(dq_out), _ptr(dctx_out), _ptr(fam.tp_prev),
                _ptr(fam.tp), _ptr(fam.dtp), _ptr(fam.dlin), _ptr(fam.w),
                _ptr(fam.dh_att), _ptr(fam.dx), b, t_len, q.shape[1],
                mem_dim, fam.dh_att.shape[1] if trans else 0,
                fam.dx.shape[1] if trans else 0, tile, cluster, sub,
                int(trans))
        return
    _launch("att_bwd", "att_bwd_launch", d, _ptr(q), _ptr(cum_s), _ptr(w_s),
            _ptr(memory), _ptr(mtb), _ptr(lc), _ptr(v), _ptr(dctx),
            _ptr(dw_out), _ptr(dcum), _ptr(dmt), _ptr(dlc), _ptr(dv),
            _ptr(dq_out), _ptr(dctx_out), b, t_len, lc.shape[1], mem_dim,
            lc.shape[0], tile, cluster, sub)


def bwd_prenet(dx, pre_s, ops, cfg, teacher: int, da_out, dshift_out,
               dframe):
    """Kernel ``bwd_prenet``: pre-ReLU grads ``da_out`` [layers, B, P],
    then ``dshift_out`` (compute type, zero unless a teacher step) and the
    float32
    ``dframe`` carry (zero at a teacher step).  One launch: a cluster of
    CTAs for each 16 rows, each CTA a column slice of every layer
    (``prenet_split``), every layer's weight slice in its shared
    memory at once (up to 11 layers at P=256)."""
    if not _is_cuda(dx):
        return _bwd_prenet_plain_into(dx, pre_s, ops, cfg, teacher, da_out,
                                      dshift_out, dframe)
    d = _compute_type("bwd_prenet", ops["pre_w"], pre_s, da_out, dshift_out)
    rate = cfg.dropout_rate
    cluster, cols_p, cols_in = prenet_split(cfg.mmel, cfg.prenet_dim)
    _launch("bwd_prenet", "bwd_prenet_launch", d, _ptr(dx), _ptr(pre_s),
            pre_s.stride(0), _ptr(ops["pre_w"]), _ptr(da_out),
            da_out.stride(0), _ptr(dshift_out), _ptr(dframe),
            int(bool(teacher)), dx.shape[0], cfg.mmel, cfg.prenet_dim,
            cfg.n_prenet, 1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
            cluster, cols_p, cols_in)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

# the kernel functions, and their plain versions with the same signatures
KERNELS = SimpleNamespace(
    train_prenet=train_prenet,
    train_gate_lstm=train_gate_lstm,
    train_query=train_query,
    train_attention=train_attention,
    train_head=train_head,
    bwd_head=bwd_head,
    bwd_cell=bwd_cell,
    bwd_gemm=bwd_gemm,
    att_bwd=att_bwd,
    bwd_prenet=bwd_prenet,
)
PLAIN = SimpleNamespace(
    train_prenet=_train_prenet_plain_into,
    train_gate_lstm=_train_gate_lstm_plain_into,
    train_query=_train_query_plain_into,
    train_attention=_train_attention_plain_into,
    train_head=_train_head_plain_into,
    bwd_head=_bwd_head_plain_into,
    bwd_cell=_bwd_cell_plain_into,
    bwd_gemm=_bwd_gemm_plain_into,
    att_bwd=_att_bwd_plain_into,
    bwd_prenet=_bwd_prenet_plain_into,
)


def _zeros(*shape, like, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device=like.device)


def initial_state(cfg: TrainConfig, b: int, t_len: int, device
                  ) -> Dict[str, torch.Tensor]:
    """The attention state of the first step (float32): ``cum`` zero, or
    for the forward family all mass on token 0, and the transition agent's
    ``tp`` [B] at 0.5."""
    cum = torch.zeros(b, t_len, device=device)
    if not cfg.family:
        return {"cum": cum}
    cum[:, 0] = 1.0
    if not cfg.agent:
        return {"cum": cum}
    return {"cum": cum, "tp": torch.full((b,), 0.5, device=device)}


def _pass_scratch(plain: bool, products, like: torch.Tensor):
    """The one split-K scratch of a decoder pass (``_splitk.splitk_scratch``)
    for the kernels; None for the plain versions and on the CPU."""
    if plain or not _is_cuda(like):
        return None
    return _splitk.splitk_scratch(_lib(), products, like)


def train_decode_forward(ops, cfg: TrainConfig, memory, mtb, mask_add,
                         shifted, teacher: Sequence[int], seeds: Seeds,
                         plain: bool = False):
    """K2 over all F steps.  ``memory`` [B, T, Mem] and ``mtb`` (memory
    transform plus the attention bias) [B, T, A] in the compute type,
    ``mask_add`` [B, T] 0 / -1e9, ``shifted`` [F, B, M] (compute type),
    ``teacher`` F flags -> ``(streams, carry)``: the outputs spec [F, B, M],
    stop [F, B], w [F, B, T] (float32) and, in train mode, the residual
    streams (compute type); the final float32 carry.  An eval forward
    (``cfg.train`` False) keeps no residual stream: its concat rows are
    two buffers a row kind that the steps alternate (a gate product writes
    the next step's row while it reads its own)."""
    n_f, b = shifted.shape[:2]
    t_len = memory.shape[1]
    d = cfg.dtype
    h, p, mem, m = cfg.hidden, cfg.prenet_dim, cfg.mem_dim, cfg.mmel

    def z(*shape, dtype=d):
        return _zeros(*shape, like=memory, dtype=dtype)

    st = {
        "spec": z(n_f, b, m, dtype=torch.float32),
        "stop": z(n_f, b, dtype=torch.float32),
        "w": z(n_f, b, t_len, dtype=torch.float32),
    }
    n_rows = n_f if cfg.train else 2
    rows = {"att_in": z(n_rows, b, _pad64(cfg.ka)),
            "gen_in": z(n_rows, b, _pad64(cfg.kg)),
            "head_in": z(n_rows, b, _pad64(cfg.kh))}
    f32 = torch.float32
    if cfg.train:
        st.update(rows, raw=z(n_f, b, m), pre=z(cfg.n_prenet, n_f, b, p),
                  act_att=z(n_f, b, 4 * h), act_gen=z(n_f, b, 4 * h),
                  c_att=z(n_f, b, h), c_gen=z(n_f, b, h),
                  cum=z(n_f, b, t_len))
        if cfg.agent:
            st["tp"] = z(n_f, b, dtype=f32)

    def stream(name, s):
        return st[name][s] if cfg.train else None

    carry = {"h_att": z(b, h, dtype=f32), "c_att": z(b, h, dtype=f32),
             "h_gen": z(b, h, dtype=f32), "c_gen": z(b, h, dtype=f32),
             "ctx": z(b, mem, dtype=f32), "frame": z(b, m, dtype=f32),
             **initial_state(cfg, b, t_len, memory.device)}
    q = z(b, cfg.att_dim, dtype=f32)
    # the transition agent reads the prenet output in float32
    x32 = z(b, p, dtype=f32) if cfg.agent else None
    f = PLAIN if plain else KERNELS
    scratch = _pass_scratch(
        plain, [(b, cfg.att_dim, h), (b, m + 1, _pad64(cfg.kh))], memory)
    for s in range(n_f):
        att_in, gen_in, head_in = (rows[k][s % n_rows]
                                   for k in ("att_in", "gen_in", "head_in"))
        last = s + 1 == n_f
        nxt_a = None if last else rows["att_in"][(s + 1) % n_rows]
        nxt_g = None if last else rows["gen_in"][(s + 1) % n_rows]
        f.train_prenet(shifted[s], carry["frame"], teacher[s], ops, cfg, seeds,
                     s, stream("raw", s),
                     st["pre"][:, s] if cfg.train else None, att_in[:, :p],
                     x_out=x32)
        f.train_gate_lstm(att_in, ops["att_w"], ops["att_b"],
                        cfg.reg("att", seeds, s), carry["h_att"],
                        carry["c_att"], stream("act_att", s),
                        stream("c_att", s), gen_in[:, :h],
                        None if last else nxt_a[:, p + mem:p + mem + h])
        f.train_query(gen_in[:, :h], ops["wq"], q, scratch=scratch)
        f.train_attention(q, carry["cum"], memory, mtb, mask_add,
                        ops.get("lc"), ops["v"], st["w"][s],
                        stream("cum", s), carry["ctx"],
                        (gen_in[:, h:h + mem], head_in[:, h:h + mem],
                         None if last else nxt_a[:, p:p + mem]),
                        agent=AgentArgs(carry["tp"], stream("tp", s),
                                        carry["h_att"], x32, ops["ta_w"],
                                        ops["ta_b"]) if cfg.agent else None)
        f.train_gate_lstm(gen_in, ops["gen_w"], ops["gen_b"],
                        cfg.reg("gen", seeds, s), carry["h_gen"],
                        carry["c_gen"], stream("act_gen", s),
                        stream("c_gen", s), head_in[:, :h],
                        None if last else nxt_g[:, h + mem:2 * h + mem])
        f.train_head(head_in, ops["head_w"], ops["head_b"], st["spec"][s],
                   st["stop"][s], carry["frame"], scratch=scratch)
    return st, carry


def train_decode_backward(ops, cfg: TrainConfig, memory, mtb, st,
                          teacher: Sequence[int], seeds: Seeds, dspec, dstop,
                          dw, plain: bool = False, mask_add=None):
    """K3 over all F steps in reverse, then the weight gradients.  ``st``
    holds the forward's streams; ``dspec`` [F, B, M], ``dstop`` [F, B],
    ``dw`` [F, B, T] are the output cotangents (float32); the forward
    family's backward replays the mask, ``mask_add``.  -> ``(grads,
    streams, carry)``: the gradient of every operand of
    ``train_operands`` plus ``memory``, ``mtb`` and ``shifted``; the
    per-step gradient streams; the final cotangent carry (that of the
    initial decoder state)."""
    if cfg.family and mask_add is None:
        raise ValueError("the forward family's backward needs mask_add")
    n_f, b = dspec.shape[:2]
    t_len = memory.shape[1]
    d = cfg.dtype
    h, p, mem, m, a = (cfg.hidden, cfg.prenet_dim, cfg.mem_dim, cfg.mmel,
                       cfg.att_dim)
    f32 = torch.float32

    def z(*shape, dtype=f32):
        return _zeros(*shape, like=memory, dtype=dtype)

    g = {"dg_att": z(n_f, b, 4 * h, dtype=d),
         "dg_gen": z(n_f, b, 4 * h, dtype=d),
         "da_frame": z(n_f, b, m, dtype=d),
         "da_pre": z(cfg.n_prenet, n_f, b, p, dtype=d),
         "dctx": z(n_f, b, mem, dtype=d), "dshift": z(n_f, b, m, dtype=d),
         "dq": z(n_f, b, a, dtype=d)}
    acc = {"dmt": z(b, t_len, a), "dv": z(b, a)}
    if not cfg.family:
        acc["dlc"] = z(b, cfg.taps, a)
    carry = {"h_att": z(b, h), "c_att": z(b, h), "h_gen": z(b, h),
             "c_gen": z(b, h), "ctx": z(b, mem), "frame": z(b, m),
             "cum": z(b, t_len)}
    if cfg.agent:
        carry["tp"] = z(b)
        g["dlin"] = z(n_f, b)
        tp0 = initial_state(cfg, b, t_len, memory.device)["tp"]
    dh_att_tot, dh_reg = z(b, h), z(b, h)
    dctx_tot, dx, q = z(b, mem), z(b, p), z(b, a)
    f = PLAIN if plain else KERNELS
    scratch = _pass_scratch(
        plain, [(b, _pad64(cfg.kg), 4 * h), (b, a, h), (b, h, a),
                (b, _pad64(cfg.ka), 4 * h), (h, a, n_f * b)], memory)
    for s in range(n_f - 1, -1, -1):
        # each cell's backward runs where its h cotangent's last term is
        # summed: the generator's in bwd_head, the attention LSTM's in the
        # dq @ Wq^T product
        f.bwd_head(dspec[s], dstop[s], carry["frame"], ops["head_w"],
                 g["da_frame"][s], carry["h_gen"], carry["ctx"], None,
                 dctx_tot, cfg,
                 cell=CellArgs(st["act_gen"][s],
                               st["c_gen"][s - 1] if s else None,
                               carry["c_gen"], g["dg_gen"][s], dh_reg,
                               cfg.reg("gen", seeds, s)))
        f.bwd_gemm(g["dg_gen"][s], ops["gen_w"], True,
                 [(0, h, dh_att_tot, carry["h_att"]),
                  (h, h + mem, dctx_tot, dctx_tot),
                  (h + mem, 2 * h + mem, carry["h_gen"], dh_reg)],
                 scratch=scratch)
        f.train_query(st["gen_in"][s][:, :h], ops["wq"], q, scratch=scratch)
        fam = None
        if cfg.agent:
            fam = FamilyBwd(mask_add, st["tp"][s - 1] if s else tp0,
                            st["tp"][s], carry["tp"], g["dlin"][s],
                            ops["ta_w"], dh_att_tot, dx)
        elif cfg.family:
            fam = FamilyBwd(mask_add)
        f.att_bwd(q, st["cum"][s], st["w"][s], memory, mtb, ops.get("lc"),
                ops["v"], dctx_tot, dw[s], carry["cum"], acc["dmt"],
                acc.get("dlc"), acc["dv"], g["dq"][s], g["dctx"][s], fam=fam)
        f.bwd_gemm(g["dq"][s], ops["wq"], False,
                 [(0, h, None, dh_att_tot)], scratch=scratch,
                 cell=CellArgs(st["act_att"][s],
                               st["c_att"][s - 1] if s else None,
                               carry["c_att"], g["dg_att"][s], dh_reg,
                               cfg.reg("att", seeds, s)))
        # the agent's prenet term is in dx already: the product adds to it
        f.bwd_gemm(g["dg_att"][s], ops["att_w"], True,
                 [(0, p, dx, dx if cfg.agent else None),
                  (p, p + mem, carry["ctx"], None),
                  (p + mem, p + mem + h, carry["h_att"], dh_reg)],
                 scratch=scratch)
        f.bwd_prenet(dx, st["pre"][:, s], ops, cfg, teacher[s],
                   g["da_pre"][:, s], g["dshift"][s], carry["frame"])

    def flat(x):
        return x.reshape(-1, x.shape[-1])

    d_wq = z(h, a)
    f.bwd_gemm(flat(st["gen_in"])[:, :h], flat(g["dq"]), True,
             [(0, a, d_wq, None)], a_km=True, scratch=scratch)
    dfv = torch.cat([g["da_frame"], dstop.to(d)[..., None]], dim=-1)
    pre_in = [st["raw"]] + [st["pre"][i] for i in range(cfg.n_prenet - 1)]
    grads = {
        "att_w": _mm_f32(flat(g["dg_att"]).t(), flat(st["att_in"])),
        "att_b": g["dg_att"].float().sum((0, 1)),
        "gen_w": _mm_f32(flat(g["dg_gen"]).t(), flat(st["gen_in"])),
        "gen_b": g["dg_gen"].float().sum((0, 1)),
        "head_w": _mm_f32(flat(dfv).t(), flat(st["head_in"])),
        "head_b": dfv.float().sum((0, 1)),
        "pre_w": torch.cat([
            _mm_f32(flat(x).t(), flat(g["da_pre"][i])).reshape(-1)
            for i, x in enumerate(pre_in)]),
        "pre_b": g["da_pre"].float().sum((1, 2)).reshape(-1),
        "wq": d_wq,
        "v": acc["dv"].sum(0),
        "mtb": acc["dmt"],
        "memory": torch.einsum("sbt,sbm->btm", st["w"], g["dctx"].float()),
        "shifted": g["dshift"].float(),
    }
    if not cfg.family:
        grads["lc"] = acc["dlc"].sum(0)
    if cfg.agent:
        # row sums of dlin against the streams the agent read: the context
        # and h_att (the generator's concat row) and the prenet output
        dlin = g["dlin"].reshape(1, -1)
        grads["ta_w"] = torch.cat([
            (dlin @ flat(x).float()).reshape(-1)
            for x in (st["gen_in"][..., h:h + mem], st["gen_in"][..., :h],
                      st["pre"][cfg.n_prenet - 1])])
        grads["ta_b"] = g["dlin"].sum().reshape(1)
    return grads, g, carry


class TrainDecode(torch.autograd.Function):
    """K2 forward, K3 backward.  Inputs: the static ``cfg``, the ``teacher``
    flags and ``seeds``, then ``memory`` [B, T, Mem], ``mtb`` [B, T, A],
    ``mask_add`` [B, T], ``shifted`` [F, B, M] and the operands of
    ``operand_keys(cfg)`` (float32; cast to the compute type inside).
    Outputs spec [F, B, M], stop [F, B], w [F, B, T] in float32."""

    @staticmethod
    def forward(ctx, cfg, teacher, seeds, memory, mtb, mask_add, shifted,
                *weights):
        if not cfg.train:
            raise ValueError("TrainDecode differentiates the train-mode "
                             "forward; an eval forward has no backward")
        d = cfg.dtype
        ops = compute_operands(dict(zip(operand_keys(cfg), weights)), cfg)
        mem_d, mtb_d = memory.to(d).contiguous(), mtb.to(d).contiguous()
        mask_add = mask_add.float().contiguous()
        st, _ = train_decode_forward(
            ops, cfg, mem_d, mtb_d, mask_add, shifted.to(d).contiguous(),
            teacher, seeds)
        ctx.cfg, ctx.teacher, ctx.seeds = cfg, teacher, seeds
        ctx.ops, ctx.st = ops, st
        ctx.save_for_backward(mem_d, mtb_d, mask_add)
        return st["spec"], st["stop"], st["w"]

    @staticmethod
    def backward(ctx, dspec, dstop, dw):
        mem_d, mtb_d, mask_add = ctx.saved_tensors
        grads, _, _ = train_decode_backward(
            ctx.ops, ctx.cfg, mem_d, mtb_d, ctx.st, ctx.teacher, ctx.seeds,
            dspec.float().contiguous(), dstop.float().contiguous(),
            dw.float().contiguous(), mask_add=mask_add)
        keys = operand_keys(ctx.cfg)
        ctx.ops = ctx.st = None
        return (None, None, None, grads["memory"], grads["mtb"], None,
                grads["shifted"], *[grads[k] for k in keys])


def train_decode_forward_plain(ops, cfg: TrainConfig, memory, mtb, mask_add,
                               shifted, teacher: Sequence[int], seeds: Seeds):
    """K2's plain version in differentiable ops (no in-place writes), for
    autograd: -> (spec [F, B, M], stop [F, B], w [F, B, T])."""
    n_f, b = shifted.shape[:2]
    d = cfg.dtype
    h, mem, m = cfg.hidden, cfg.mem_dim, cfg.mmel

    def z(width):
        return _zeros(b, width, like=memory)

    h_att, c_att, h_gen, c_gen = z(h), z(h), z(h), z(h)
    ctx, frame = z(mem), z(m)
    state = initial_state(cfg, b, memory.shape[1], memory.device)
    cum, tp = state["cum"], state.get("tp")
    specs, stops, ws = [], [], []
    for s in range(n_f):
        raw = _rounded(shifted[s].float(), d) if teacher[s] else frame
        x = train_prenet_plain(raw, ops, cfg, seeds, s)[-1]
        row = torch.cat([x, ctx, h_att], 1)
        h_att, c_att, _ = train_gate_lstm_plain(
            row, ops["att_w"][:, :cfg.ka], ops["att_b"], h_att, c_att,
            cfg.reg("att", seeds, s))
        q = train_query_plain(h_att, ops["wq"])
        if cfg.family:
            w, ctx = train_fwd_attention_plain(q, cum, tp, memory, mtb,
                                               mask_add, ops["v"])
            cum = w
            if cfg.agent:
                tp = transition_plain(ctx, h_att, x, ops["ta_w"],
                                      ops["ta_b"])
        else:
            w, cum, ctx = train_attention_plain(q, cum, memory, mtb,
                                                mask_add, ops["lc"], ops["v"])
        row = torch.cat([h_att, ctx, h_gen], 1)
        h_gen, c_gen, _ = train_gate_lstm_plain(
            row, ops["gen_w"][:, :cfg.kg], ops["gen_b"], h_gen, c_gen,
            cfg.reg("gen", seeds, s))
        frame, stop = train_head_plain(torch.cat([h_gen, ctx], 1),
                                       ops["head_w"][:, :cfg.kh],
                                       ops["head_b"])
        specs.append(frame)
        stops.append(stop)
        ws.append(w)
    return torch.stack(specs), torch.stack(stops), torch.stack(ws)


def decode(cell, cfg: TrainConfig, memory, memory_transform, mask, shifted,
           teacher: Sequence[int], seeds: Seeds):
    """The teacher-forced decode, the contract of the JAX package's
    ``make_train_decode_fn(..., train=cfg.train)(...)``: ``memory`` [B, T,
    Mem], ``memory_transform`` [B, T, A], ``mask`` [B, T] bool, ``shifted``
    [B, F, M], ``teacher`` F flags, ``seeds`` two uint32 -> ``(spec [B, F,
    M], stop logits [B, F], alignments [B, F, T])``.  In train mode the
    outputs are differentiable with respect to the cell's parameters,
    ``memory`` and ``memory_transform`` (``TrainDecode``).  The eval
    forward (``cfg.train`` False) runs K2's eval variant directly, outside
    autograd, as the JAX package's has no VJP: its outputs carry no
    ``grad_fn``."""
    mask_add = torch.where(mask, 0.0, NEG_INF).float()
    teacher = tuple(int(x) for x in teacher)
    sh = shifted.transpose(0, 1)
    if not cfg.train:
        with torch.no_grad():
            ops = compute_operands(train_operands(cell, cfg), cfg)
            mtb = memory_transform.float() + cell.attention.energy_bias
            d = cfg.dtype
            st, _ = train_decode_forward(
                ops, cfg, memory.to(d).contiguous(), mtb.to(d).contiguous(),
                mask_add, sh.to(d).contiguous(), teacher, tuple(seeds))
        return (st["spec"].transpose(0, 1), st["stop"].transpose(0, 1),
                st["w"].transpose(0, 1))
    ops = train_operands(cell, cfg)
    mtb = memory_transform.float() + cell.attention.energy_bias
    spec, stop, w = TrainDecode.apply(
        cfg, teacher, tuple(seeds), memory.float(), mtb, mask_add,
        sh.float(), *[ops[k] for k in operand_keys(cfg)])
    return spec.transpose(0, 1), stop.transpose(0, 1), w.transpose(0, 1)
