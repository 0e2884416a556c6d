"""K1's float32 forward-family attention, on the CPU: the order in which its
kernel instances sum (``csrc/fused_decoder.cu``: ``lsa_unstaged_step`` at
float32 compute for the ``fwd`` and ``fwd_trans`` kinds, on float32 and on
int8 streams).

The kernel's energy gives a lane four consecutive channels of a float32
memory transform (one 16-byte read) or eight int8 codes (one 8-byte read,
each code times its channel's scale in float32), ``lpr`` lanes a position
(the power of two at least A over that width, at most 32), every lpr-th
group past a lane's own after it (A a multiple of 8), then the lanes'
partials by xor shuffles (``fam_energies``).  The
softmax takes its maximum and sum in one reduction of each thread's (max,
sum) pair (``block_softmax_stats``); the transition agent sums each
thread's h_att and x terms in the prologue and its ctx . wc terms in the
context's column loop, then one block sum; the context is
``ctx_partials``'s slots in float32.  A torch model of that order is held
against ``fwd_attention_plain`` and, through two decoder steps, against
the JAX serving kernel in interpret mode at float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.models.tacotron import Tacotron
from multilingual_text_to_speech_tpu.ops import pallas_decoder
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from tests.torch_port_utils import (
    batch,
    jax_variables,
    port_model,
    tiny_hp,
    to_np,
    variables_np,
)

THREADS, WARPS = 256, 8
NEG_INF = float("-inf")


def _lane_butterfly(vals, offsets):
    """Lane 0's value after ``v += shfl_xor(v, off)`` for each offset in
    turn, ``vals`` [..., lanes]."""
    for off in offsets:
        idx = torch.arange(vals.shape[-1]) ^ off
        vals = vals + vals[..., idx]
    return vals[..., 0]


def _halvings(n):
    out, off = [], n // 2
    while off:
        out.append(off)
        off //= 2
    return out


def lane_plan(a_dim, q8):
    """``(fw, lpr, channels)``: the channels a lane reads at once, the
    lanes of a position, and each lane's channels in the order it sums
    them (its own group, then every lpr-th group past it); A a multiple
    of 8."""
    fw = 8 if q8 else 4
    ng = a_dim // fw
    lpr = 1
    while lpr < ng and lpr < 32:
        lpr *= 2
    chans = []
    for sub in range(lpr):
        chans.append([fw * c + i for c in range(sub, ng, lpr)
                      for i in range(fw)])
    return fw, lpr, chans


def _softmax_stats(e):
    """``block_softmax_stats`` over [B, T] energies: thread ``tid`` owns
    the positions ``tid, tid + 256, ...`` (its maximum, then its sum of
    exp(e - maximum)); each warp's maximum, its lanes' sums rescaled to it
    and summed by the xor butterfly; then the block's maximum and the
    warps' sums rescaled to it in warp order."""
    b, t = e.shape
    cols = -(-t // THREADS) * THREADS
    pad = torch.full((b, cols), NEG_INF)
    pad[:, :t] = e
    own = pad.view(b, -1, THREADS)
    m = own.max(1).values
    s = torch.where(m == NEG_INF, torch.zeros_like(m),
                    torch.exp(own - m[:, None]).sum(1))
    m, s = m.view(b, WARPS, 32), s.view(b, WARPS, 32)
    wm = m.max(-1).values
    scaled = torch.where(m == NEG_INF, torch.zeros_like(s),
                         s * torch.exp(m - wm[..., None]))
    ws = _lane_butterfly(scaled, (16, 8, 4, 2, 1))
    big_m = wm.max(-1).values
    big_s = torch.zeros(b)
    for w in range(WARPS):
        big_s = big_s + torch.where(
            wm[:, w] == NEG_INF, torch.zeros(b),
            ws[:, w] * torch.exp(wm[:, w] - big_m))
    return big_m, big_s


def _context(memory, w):
    """``ctx_partials`` (float32 products) then ``ctx_column``: CtxScheme's
    slots (group, chunk) each sum their chunk's elements over the periods
    p = group, group + G, ... in order; a column sums the groups, then the
    period's rows, in order; int8 streams scaled after the sum."""
    q8 = isinstance(memory, fd.Int8Stream)
    mem = memory.q.float() if q8 else memory.float()
    b, t, m_dim = mem.shape
    v = 16 if q8 else 4
    g = v
    while m_dim % g:
        g //= 2
    period = v // g
    chunks = period * m_dim // v
    groups = max(1, THREADS // chunks)
    n_per = -(-t // period)
    flat = torch.zeros(b, n_per * period * m_dim)
    flat[:, :t * m_dim] = mem.reshape(b, -1)
    wp = torch.zeros(b, n_per * period)
    wp[:, :t] = w
    prod = (flat.view(b, n_per, period, m_dim)
            * wp.view(b, n_per, period, 1)).view(b, n_per, -1)
    ctx = torch.zeros(b, m_dim)
    for grp in range(groups):
        part = torch.zeros(b, period * m_dim)
        for p in range(grp, n_per, groups):
            part = part + prod[:, p]
        for r in range(period):
            ctx = ctx + part[:, r * m_dim:(r + 1) * m_dim]
    return ctx * memory.scale if q8 else ctx


def _thread_sums(x, w):
    """Each of the 256 threads' sum of x[k] w[k] over k = tid, tid + 256,
    ... in order -> [B, 256]."""
    n = x.shape[1]
    cols = -(-n // THREADS) * THREADS
    prod = torch.zeros(x.shape[0], cols)
    prod[:, :n] = x.float() * w.float()
    out = torch.zeros(x.shape[0], THREADS)
    for r in range(cols // THREADS):
        out = out + prod[:, r * THREADS:(r + 1) * THREADS]
    return out


def _block_sum(per_thread):
    """``block_reduce<false>``: each warp's butterfly, then the warps'
    sums (zero past them) by one more butterfly."""
    b = per_thread.shape[0]
    warps = _lane_butterfly(per_thread.view(b, WARPS, 32), (16, 8, 4, 2, 1))
    lanes = torch.zeros(b, 32)
    lanes[:, :WARPS] = warps
    return _lane_butterfly(lanes, (16, 8, 4, 2, 1))


def f32_fwd_step(h_att, prev, t_prob, memory, mtb, mask_add, x, bundle):
    """The float32 forward-family step in the kernel's order."""
    q = fd._mm(h_att, bundle.wq).float()
    q8 = isinstance(mtb, fd.Int8Stream)
    mt = mtb.q.float() * mtb.scale.float() if q8 else mtb.float()
    vt = torch.tanh(q[:, None, :] + mt) * bundle.v.float()
    _, lpr, chans = lane_plan(vt.shape[2], q8)
    lanes = torch.zeros(*vt.shape[:2], lpr)
    for sub, own in enumerate(chans):
        for a in own:
            lanes[..., sub] = lanes[..., sub] + vt[:, :, a]
    e = _lane_butterfly(lanes, _halvings(lpr))
    m, s = _softmax_stats(e)
    energy = torch.exp(e - m[:, None]) / s[:, None]
    shifted = torch.nn.functional.pad(prev, (1, 0))[:, :-1]
    comb = prev + shifted if t_prob is None else (
        (1.0 - t_prob) * prev + t_prob * shifted)
    w = torch.clamp(torch.where(mask_add > -0.5, comb * energy,
                                torch.zeros_like(comb)), min=1e-6)
    w = w / w.sum(-1, keepdim=True)
    ctx = _context(memory, w)
    if t_prob is None:
        return ctx, w, None
    lin = (_thread_sums(h_att, bundle.ta_wq) + _thread_sums(x, bundle.ta_wx)
           + _thread_sums(ctx, bundle.ta_wc))
    lin = _block_sum(lin)[:, None]
    return ctx, w, torch.sigmoid(lin + bundle.ta_b)


def _bundle(kind, a_dim, mem_dim, q8, seed):
    """A float32 forward-family bundle at widths A and Mem (H = 48, P =
    24), and its numpy generator."""
    rng = np.random.RandomState(seed)
    hidden, p_dim = 48, 24
    t32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    fields = {f: None for f in fd.DecoderBundle.__dataclass_fields__}
    fields.update(dtype=torch.float32, quantized=False, q_streams=q8,
                  att_kind=kind, pre_dims=(8, p_dim, 2),
                  wq=t32(rng.randn(hidden, a_dim) / hidden ** 0.5),
                  v=t32(rng.randn(a_dim) / a_dim ** 0.5),
                  att_bias=t32(0.1 * rng.randn(a_dim)))
    if kind == "fwd_trans":
        fields.update(ta_wc=t32(0.1 * rng.randn(mem_dim)),
                      ta_wq=t32(0.1 * rng.randn(hidden)),
                      ta_wx=t32(0.1 * rng.randn(p_dim)),
                      ta_b=t32([0.2]))
    return fd.DecoderBundle(**fields), rng


def _operands(bundle, rng, b, t_len, a_dim, mem_dim):
    memory = torch.as_tensor(rng.randn(b, t_len, mem_dim),
                             dtype=torch.float32)
    mt = torch.as_tensor(0.5 * rng.randn(b, t_len, a_dim),
                         dtype=torch.float32)
    lengths = np.maximum(1, t_len - np.arange(b) * 3)
    mask = torch.as_tensor(np.arange(t_len)[None] < lengths[:, None])
    mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    h_att = torch.as_tensor(np.tanh(rng.randn(b, 48)), dtype=torch.float32)
    x = torch.as_tensor(np.maximum(rng.randn(b, 24), 0.0),
                        dtype=torch.float32)
    return mem, mtb, mask_add, h_att, x


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("a_dim", [8, 40, 128, 264, 512])
def test_lane_plan_covers_every_channel_once(a_dim, q8):
    """``lane_plan``, as ``fam_energies`` walks it: the lanes of a
    position a power of two of at most 32, each channel summed by exactly
    one lane, a lane's own group first (its q, v and scales in registers),
    and at A=128 every lane of a float32 position owns one group of 4 (32
    lanes) and of an int8 one a group of 8 (16 lanes, two positions a
    warp)."""
    fw, lpr, chans = lane_plan(a_dim, q8)
    assert lpr & (lpr - 1) == 0 and 1 <= lpr <= 32
    flat = sorted(a for own in chans for a in own)
    assert flat == list(range(a_dim))
    for sub, own in enumerate(chans):
        if sub < a_dim // fw:
            assert own[:fw] == list(range(fw * sub, fw * sub + fw))
    if a_dim == 128:
        assert (lpr, len(chans[0])) == ((16, 8) if q8 else (32, 4))


# the model sums in another float32 order than the plain version (measured
# up to 1.2e-7 of the largest output here): each output within this share
# of its largest value, the card's bound for the float32 instances
F32_TOL = 1e-5


def _close(got, ref):
    err = float((got - ref).abs().max())
    assert err <= F32_TOL * float(ref.abs().max()), err


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["fwd", "fwd_trans"])
@pytest.mark.parametrize("a_dim, mem_dim, t_len", [
    (64, 20, 1), (64, 20, 7), (40, 13, 33), (128, 29, 16), (264, 36, 9)])
def test_f32_fwd_attention_order_is_the_plain_step(a_dim, mem_dim, t_len,
                                                   kind, q8):
    """The float32 forward-family step in the kernel's order (lanes of 4
    float32 channels or 8 int8 codes, summed by shuffles; the (max, sum)
    softmax; the agent's h_att and x terms apart from its ctx terms; the
    context's slots) against ``fwd_attention_plain`` on float32 and int8
    streams, at A of 40 (lanes past the channels idle), 64, 128 and 264
    (groups past the lanes' own): the context, weights and t_prob within
    F32_TOL of their largest."""
    b = 5
    bundle, rng = _bundle(kind, a_dim, mem_dim, q8, t_len + a_dim + q8)
    mem, mtb, mask_add, h_att, x = _operands(bundle, rng, b, t_len, a_dim,
                                             mem_dim)
    prev = torch.softmax(torch.as_tensor(rng.randn(b, t_len),
                                         dtype=torch.float32), -1)
    tp = (torch.as_tensor(rng.uniform(0.1, 0.9, (b, 1)), dtype=torch.float32)
          if kind == "fwd_trans" else None)
    got = f32_fwd_step(h_att, prev, tp, mem, mtb, mask_add, x, bundle)
    ref = fd.fwd_attention_plain(h_att, prev, tp, mem, mtb, mask_add, x,
                                 bundle)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            _close(g, r)


def _model_attention(h_att, state, x, memory, mtb, mask_add, bundle):
    """``attention_plain``'s contract on the model."""
    ctx, w, tp = f32_fwd_step(h_att, state["weights"], state.get("t_prob"),
                              memory, mtb, mask_add, x, bundle)
    return ctx, fd._fwd_state(w, tp)


@functools.lru_cache(maxsize=None)
def _models(attention_type):
    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    return hp, Tacotron(hp, train=False), jax_variables(v_np), port_model(
        hp, v_np)


# both sides run every product in float32 and differ by the order of their
# sums (tests/test_torch_float32_streams.py): absolute
F32_ATOL = 1e-5


@pytest.mark.parametrize("attention_type, streams", [
    ("forward", False), ("forward_transition_agent", False),
    ("forward_transition_agent", True)],
    ids=["fwd-f32", "fwd_trans-f32", "fwd_trans-q8"])
def test_f32_order_matches_interpret_kernel(attention_type, streams):
    """Two float32 W8A8 decoder steps with the model in place of the plain
    attention (``fused_decoder._run_chunk``) against the JAX serving
    kernel in interpret mode at float32 (``fused_decode_chunk(...,
    interpret=True, quantize_streams=streams)``) on the same weights,
    operands and seed pair: spec, stop, context and the carried state
    within F32_ATOL."""
    hp, model, variables, port = _models(attention_type)
    b, t = 3, 16
    text, lengths, speakers = batch(hp, b, t, seed=11)
    langs = np.arange(b, dtype=np.int32) % 2
    memory, mt, mask, carry = jax.jit(functools.partial(
        model.apply, method=Tacotron.encode_for_inference))(
            variables, jnp.asarray(text), jnp.asarray(lengths),
            jnp.asarray(speakers), jnp.asarray(langs))
    memory, mt = memory.astype(jnp.float32), mt.astype(jnp.float32)
    jb = pallas_decoder.extract_decoder_bundle(variables, jnp.float32,
                                               quantize_gates=True)
    bundle = fd.extract_decoder_bundle(port.decoder.cell, torch.float32,
                                       quantize_gates=True,
                                       q_streams=streams)
    tree = lambda x: jax.tree_util.tree_map(
        lambda v: torch.as_tensor(np.array(v)), x)
    t_in = (tree(memory), tree(mt), tree(mask))
    kw = dict(dropout_rate=0.5, zoneout_h=hp.zoneout_hidden,
              zoneout_c=hp.zoneout_cell)
    rng = jax.random.PRNGKey(41)
    carry_j, (spec_j, stop_j) = pallas_decoder.fused_decode_chunk(
        jb, carry, memory, mt, mask, rng, 2, block_cap=b, interpret=True,
        quantize_streams=streams, **kw)
    bits = np.asarray(jax.random.bits(rng, (1, 1, 2), jnp.uint32))
    ops = (fd.prenet_plain, fd.gate_lstm_plain, _model_attention,
           fd.head_plain)
    carry_p, (spec_p, stop_p) = fd._run_chunk(
        ops, bundle, tree(carry), *t_in,
        (int(bits[0, 0, 0]), int(bits[0, 0, 1])), 2, kw["dropout_rate"],
        kw["zoneout_h"], kw["zoneout_c"])
    for name, got, ref in (
            ("spec", spec_p, spec_j), ("stop", stop_p, stop_j),
            ("context", carry_p["context"], carry_j["context"]),
            *((f"att_state {k}", carry_p["att_state"][k],
               carry_j["att_state"][k]) for k in carry_j["att_state"])):
        np.testing.assert_allclose(to_np(got).astype(np.float32),
                                   np.asarray(ref).astype(np.float32),
                                   atol=F32_ATOL, err_msg=name)
