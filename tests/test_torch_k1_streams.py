"""K1's staged attention instances, on the CPU: bf16 compute on int8
streams (location-sensitive and the forward family) and the forward family
on bf16 streams (``csrc/fused_decoder.cu``: ``lsa_staged_step``).

Those instances copy a row's memory transform and memory into rings of
shared-memory slots, a tile of positions at a time, as the host's plan
says (``fused_decoder.att_stream_tiles``); the plan must cover every
position of every length once.  Their arithmetic is reordered against the
parent kernel: the location-sensitive energy sums a lane quad's 8
contiguous channels of each 32-channel group (lc's columns permuted, the
int8 codes dequantized by scale pairs), the family's energy a lane's 8
contiguous channels, then the lanes by shuffles; the softmax takes its
maximum and sum in one reduction of each thread's (max, sum) pair; the
transition agent sums its h_att and x terms in the prologue and ctx . wc
in the context's column loop.  A torch model of that order (float32 sums
in the kernel's order, bf16 rounding where the kernel rounds) is held
against the plain versions (``lsa_attention_plain``,
``fwd_attention_plain``) and, through a decode chunk, against the JAX
kernel in interpret mode.
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


def _bf(x):
    return x.to(torch.bfloat16).float()


def _lane_butterfly(vals, offsets):
    """Lane 0's value after ``v += shfl_xor(v, off)`` for each offset in
    turn, ``vals`` [..., lanes]."""
    for off in offsets:
        idx = torch.arange(vals.shape[-1]) ^ off
        vals = vals + vals[..., idx]
    return vals[..., 0]


def _softmax_stats(e):
    """``block_softmax_stats`` over [B, T] energies: thread ``tid`` owns
    the positions ``tid, tid + 256, ...`` (its maximum, then its sum of
    exp(e - maximum)); each warp's maximum, its lanes' sums rescaled to it
    and summed by the xor butterfly (lane 0's); then the block's maximum
    and the warps' sums rescaled to it in warp order."""
    b, t = e.shape
    cols = -(-t // THREADS) * THREADS
    pad = torch.full((b, cols), NEG_INF)
    pad[:, :t] = e
    own = pad.view(b, -1, THREADS)                     # [B, rounds, tid]
    m = own.max(1).values
    s = torch.where(m == NEG_INF, torch.zeros_like(m),
                    torch.exp(own - m[:, None]).sum(1))
    m, s = m.view(b, WARPS, 32), s.view(b, WARPS, 32)
    wm = m.max(-1).values                               # [B, warps]
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


def _dequant_pairs(mtb, d):
    """The memory transform as the staged kernels read it: int8 codes times
    their channel's scale, the scales taken a float2 pair (a, a + 1) at a
    time, rounded to the compute type; bf16 streams as they are."""
    if not isinstance(mtb, fd.Int8Stream):
        return mtb.float()
    s = mtb.scale.float().view(-1, 2)                  # the float2 pairs
    q = mtb.q.float().view(*mtb.q.shape[:2], -1, 2)
    return _bf(q * s).flatten(2).to(d).float()


def _context_tiles(memory, w, d, tile):
    """sum_t bf16(memory[t] * bf16(w[t])) over the ring's tiles in order,
    int8 streams scaled after the sum."""
    wr = _bf(w)
    q8 = isinstance(memory, fd.Int8Stream)
    mem = memory.q.float() if q8 else memory.float()
    ctx = torch.zeros(mem.shape[0], mem.shape[2])
    for lo in range(0, mem.shape[1], tile):
        part = _bf(mem[:, lo:lo + tile] * wr[:, lo:lo + tile, None])
        for r in range(part.shape[1]):
            ctx = ctx + part[:, r]
    return ctx * memory.scale if q8 else ctx


def _ls_lane_order(a_dim):
    """Each lane quad qd's channels in the order it sums them: per whole
    32-channel group its n8 tiles k and pairs e (channel 32 G + 8 qd + 2 k
    + e, ``band_stage_lc_grouped``), then the pairs 2 qd, 2 qd + 1 of each
    n8 tile past the last group."""
    a32 = a_dim // 32 * 32
    order = []
    for qd in range(4):
        chans = [g + 8 * qd + 2 * k + e for g in range(0, a32, 32)
                 for k in range(4) for e in range(2)]
        chans += [n0 + 2 * qd + e for n0 in range(a32, a_dim, 8)
                  for e in range(2)]
        order.append(chans)
    return order


def staged_lsa_step(h_att, cum, memory, mtb, mask_add, bundle):
    """The staged location-sensitive step in the kernel's order."""
    d = bundle.dtype
    q = fd._rounded(fd._mm(h_att, bundle.wq), d)
    loc = fd._location_conv(fd._rounded(cum, d), bundle.lc)
    z = _bf(_bf(_bf(loc) + q[:, None, :]) + _dequant_pairs(mtb, d))
    vt = _bf(torch.tanh(z)) * bundle.v.float()         # [B, T, A]
    lanes = []
    for chans in _ls_lane_order(vt.shape[2]):
        acc = torch.zeros(vt.shape[:2])
        for a in chans:
            acc = acc + vt[:, :, a]
        lanes.append(acc)
    e = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) + mask_add
    m, s = _softmax_stats(e)
    w = torch.exp(e - m[:, None]) / s[:, None]
    tile = fd.att_stream_tiles(cum.shape[1], vt.shape[2],
                               _stream(memory).shape[2], 1)[2]
    return _context_tiles(memory, w, d, tile), cum + w


def _stream(x):
    return x.q if isinstance(x, fd.Int8Stream) else x


def _thread_sums(x, w):
    """Each of the 256 threads' sum of bf16(x[k]) w[k] over k = tid, tid +
    256, ... in order -> [B, 256]."""
    n = x.shape[1]
    cols = -(-n // THREADS) * THREADS
    prod = torch.zeros(x.shape[0], cols)
    prod[:, :n] = _bf(x) * w.float()
    out = torch.zeros(x.shape[0], THREADS)
    for r in range(cols // THREADS):
        out = out + prod[:, r * THREADS:(r + 1) * THREADS]
    return out


def staged_fwd_step(h_att, prev, t_prob, memory, mtb, mask_add, x, bundle):
    """The staged forward-family step in the kernel's order."""
    d = bundle.dtype
    q = fd._rounded(fd._mm(h_att, bundle.wq), d)
    z = _bf(q[:, None, :] + _dequant_pairs(mtb, d))
    vt = _bf(torch.tanh(z)) * bundle.v.float()
    a_dim = vt.shape[2]
    nch = a_dim // 8
    lpr = 1
    while lpr < nch and lpr < 32:
        lpr *= 2
    lanes = torch.zeros(*vt.shape[:2], lpr)
    for sub in range(lpr):
        for c in range(sub, nch, lpr):
            for i in range(8):
                lanes[..., sub] = lanes[..., sub] + vt[:, :, 8 * c + i]
    offs = []
    off = lpr // 2
    while off:
        offs.append(off)
        off //= 2
    e = _lane_butterfly(lanes, offs)
    m, s = _softmax_stats(e)
    energy = torch.exp(e - m[:, None]) / s[:, None]
    shifted = torch.nn.functional.pad(_bf(prev), (1, 0))[:, :-1]
    comb = prev + shifted if t_prob is None else (
        (1.0 - t_prob) * prev + t_prob * shifted)
    w = torch.clamp(torch.where(mask_add > -0.5, comb * energy,
                                torch.zeros_like(comb)), min=1e-6)
    w = w / w.sum(-1, keepdim=True)
    tile = fd.att_stream_tiles(prev.shape[1], a_dim,
                               _stream(memory).shape[2],
                               _stream(memory).element_size())[2]
    ctx = _context_tiles(memory, w, d, tile)
    if t_prob is None:
        return ctx, w, None
    # the agent: each thread's h_att and x terms in the prologue, its
    # ctx . wc terms in the column loop, then one block sum
    lin = (_thread_sums(h_att, bundle.ta_wq) + _thread_sums(x, bundle.ta_wx)
           + _thread_sums(ctx, bundle.ta_wc))
    lin = lin.sum(1, keepdim=True)
    return ctx, w, torch.sigmoid(lin + bundle.ta_b)


def _bundle(kind, a_dim, mem_dim, q8, seed):
    """A bf16 attention bundle of ``kind`` at widths A and Mem (H = 48,
    P = 24, 7 taps), and its int8 or bf16 streams [B, T, *]."""
    rng = np.random.RandomState(seed)
    hidden, p_dim = 48, 24
    t16 = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    fields = {f: None for f in fd.DecoderBundle.__dataclass_fields__}
    fields.update(dtype=torch.bfloat16, quantized=False, q_streams=q8,
                  att_kind=kind, pre_dims=(8, p_dim, 2),
                  wq=t16(rng.randn(hidden, a_dim) / hidden ** 0.5),
                  v=torch.as_tensor(rng.randn(a_dim) / a_dim ** 0.5,
                                    dtype=torch.float32),
                  att_bias=torch.as_tensor(0.1 * rng.randn(a_dim),
                                           dtype=torch.float32))
    if kind == "ls":
        fields["lc"] = t16(0.3 * rng.randn(7, a_dim))
    if kind == "fwd_trans":
        fields.update(ta_wc=t16(0.1 * rng.randn(mem_dim)),
                      ta_wq=t16(0.1 * rng.randn(hidden)),
                      ta_wx=t16(0.1 * rng.randn(p_dim)),
                      ta_b=torch.as_tensor([0.2], dtype=torch.float32))
    return fd.DecoderBundle(**fields), rng


def _operands(bundle, rng, b, t_len, a_dim, mem_dim):
    memory = torch.as_tensor(rng.randn(b, t_len, mem_dim),
                             dtype=torch.float32).to(torch.bfloat16)
    mt = torch.as_tensor(0.5 * rng.randn(b, t_len, a_dim),
                         dtype=torch.float32).to(torch.bfloat16)
    lengths = np.maximum(1, t_len - np.arange(b) * 3)
    mask = torch.as_tensor(np.arange(t_len)[None] < lengths[:, None])
    mem, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    h_att = torch.as_tensor(np.tanh(rng.randn(b, 48)), dtype=torch.float32)
    x = torch.as_tensor(np.maximum(rng.randn(b, 24), 0.0),
                        dtype=torch.float32)
    return mem, mtb, mask_add, h_att, x


# the staged kernels sum the energy's channels and the softmax's terms in
# another float32 order than the plain version: the weights agree within
# float32 rounding (measured up to 6e-8 here); a weight whose bf16 rounding
# flips would move the context by one bf16 ulp of that weight times its
# memory row, so the context is held to one bf16 ulp at 1, as on the card
# (measured up to 2.4e-7 here): absolute
W_ATOL, CTX_ATOL = 1e-6, 8e-3


@pytest.mark.parametrize("a_dim, mem_dim", [(64, 20), (72, 13)])
@pytest.mark.parametrize("t_len", [1, 7, 16, 40])
def test_staged_lsa_on_int8_streams_is_the_plain_step(t_len, a_dim,
                                                      mem_dim):
    """The staged location-sensitive step on int8 streams (lane quads of 8
    channels a 32-channel group, the tail group of A=72 as pairs; scale
    pairs; the (max, sum) softmax; the context over the ring's tiles)
    against ``lsa_attention_plain``: cum within W_ATOL, the context within
    CTX_ATOL."""
    b = 5
    bundle, rng = _bundle("ls", a_dim, mem_dim, True, t_len + a_dim)
    mem, mtb, mask_add, h_att, _ = _operands(bundle, rng, b, t_len, a_dim,
                                             mem_dim)
    cum = torch.as_tensor(np.clip(rng.rand(b, t_len), 0, None),
                          dtype=torch.float32)
    ctx, cum_new = staged_lsa_step(h_att, cum, mem, mtb, mask_add, bundle)
    ctx_p, cum_p = fd.lsa_attention_plain(h_att, cum, mem, mtb, mask_add,
                                          bundle)
    torch.testing.assert_close(cum_new, cum_p, rtol=0, atol=W_ATOL)
    torch.testing.assert_close(ctx, ctx_p, rtol=0, atol=CTX_ATOL)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("kind", ["fwd", "fwd_trans"])
@pytest.mark.parametrize("t_len", [1, 7, 40])
def test_staged_fwd_attention_is_the_plain_step(t_len, kind, q8):
    """The staged forward-family step (8-channel lanes summed by
    shuffles, the (max, sum) softmax, the agent's h_att and x terms apart
    from its ctx terms) against ``fwd_attention_plain`` on bf16 and int8
    streams at A=64 (8 lanes a position) and Mem=20: the weights within
    W_ATOL, the context within CTX_ATOL, t_prob within 1e-5 (float32
    sums in another order)."""
    b, a_dim, mem_dim = 5, 64, 20
    bundle, rng = _bundle(kind, a_dim, mem_dim, q8, 3 * t_len + q8)
    mem, mtb, mask_add, h_att, x = _operands(bundle, rng, b, t_len, a_dim,
                                             mem_dim)
    prev = torch.softmax(torch.as_tensor(rng.randn(b, t_len),
                                         dtype=torch.float32), -1)
    tp = (torch.as_tensor(rng.uniform(0.1, 0.9, (b, 1)), dtype=torch.float32)
          if kind == "fwd_trans" else None)
    ctx, w, tp_new = staged_fwd_step(h_att, prev, tp, mem, mtb, mask_add, x,
                                     bundle)
    ctx_p, w_p, tp_p = fd.fwd_attention_plain(h_att, prev, tp, mem, mtb,
                                              mask_add, x, bundle)
    torch.testing.assert_close(w, w_p, rtol=0, atol=W_ATOL)
    torch.testing.assert_close(ctx, ctx_p, rtol=0, atol=CTX_ATOL)
    if tp is not None:
        torch.testing.assert_close(tp_new, tp_p, rtol=0, atol=1e-5)


def _staged_attention(h_att, state, x, memory, mtb, mask_add, bundle):
    """``attention_plain``'s contract on the staged models."""
    if bundle.att_kind == "ls":
        ctx, cum = staged_lsa_step(h_att, state["weights"], memory, mtb,
                                   mask_add, bundle)
        return ctx, {"weights": cum}
    ctx, w, tp = staged_fwd_step(h_att, state["weights"], state.get("t_prob"),
                                 memory, mtb, mask_add, x, bundle)
    return ctx, fd._fwd_state(w, tp)


@functools.lru_cache(maxsize=None)
def _models(attention_type):
    hp = tiny_hp(attention_type=attention_type)
    v_np = variables_np(attention_type=attention_type)
    return hp, Tacotron(hp, train=False), jax_variables(v_np), port_model(
        hp, v_np)


# a rounded bf16 intermediate may flip one ulp where the two sides sum in
# another order (as tests/test_torch_float32_streams.py's bf16 chunks):
# relative error (norms)
BF16_REL = 1e-2


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("attention_type, streams", [
    ("location_sensitive", True),
    ("forward_transition_agent", False),
    ("forward", True),
], ids=["ls-q8", "fwd_trans-bf16", "fwd-q8"])
def test_staged_step_matches_interpret_kernel(attention_type, streams):
    """Two bf16 W8A8 decoder steps with the staged attention model in place
    of the plain attention (``fused_decoder._run_chunk``) against the JAX
    serving kernel in interpret mode (``fused_decode_chunk(...,
    interpret=True, quantize_streams=streams)``) on the same weights,
    operands and seed pair: spec, stop, context and the carried weights
    within BF16_REL."""
    hp, model, variables, port = _models(attention_type)
    b, t = 3, 16
    text, lengths, speakers = batch(hp, b, t, seed=7)
    langs = np.arange(b, dtype=np.int32) % 2
    memory, mt, mask, carry = jax.jit(functools.partial(
        model.apply, method=Tacotron.encode_for_inference))(
            variables, jnp.asarray(text), jnp.asarray(lengths),
            jnp.asarray(speakers), jnp.asarray(langs))
    memory, mt = memory.astype(jnp.bfloat16), mt.astype(jnp.bfloat16)
    jb = pallas_decoder.extract_decoder_bundle(variables, jnp.bfloat16,
                                               quantize_gates=True)
    bundle = fd.extract_decoder_bundle(port.decoder.cell, torch.bfloat16,
                                       quantize_gates=True,
                                       q_streams=streams)
    tree = lambda x: jax.tree_util.tree_map(
        lambda v: torch.as_tensor(np.array(v)), x)
    t_in = (tree(memory.astype(jnp.float32)).to(torch.bfloat16),
            tree(mt.astype(jnp.float32)).to(torch.bfloat16), tree(mask))
    kw = dict(dropout_rate=0.5, zoneout_h=hp.zoneout_hidden,
              zoneout_c=hp.zoneout_cell)
    rng = jax.random.PRNGKey(40)
    carry_j, (spec_j, stop_j) = pallas_decoder.fused_decode_chunk(
        jb, carry, memory, mt, mask, rng, 2, block_cap=b, interpret=True,
        quantize_streams=streams, **kw)
    bits = np.asarray(jax.random.bits(rng, (1, 1, 2), jnp.uint32))
    ops = (fd.prenet_plain, fd.gate_lstm_plain, _staged_attention,
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
        got = to_np(got).astype(np.float32)
        ref = np.asarray(ref).astype(np.float32)
        assert _rel(got, ref) < BF16_REL, (name, _rel(got, ref))


_WIDTHS = [(128, 292), (128, 548), (128, 288), (64, 13), (8, 5)]


@pytest.mark.parametrize("stream_bytes", [1, 2, 4])
@pytest.mark.parametrize("a_dim, mem_dim", _WIDTHS)
def test_stream_tiles_cover_every_length(a_dim, mem_dim, stream_bytes):
    """``att_stream_tiles`` at every T from 1 to 2,304: the memory
    transform's tiles whole 16-position mma tiles, the memory's whole
    periods of the context's chunks (``ctx_period``), 1 or 2 and 1 to 3
    slots, each ring within its bytes (but at its smallest tile); tile j
    covers [j * tile, min(T, (j + 1) * tile)), so the tiles cover every
    position exactly once, in order; a slot holds a tile's bytes and 16
    more for its offset within 16 bytes."""
    period = fd.ctx_period(mem_dim, stream_bytes)
    assert period == (16 // stream_bytes) // np.gcd(mem_dim,
                                                     16 // stream_bytes)
    for t_len in range(1, 2305):
        mt_tile, mt_stages, mem_tile, mem_stages = fd.att_stream_tiles(
            t_len, a_dim, mem_dim, stream_bytes)
        assert mt_tile % 16 == 0 and 1 <= mt_stages <= 2
        assert mem_tile % period == 0 and 1 <= mem_stages <= 3
        for tile, stages, row, budget, least in (
                (mt_tile, mt_stages, a_dim * stream_bytes,
                 fd._MT_RING_BYTES, 16),
                (mem_tile, mem_stages, mem_dim * stream_bytes,
                 fd._MEM_RING_BYTES, period)):
            n = -(-t_len // tile)
            assert stages == min(n, stages) and stages <= n
            assert tile == least or tile * row * stages <= budget
            starts = np.arange(n) * tile
            rows = np.minimum(tile, t_len - starts)
            # each tile begins where the last ended, none is empty, and
            # the last ends at T
            assert rows.min() >= 1 and starts[0] == 0
            np.testing.assert_array_equal(starts[1:],
                                          starts[:-1] + rows[:-1])
            assert starts[-1] + rows[-1] == t_len
    assert fd.att_stream_tiles(128, 128, 292, 1) == (128, 1, 64, 2)
    assert fd.att_stream_tiles(128, 128, 292, 2) == (64, 2, 32, 3)


def test_tanh_table_bounds_hold_for_every_bf16():
    """The staged energies read bf16(tanh(z)) for a bf16 z from a table
    over [2^-8, 4) in magnitude (``csrc/fused_decoder.cu``: TANH_LO,
    TANH_HI, ``tanh_bf16``) and take z itself below it, 1 from 4 on, and
    the sign of z: every finite bf16 z of either sign, with PyTorch's
    float32 tanh standing for tanhf, rounds to exactly that."""
    lo, hi = 0x3B80, 0x4080
    bits = torch.arange(0x7F80, dtype=torch.int32)
    z = (bits << 16).view(torch.float32)
    ref = _bf(torch.tanh(z))
    assert float(z[lo]) == 2.0 ** -8 and float(z[hi]) == 4.0
    torch.testing.assert_close(ref[:lo], z[:lo], rtol=0, atol=0)
    assert bool((ref[hi:] == 1.0).all())
    torch.testing.assert_close(_bf(torch.tanh(-z)), -ref, rtol=0, atol=0)

