"""The algebra of the attention kernels' location-conv band routine
(``csrc/tile.cuh``: ``band_*``), on the CPU, as the kernels tile it.

The conv of a bf16 cum row with the folded filter lc [K, A] is a product
with the band matrix of cum, ``band(cum)[t][k] = cum[t + k - half]`` (zero
outside [0, T)), K padded to 32 taps with zero taps:

- ``band(cum) @ lc`` is the location conv of ``lsa_attention_plain`` and
  of the training forward (``F.conv1d``, padding ``half``);
- ``band(cum)^T @ dz`` is that conv's filter gradient;
- ``P = dz @ lc^T`` summed along its diagonals, ``dcum[t'] = sum_k
  P[t' - k + half][k]``, is its cum gradient.

Each tile of positions keeps cum from ``half`` before its first position
on (the kernels' ``s_cum``), so band rows are windows of that one vector;
``att_bwd`` splits T into the tiles of ``att_bwd_tiles`` and reads P's
halo rows from the neighbouring tiles, summing the filter gradient's tile
partials in tile order.  The products run in float64 here so that only
the algebra is compared; the kernels' float32 sums are held against the
plain versions on the card (``tests/test_torch_gpu.py``).

The training forward's ``train_attention`` splits T into the same tiles:
each tile's energies from its band rows, the row's softmax from the tile
maxima and tile sums combined in rank order, and the context from each
tile's partial, summed in rank order by the CTA that owns a share of the
memory columns.  A torch model of that split is held against
``train_attention_plain`` in float32, on cum and filter values whose conv
is exact in any order.  The forward family's step runs three exchanges:
each tile's (maximum, sum of exp(e - maximum)) pair combined in rank order
(the online softmax), the renorm's tile sums, and the context partials,
beside which each tile publishes the transition agent's partial (its
prologue's h_att and x shares plus wc . the tile's partial context); a
model of that is held against ``train_fwd_attention_plain`` and
``transition_plain``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multilingual_text_to_speech_tpu_torch.ops.fused_train_decoder import (
    att_bwd_tiles,
    train_attention_plain,
    train_fwd_attention_plain,
    transition_plain,
)

BAND_K = 32
_A, _ROWS = 16, 3


def _operands(t_len, k_taps, seed):
    """bf16-valued cum [B, T] (a ramp plus noise), lc [K, A] and a
    cotangent dz [B, T, A], in float64."""
    rng = np.random.RandomState(seed)
    cum = np.clip(np.linspace(1.5, -0.5, t_len)[None]
                  + 0.1 * rng.randn(_ROWS, t_len), 0.0, None)
    lc = 0.1 * rng.randn(k_taps, _A)
    dz = rng.randn(_ROWS, t_len, _A)

    def bf16(x):
        return torch.as_tensor(x, dtype=torch.float32).bfloat16().double()

    return bf16(cum), bf16(lc), bf16(dz)


def _s_cum(cum, t0, n, half):
    """The kernels' shared cum of a tile from ``t0``: ``s_cum[i] =
    cum[t0 + i - half]`` for i < n, zero outside [0, T)."""
    t = t0 + torch.arange(n) - half
    ok = (t >= 0) & (t < cum.shape[-1])
    return torch.where(ok, cum[..., t.clamp(0, cum.shape[-1] - 1)],
                       cum.new_zeros(()))


def _band(cum, t0, rows, half):
    """band(cum) rows [t0, t0 + rows) over 32 taps: windows of ``s_cum``."""
    s = _s_cum(cum, t0, rows + BAND_K, half)
    idx = torch.arange(rows)[:, None] + torch.arange(BAND_K)[None]
    return s[..., idx]                                   # [B, rows, 32]


def _lc32(lc):
    return F.pad(lc, (0, 0, 0, BAND_K - lc.shape[0]))    # [32, A]


def _conv(cum, lc):
    """The location conv as ``lsa_attention_plain`` computes it."""
    k = lc.shape[0]
    return F.conv1d(cum[:, None, :], lc.t()[:, None, :],
                    padding=(k - 1) // 2).transpose(1, 2)   # [B, T, A]


_CASES = pytest.mark.parametrize("t_len", [1, 7, 16, 45, 128])
_TAPS = pytest.mark.parametrize("k_taps", [3, 31])


@_TAPS
@_CASES
def test_band_product_is_the_location_conv(t_len, k_taps):
    """``band(cum) @ lc`` over 16-row tiles (the forward's mma tiles, T
    padded to a multiple of 16) equals the conv, T < K included."""
    cum, lc, _ = _operands(t_len, k_taps, seed=t_len + k_taps)
    half = (k_taps - 1) // 2
    tpad = -(-t_len // 16) * 16
    loc = torch.cat([_band(cum, t0, 16, half) @ _lc32(lc)
                     for t0 in range(0, tpad, 16)], dim=1)[:, :t_len]
    torch.testing.assert_close(loc, _conv(cum, lc), rtol=1e-12, atol=1e-12)


@_TAPS
@_CASES
def test_band_transpose_product_is_the_filter_gradient(t_len, k_taps):
    """``band(cum)^T @ dz``, one partial per ``att_bwd`` tile summed in
    tile order, equals autograd's filter gradient through the conv; its
    padded taps K..31 are dropped."""
    cum, lc, dz = _operands(t_len, k_taps, seed=2 * t_len + k_taps)
    half = (k_taps - 1) // 2
    tile, cluster = att_bwd_tiles(t_len)
    dzp = F.pad(dz, (0, 0, 0, cluster * tile - t_len))
    dlc = torch.zeros(_ROWS, BAND_K, _A, dtype=torch.float64)
    for r in range(cluster):
        band = _band(cum, r * tile, tile, half)
        dlc = dlc + band.transpose(1, 2) @ dzp[:, r * tile:(r + 1) * tile]
    lcg = lc.clone().requires_grad_(True)
    (_conv(cum, lcg) * dz).sum().backward()
    torch.testing.assert_close(dlc.sum(0)[:k_taps], lcg.grad, rtol=1e-12,
                               atol=1e-12)


@_TAPS
@_CASES
def test_band_diagonal_sum_is_the_cum_gradient(t_len, k_taps):
    """P = dz @ lc^T per ``att_bwd`` tile; the cum gradient of a position
    is a diagonal of P whose rows reach up to ``half`` positions into the
    neighbouring tiles; it equals autograd's cum gradient through the
    conv."""
    cum, lc, dz = _operands(t_len, k_taps, seed=3 * t_len + k_taps)
    half = (k_taps - 1) // 2
    tile, cluster = att_bwd_tiles(t_len)
    dzp = F.pad(dz, (0, 0, 0, cluster * tile - t_len))
    p_tiles = [dzp[:, r * tile:(r + 1) * tile] @ _lc32(lc).t()
               for r in range(cluster)]                 # [B, tile, 32]
    dcum = torch.zeros(_ROWS, t_len, dtype=torch.float64)
    for t in range(t_len):
        for k in range(k_taps):
            t2 = t - k + half
            if 0 <= t2 < t_len:
                dcum[:, t] += p_tiles[t2 // tile][:, t2 % tile, k]
    cumg = cum.clone().requires_grad_(True)
    (_conv(cumg, lc) * dz).sum().backward()
    torch.testing.assert_close(dcum, cumg.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t_len,want", [
    (1, (16, 1)), (16, (16, 1)), (17, (16, 2)), (128, (16, 8)),
    (129, (32, 5)), (200, (32, 7)), (256, (32, 8)), (512, (64, 8))])
def test_att_bwd_tiles_at_known_lengths(t_len, want):
    """T=128 (the training path) takes 8 CTAs of 16 positions; T=200
    takes 7 of 32, its last part filled; T=512 takes 8 of 64."""
    assert att_bwd_tiles(t_len) == want


def test_att_bwd_tiles_cover_every_length():
    """For every T up to 512: whole 16-row tiles, at most 8 CTAs (the
    portable cluster size), none empty, and the smallest such tile."""
    for t_len in range(1, 513):
        tile, cluster = att_bwd_tiles(t_len)
        assert tile % 16 == 0 and 1 <= cluster <= 8
        assert (cluster - 1) * tile < t_len <= cluster * tile
        assert tile == 16 or -(-t_len // (tile - 16)) > 8
    with pytest.raises(ValueError):
        att_bwd_tiles(0)


def _tiled_train_attention(q, cum, memory, mtb, mask_add, lc, v):
    """``train_attention`` as its kernel splits a batch row over the CTAs
    of a cluster (``att_bwd_tiles``): each tile's energies from band(cum)
    rows with the halo (16-row mma tiles), the tile maxima and then the
    tile sums of exp(e - max) combined in rank order, and each tile's
    context partial summed in rank order for each CTA's share of the
    memory columns.  -> (w, cum + w, ctx), float32."""
    b, t_len, n_mem = memory.shape
    d = memory.dtype
    k = lc.shape[0]
    half = (k - 1) // 2
    tile, cluster = att_bwd_tiles(t_len)
    cum16 = cum.to(d).float()
    lc32 = _lc32(lc.float())
    tiles = [(r * tile, min(tile, t_len - r * tile)) for r in range(cluster)]

    def rounded(x):
        return x.to(d).float()

    energies = []
    for t0, rows in tiles:
        band = torch.cat([_band(cum16, t0 + 16 * mt, 16, half)
                          for mt in range(tile // 16)], dim=1)[:, :rows]
        z = rounded(rounded(rounded(band @ lc32) + q[:, None, :])
                    + mtb[:, t0:t0 + rows].float())
        tz = rounded(torch.tanh(z))
        energies.append((tz * v).sum(-1) + mask_add[:, t0:t0 + rows])
    mx = energies[0].amax(1)
    for e in energies[1:]:
        mx = torch.maximum(mx, e.amax(1))
    ps = [torch.exp(e - mx[:, None]) for e in energies]
    total = ps[0].sum(1)
    for p in ps[1:]:
        total = total + p.sum(1)
    w = torch.cat([p / total[:, None] for p in ps], dim=1)
    partials = [rounded(memory[:, t0:t0 + rows].float()
                        * rounded(w[:, t0:t0 + rows])[:, :, None]).sum(1)
                for t0, rows in tiles]
    share = -(-n_mem // cluster)
    ctx = torch.zeros(b, n_mem)
    owned = torch.zeros(n_mem, dtype=torch.int64)
    for r in range(cluster):
        cols = slice(r * share, min(n_mem, (r + 1) * share))
        acc = partials[0][:, cols]
        for part in partials[1:]:
            acc = acc + part[:, cols]
        ctx[:, cols] = acc
        owned[cols] += 1
    assert bool((owned == 1).all())
    return w, cum + w, ctx


@pytest.mark.parametrize("t_len", [16, 100, 128, 200, 512])
def test_tiled_train_attention_is_the_plain_attention(t_len):
    """The tiled model equals ``train_attention_plain`` at the training
    path's memory width (292 columns, 8 CTAs of 37) and 31 taps: the
    weights and the new cum within float32 sum order (rtol 1e-5), the
    context within one bf16 ulp of one weight times the largest memory
    value (a weight on a rounding boundary may round the other way after a
    sum in another order).  cum lies on a 1/64 grid and the filter on a
    1/256 grid, so that the conv is exact in any order."""
    rng = np.random.RandomState(t_len)
    b, a, n_mem, k = 3, 16, 292, 31
    cum = torch.as_tensor(rng.randint(0, 256, (b, t_len)) / 64.0,
                          dtype=torch.float32)
    lc = torch.as_tensor(rng.randint(-255, 256, (k, a)) / 256.0,
                         dtype=torch.float32).bfloat16()
    q = torch.as_tensor(rng.randn(b, a), dtype=torch.float32).bfloat16()
    memory = torch.as_tensor(rng.randn(b, t_len, n_mem),
                             dtype=torch.float32).bfloat16()
    mtb = torch.as_tensor(0.5 * rng.randn(b, t_len, a),
                          dtype=torch.float32).bfloat16()
    v = torch.as_tensor(rng.randn(a) / a ** 0.5, dtype=torch.float32)
    lengths = np.array([t_len, max(1, t_len - 7), max(1, t_len // 2)])
    mask_add = torch.as_tensor(np.where(
        np.arange(t_len)[None] < lengths[:, None], 0.0, -1e9),
        dtype=torch.float32)
    got = _tiled_train_attention(q.float(), cum, memory, mtb, mask_add, lc, v)
    ref = train_attention_plain(q.float(), cum, memory, mtb, mask_add, lc, v)
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-7)
    ulp = 2.0 ** -8 * float(ref[0].max()) * float(memory.float().abs().max())
    assert float((got[2] - ref[2]).abs().max()) <= ulp + 1e-6


def _tiled_fwd_attention(q, prev, tp, memory, mtb, mask_add, v, agent):
    """The forward family's ``train_attention`` as its kernel splits a
    batch row over a cluster (``att_bwd_tiles``), in float32: each tile's
    energies, its maximum m_j and s_j = sum exp(e - m_j) combined in rank
    order (M = max m_j, S = sum_j s_j exp(m_j - M)); the recurrence with
    the halo prev[t_lo - 1], the mask and the 1e-6 floor; the tile sums of
    the floored weights in rank order; each tile's context partial summed
    in rank order for each CTA's share of the columns; with the agent
    ``(h_att, x, w, b)``, CTA j's partial is its share of h_att . wq and
    x . wx (ceil(H / cl), ceil(P / cl) values) plus wc . its partial
    context, and rank 0 sums the partials in rank order after the bias.
    -> (w, ctx, t_prob or None)."""
    b, t_len, n_mem = memory.shape
    tile, cluster = att_bwd_tiles(t_len)
    tiles = [(r * tile, min(tile, t_len - r * tile)) for r in range(cluster)]
    energies = [(torch.tanh(q[:, None, :] + mtb[:, t0:t0 + rows]) * v).sum(-1)
                for t0, rows in tiles]
    pairs = [(e.amax(1), torch.exp(e - e.amax(1)[:, None]).sum(1))
             for e in energies]
    big = pairs[0][0]
    for m, _ in pairs[1:]:
        big = torch.maximum(big, m)
    total = torch.zeros(b)
    for m, s in pairs:
        total = total + s * torch.exp(m - big)
    shifted = torch.cat([torch.zeros(b, 1), prev[:, :-1]], dim=1)
    floored = []
    for e, (t0, rows) in zip(energies, tiles):
        energy = torch.exp(e - big[:, None]) / total[:, None]
        p, sh = prev[:, t0:t0 + rows], shifted[:, t0:t0 + rows]
        comb = p + sh if tp is None else (1.0 - tp[:, None]) * p \
            + tp[:, None] * sh
        keep = mask_add[:, t0:t0 + rows] > -0.5
        floored.append(torch.clamp(torch.where(keep, comb * energy,
                                               torch.zeros_like(comb)),
                                   min=1e-6))
    wsum = torch.zeros(b)
    for f in floored:
        wsum = wsum + f.sum(1)
    w = torch.cat([f / wsum[:, None] for f in floored], dim=1)
    partials = [(memory[:, t0:t0 + rows] * w[:, t0:t0 + rows, None]).sum(1)
                for t0, rows in tiles]
    share = -(-n_mem // cluster)
    ctx = torch.zeros(b, n_mem)
    for r in range(cluster):
        cols = slice(r * share, min(n_mem, (r + 1) * share))
        acc = partials[0][:, cols]
        for part in partials[1:]:
            acc = acc + part[:, cols]
        ctx[:, cols] = acc
    if agent is None:
        return w, ctx, None
    h_att, x, aw, ab = agent
    hidden, n_x = h_att.shape[1], x.shape[1]
    wc, wq, wx = aw[:n_mem], aw[n_mem:n_mem + hidden], aw[n_mem + hidden:]
    sh_h, sh_p = -(-hidden // cluster), -(-n_x // cluster)
    z = ab.expand(b).clone()
    for r, part in enumerate(partials):
        hk = slice(r * sh_h, min(hidden, (r + 1) * sh_h))
        xk = slice(r * sh_p, min(n_x, (r + 1) * sh_p))
        z = z + ((h_att[:, hk] * wq[hk]).sum(1) + (x[:, xk] * wx[xk]).sum(1)
                 + (part * wc).sum(1))
    return w, ctx, torch.sigmoid(z)


@pytest.mark.parametrize("agent", [False, True])
@pytest.mark.parametrize("t_len", [1, 16, 100, 128, 600])
def test_family_exchanges_are_the_plain_step(t_len, agent):
    """The forward family's three exchanges (``_tiled_fwd_attention``, at
    the tiles ``att_bwd_tiles`` picks: one CTA at T = 1 and 16, 7 of 16 at
    100, 8 of 16 at 128, 8 of 80 at 600) equal ``train_fwd_attention_plain``
    and ``transition_plain`` in float32 at the training path's memory width
    (292 columns), H = 64 and P = 32: the weights, the context and the
    agent's t_prob within 1e-6 (float32 sums in another order)."""
    rng = np.random.RandomState(t_len + 7 * agent)
    b, a, n_mem, hidden, n_x = 3, 16, 292, 64, 32

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    q = f32(rng.randn(b, a))
    prev = torch.softmax(f32(rng.randn(b, t_len)), -1)
    memory = f32(rng.randn(b, t_len, n_mem))
    mtb = f32(0.5 * rng.randn(b, t_len, a))
    v = f32(rng.randn(a) / a ** 0.5)
    lengths = np.array([t_len, max(1, t_len - 7), max(1, t_len // 2)])
    mask_add = f32(np.where(np.arange(t_len)[None] < lengths[:, None],
                            0.0, -1e9))
    tp, parts = None, None
    if agent:
        tp = f32(rng.uniform(0.1, 0.9, b))
        parts = (f32(np.tanh(rng.randn(b, hidden))),
                 f32(np.maximum(rng.randn(b, n_x), 0.0)),
                 f32(0.1 * rng.randn(n_mem + hidden + n_x)),
                 f32(0.1 * rng.randn(1)))
    w, ctx, tp_new = _tiled_fwd_attention(q, prev, tp, memory, mtb, mask_add,
                                          v, parts)
    w_ref, ctx_ref = train_fwd_attention_plain(q, prev, tp, memory, mtb,
                                               mask_add, v)
    torch.testing.assert_close(w, w_ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(ctx, ctx_ref, rtol=0, atol=1e-6)
    if agent:
        tp_ref = transition_plain(ctx_ref, *parts)
        torch.testing.assert_close(tp_new, tp_ref, rtol=0, atol=1e-6)
