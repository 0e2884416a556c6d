"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: run with ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` on a machine with an NVIDIA Hopper GPU and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax); elsewhere
every test skips.
Small widths, bfloat16 compute, W8A8 and bfloat16 gates; the tensor-core
products (both decoders' gate products, the split-K query, heads and
backward products, the head backward) also at the flagship's widths; the
serving kernels' float32 instances and the attention kernels on int8
streams at the flagship's widths; the training kernels' float32 instances
at small widths, and all three attention kernels on long texts (T up to
1500) in both compute types.
"""

import functools
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (
    ATOL,
    GL_TOL,
    TRAIN_KERNEL_TOL,
    mask_patterns,
    train_kernel_bound,
    train_kernel_calls,
)
from multilingual_text_to_speech_tpu_torch.config import flagship_hparams
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    Tacotron,
    init_random_weights,
)
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder as fd
from multilingual_text_to_speech_tpu_torch.synthesis import Synthesizer

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")


def _hp(int8):
    hp = flagship_hparams()
    for k, v in dict(embedding_dimension=32, encoder_dimension=32,
                     decoder_dimension=48, prenet_dimension=24,
                     attention_dimension=16, attention_kernel_size=7,
                     attention_location_dimension=4, postnet_dimension=16,
                     postnet_blocks=2, num_mels=20, speaker_number=4,
                     bucket_text_multiple=8, bucket_frame_multiple=16,
                     compute_dtype="bfloat16", max_output_length=24,
                     decode_chunk_frames=8, pallas_decoder_int8=int8).items():
        setattr(hp, k, v)
    hp.unique_speakers = ["a", "b", "c", "d"]
    hp.mel_normalize_mean = [0.0] * 20
    hp.mel_normalize_variance = [1.0] * 20
    return hp


def ramp_alignment(mask, seed):
    """Cumulative attention of an alignment part way through each text: 1
    up to a random position, 0 after."""
    gen = torch.Generator().manual_seed(seed)
    lengths = mask.sum(1).float()
    pos = (0.2 + 0.6 * torch.rand(mask.shape[0], generator=gen)).to(
        mask.device) * lengths
    t = torch.arange(mask.shape[1], device=mask.device)[None].float()
    return torch.clamp(pos[:, None] - t, 0.0, 1.0) * mask


def _setup(int8, b=10, t=24):
    hp = _hp(int8)
    torch.manual_seed(0)
    sd = init_random_weights(Tacotron(hp), 0).state_dict()
    syn = Synthesizer(hp, sd, device="cuda")
    text = torch.randint(3, hp.total_symbols(), (b, t), device="cuda")
    lengths = torch.randint(t // 2, t + 1, (b,), device="cuda")
    speakers = torch.randint(0, 4, (b,), device="cuda")
    memory, mt, mask, carry = syn.model.encode_for_inference(
        text, lengths, speakers, torch.arange(b, device="cuda") % 5)
    carry, _ = fd.decode_chunk_plain(syn.bundle, carry, memory, mt, mask,
                                     (3, 4), 2, **syn.decode_kwargs)
    return syn, memory, mt, mask, carry


@pytest.mark.parametrize("int8", [True, False])
def test_step_kernels_match_plain(int8):
    """Masks and int8 activations bit-exact; values within atol 2e-3, the
    context also within rtol 2e-3, and the attention weights within 1e-2 of
    each row's largest weight (float32 sums in another order, bf16
    roundings).  The cumulative weights fed in are 1 up to a position part
    way through each text, as in a real utterance, so that the location
    conv weighs in."""
    syn, memory, mt, mask, carry = _setup(int8)
    bundle = syn.bundle
    b = memory.shape[0]
    seeds = (11, 22)
    n_pre, p_dim = bundle.pre_dims[2], bundle.pre_dims[1]
    keep_k = torch.zeros(n_pre, b, p_dim, dtype=torch.uint8, device="cuda")
    keep_p = torch.zeros_like(keep_k)
    x_k = fd.prenet(carry["frame"], bundle, 0.5, seeds, 3, keep_out=keep_k)
    x = fd.prenet_plain(carry["frame"], bundle, 0.5, seeds, 3, keep_out=keep_p)
    assert torch.equal(keep_k, keep_p)
    torch.testing.assert_close(x_k, x, atol=2e-3, rtol=0)

    segs = (x, carry["context"], carry["h_att"])
    k = sum(s.shape[1] for s in segs)
    q_k = torch.zeros(b, k, dtype=torch.int8, device="cuda")
    q_p = torch.zeros_like(q_k)
    got = fd.gate_lstm(segs, carry["h_att"], carry["c_att"], bundle, "att",
                       0.1, 0.1, q_out=q_k if int8 else None)
    ref = fd.gate_lstm_plain(segs, carry["h_att"], carry["c_att"], bundle,
                             "att", 0.1, 0.1, q_out=q_p if int8 else None)
    assert torch.equal(q_k, q_p)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)

    cum = carry["att_state"]["weights"] + ramp_alignment(mask, seed=5)
    memory, mtb, mask_add = fd.chunk_operands(bundle, memory, mt, mask)
    ctx_k, cum_k = fd.lsa_attention(ref[0], cum, memory, mtb, mask_add,
                                    bundle)
    ctx_p, cum_p = fd.lsa_attention_plain(ref[0], cum, memory, mtb, mask_add,
                                          bundle)
    torch.testing.assert_close(ctx_k, ctx_p, atol=2e-3, rtol=2e-3)
    w_k, w_p = cum_k - cum, cum_p - cum
    assert float(((w_k - w_p).abs().amax(1) / w_p.amax(1)).max()) < 1e-2

    got = fd.head(carry["h_gen"], ctx_p, bundle)
    ref = fd.head_plain(carry["h_gen"], ctx_p, bundle)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)


def test_chunk_and_synthesis_run_the_kernels():
    syn, memory, mt, mask, carry = _setup(True)
    kw = syn.decode_kwargs
    _, (spec_k, _) = fd.decode_chunk(syn.bundle, carry, memory, mt, mask,
                                     (5, 6), 8, **kw)
    _, (spec_p, _) = fd.decode_chunk_plain(syn.bundle, carry, memory, mt,
                                           mask, (5, 6), 8, **kw)
    assert float((spec_k - spec_p).norm() / spec_p.norm()) < 1e-2
    fd.reset_launch_counts()
    out = syn.synthesize_batch_lines(["1|hallo|a|de", "2|salut|b|fr",
                                      "3|mix|c|de*0.5:ru*0.5"])
    assert all(fd.LAUNCHES[k] > 0 for k in fd.path_kernels("ls")), \
        fd.LAUNCHES
    assert fd.LAUNCHES["fwd_attention"] == 0
    assert all(torch.isfinite(torch.as_tensor(o)).all() for o in out)


def test_single_utterance_on_card_matches_cpu():
    """``spectrogram_from_ids`` (batch 1) through the kernels against the
    plain path on the CPU, both bf16: relative error under 1e-2."""
    hp = _hp(True)
    sd = init_random_weights(Tacotron(hp), 1).state_dict()
    sd["decoder.cell.stop_prediction.bias"].fill_(-10.0)
    ids = torch.randint(3, hp.total_symbols(), (17,)).numpy()
    spk = 2
    fd.reset_launch_counts()
    got = Synthesizer(hp, sd, device="cuda").spectrogram_from_ids(ids, spk)
    assert all(fd.LAUNCHES[k] > 0 for k in fd.path_kernels("ls")), \
        fd.LAUNCHES
    ref = Synthesizer(hp, sd, device="cpu").spectrogram_from_ids(ids, spk)
    assert got.shape == ref.shape == (hp.num_mels, hp.max_output_length)
    err = float(torch.as_tensor(got - ref).norm() / torch.as_tensor(ref).norm())
    assert err < 1e-2, err


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("kind", ["location_sensitive", "forward",
                                  "forward_transition_agent"])
def test_f32_train_kernels_match_plain(kind, mode):
    """Every float32 K2/K3 stage (train mode: the five forward and five
    backward kernels of ``chip_smoke.train_kernel_calls``, the cells fused
    into their hosts; eval mode: the forward's, zoneout interpolated) on
    the same card inputs as its plain version, at small widths and each
    attention kind: the dropout and zoneout choices (and the fused cells')
    bit-exact, every output within F32_TOL of its largest value, and only
    ``_f32`` instances launched."""
    import dataclasses

    from chip_smoke import check_cell_masks

    ftd, _, cfg, ops, memory, mtb, mask_add, shifted, teacher = \
        _train_setup_model(dtype=torch.float32, attention_type=kind)
    seeds = (1234, 98765)
    args = (ops, cfg, memory, mtb, mask_add, shifted, teacher, seeds)
    st_p, _ = ftd.train_decode_forward(*args, plain=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    cts = [torch.randn(x.shape, device="cuda", generator=gen)
           for x in (st_p["spec"], st_p["stop"], st_p["w"])]
    k2, k3 = cfg.kernels
    if mode == "eval":
        cfg = dataclasses.replace(cfg, train=False)
    calls, _ = train_kernel_calls(ftd, cfg, ops, memory, mtb, mask_add,
                                  shifted, st_p, teacher, seeds, cts, 6)
    if mode == "eval":
        calls = {k: v for k, v in calls.items()
                 if ftd.instance(k, torch.float32) in k2}
    got, ref = (mask_patterns(k, cfg, ops, st_p, shifted, seeds, 3)
                for k in (ftd.KERNELS, ftd.PLAIN))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    ftd.reset_launch_counts()
    for name, run in calls.items():
        got, ref = run(ftd.KERNELS), run(ftd.PLAIN)
        if name == "bwd_cell":
            check_cell_masks(cfg.hidden, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == r.dtype == torch.float32, (name, i)
            _f32_close(g, r)
    launched = {k for k, v in ftd.LAUNCHES.items() if v}
    assert launched == set(k2 if mode == "eval" else k2 + k3), launched


def test_f32_train_decode_matches_autograd():
    """16 float32 steps through ``TrainDecode`` (K2 forward, K3 backward)
    against ``torch.autograd`` through the plain K2 in differentiable ops,
    from the same card inputs (``chip_smoke.check_train_autograd``, which
    fails above TRAIN_F32_AUTOGRAD_TOL): the outputs and every input's
    gradient."""
    from chip_smoke import check_train_autograd

    ftd, model, cfg, ops, memory, mtb, mask_add, shifted, teacher = \
        _train_setup_model(frames=16, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, t = mask_add.shape
    cts = [torch.randn(*shape, device="cuda", generator=gen)
           for shape in ((16, b, cfg.mmel), (16, b), (16, b, t))]
    with torch.enable_grad():
        check_train_autograd(ftd, model, cfg, memory, mtb, mask_add, shifted,
                             teacher, (9, 10), cts)


# ---------------------------------------------------------------------------
# K1 in float32 and on int8 streams
# ---------------------------------------------------------------------------

# float32 instances against their float32 plain versions: every output
# within this share of its largest value (float32 sums in another order;
# a bf16 operand or a single TF32 pass is off by about 1e-3)
F32_TOL = 1e-5


def _f32_close(got, ref, tol=F32_TOL, slack=0.0):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()) + slack, (
        err, float(ref.abs().max()))


def _cum_slack(t, cum_new):
    """The rounding of float32 weights read back as cum' - cum: one float32
    ulp of the largest |cum'| (the kernel and the plain version each round
    cum + w), past T = 128, where the largest weight of a row falls below
    about 1e-2 and that ulp (1.2e-7 at cum' near 1) exceeds F32_TOL of it;
    0 up to T = 128."""
    return (torch.finfo(torch.float32).eps * float(cum_new.abs().max())
            if t > 128 else 0.0)


@functools.lru_cache(maxsize=None)
def _flagship_cell(attention_type):
    """A flagship ``DecoderCell`` (float32 weights, seeded) on the card."""
    hp = flagship_hparams()
    hp.attention_type = attention_type
    model = init_random_weights(Tacotron(hp, torch.float32), 3)
    return hp, model.decoder.cell.cuda()


def _f32_bundle(attention_type, int8, q_streams=False,
                dtype=torch.float32):
    hp, cell = _flagship_cell(attention_type)
    return hp, fd.extract_decoder_bundle(cell, dtype, quantize_gates=int8,
                                         q_streams=q_streams)


@pytest.mark.parametrize("b", [1, 37, 50, 67, 240])
@pytest.mark.parametrize("int8", [True, False])
def test_f32_step_kernels_match_plain_at_flagship_widths(int8, b):
    """The float32 instances of ``prenet``, both ``gate_lstm`` (W8A8 on the
    unrounded float32 row, or exact float32 products), ``lsa_attention``
    and ``head`` at the flagship's widths (T=128): masks and int8
    activations bit-exact, every other output within F32_TOL of its largest
    value; the head row (float32 h and context) exactly the outputs; a
    second gate_lstm run bit-identical to the first; each launch counted
    under its ``_f32`` instance."""
    hp, bundle = _f32_bundle("location_sensitive", int8)
    gen = torch.Generator(device="cuda").manual_seed(b)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    t, seeds = 128, (5, 6)
    frame = rnd(b, _MELS)
    h_att, c_att, h_gen, c_gen = (rnd(b, _HIDDEN, scale=0.5)
                                  for _ in range(4))
    ctx0 = rnd(b, _MEM, scale=0.5)
    rnd_m, memory, mtb, mask, cum = _attention_operands(b, t, seed=b + 1)
    memory, mtb = memory.float(), mtb.float()
    mask_add = torch.where(mask, 0.0, -1e9)
    fd.reset_launch_counts()

    n_pre = bundle.pre_dims[2]
    keep_k = torch.zeros(n_pre, b, 256, dtype=torch.uint8, device="cuda")
    keep_p = torch.zeros_like(keep_k)
    x = fd.prenet(frame, bundle, 0.5, seeds, 3, keep_out=keep_k)
    x_p = fd.prenet_plain(frame, bundle, 0.5, seeds, 3, keep_out=keep_p)
    assert torch.equal(keep_k, keep_p)
    _f32_close(x, x_p)

    row = torch.zeros(b, bundle.head_w.shape[1], device="cuda")
    for which, segs, h, c in (("att", (x_p, ctx0, h_att), h_att, c_att),
                              ("gen", (h_att, ctx0, h_gen), h_gen, c_gen)):
        k = sum(s.shape[1] for s in segs)
        q_k = torch.zeros(b, k, dtype=torch.int8, device="cuda")
        q_p = torch.zeros_like(q_k)
        got = fd.gate_lstm(segs, h, c, bundle, which, 0.1, 0.1,
                           q_out=q_k if int8 else None,
                           h_row=row[:, :_HIDDEN] if which == "gen" else None)
        again = fd.gate_lstm(segs, h, c, bundle, which, 0.1, 0.1)
        ref = fd.gate_lstm_plain(segs, h, c, bundle, which, 0.1, 0.1,
                                 q_out=q_p if int8 else None)
        assert torch.equal(q_k, q_p)
        for g, g2, r in zip(got, again, ref):
            _f32_close(g, r)
            assert torch.equal(g, g2)
    h_new = got[0]
    assert torch.equal(row[:, :_HIDDEN], h_new)

    ctx, cum_k = fd.lsa_attention(h_att, cum, memory, mtb, mask_add, bundle,
                                  ctx_row=row[:, _HIDDEN:_HIDDEN + _MEM])
    ctx_p, cum_p = fd.lsa_attention_plain(h_att, cum, memory, mtb, mask_add,
                                          bundle)
    _f32_close(ctx, ctx_p)
    _f32_close(cum_k - cum, cum_p - cum)
    assert torch.equal(row[:, _HIDDEN:_HIDDEN + _MEM], ctx)
    assert not row[:, _HIDDEN + _MEM:].any()

    frame_k, stop_k = fd.head(h_new, ctx, bundle, row=row)
    frame_p, stop_p = fd.head_plain(h_new, ctx, bundle)
    _f32_close(frame_k, frame_p)
    _f32_close(stop_k, stop_p)
    assert {k: v for k, v in fd.LAUNCHES.items() if v} == {
        "prenet_f32": 1, "gate_lstm_f32": 4, "lsa_attention_f32": 1,
        "head_f32": 1}


def _q8_operands(b, t, mem_dim, dtype, seed):
    """Random attention streams quantized by ``chunk_operands`` (the
    memory per channel, ``mt + bias`` per attention channel)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    memory = torch.randn(b, t, mem_dim, device="cuda", generator=gen)
    mt = 0.5 * torch.randn(b, t, _ATT, device="cuda", generator=gen)
    lengths = torch.randint(max(1, t // 2), t + 1, (b,), device="cuda",
                            generator=gen)
    mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
    bundle = SimpleNamespace(dtype=dtype, q_streams=True,
                             att_bias=0.1 * torch.randn(
                                 _ATT, device="cuda", generator=gen))
    mem_q, mtb_q, mask_add = fd.chunk_operands(bundle, memory.to(dtype),
                                               mt.to(dtype), mask)
    return mem_q, mtb_q, mask, mask_add, gen


@pytest.mark.parametrize("kind,dtype,t,mem_dim,b", [
    (kind, dtype, t, mem_dim, b)
    for kind in ("ls", "forward", "forward_transition_agent")
    for dtype in (torch.bfloat16, torch.float32)
    for t in (1, 7, 16, 17, 45, 120, 128, 129, 600, 1500)
    for mem_dim in (288, 292, 548) for b in (1, 7, 37, 240)] + [
    (kind, dtype, t, mem_dim, b)
    for kind in ("ls", "forward", "forward_transition_agent")
    for dtype in (torch.bfloat16, torch.float32) for t in (4096, 8192)
    for mem_dim in (292, 548) for b in (1, 8)])
def test_attention_on_int8_streams_matches_plain(kind, dtype, t, mem_dim, b,
                                                 _full_f32):
    """``lsa_attention`` and ``fwd_attention`` (both kinds) on int8 memory
    and memory-transform streams, bf16 (the staged instances: the streams'
    rings of tiles, ``att_stream_tiles``) and float32 (the query, and the
    location-sensitive band, in three TF32 passes), at the separate
    strategy's 288-, the flagship's 292- and the shared strategy's
    548-wide memory (int8 rows of 292 and 548 bytes are not multiples of
    16: at T=1 and 7 a row's tiles start off a 16-byte boundary, their
    ragged heads and tails copied by the threads), B=1, 7, 37 and 240, T
    from 1 to 1500 (T=1500 runs the rings' slots round several times), and
    long texts, T=4,096 and 8,192 at B=1 and 8 (memory 292 and 548): in
    float32 the context, weights and t_prob within F32_TOL of their
    largest (the location-sensitive weights, read back as cum' - cum, past
    T = 128 plus that subtraction's rounding, ``_cum_slack``); in bf16 the
    context within CTX_TOL, the weights within W_TOL of each row's largest,
    t_prob within ATOL; one launch of the ``_q8`` instance; a second run
    bit-identical."""
    from chip_smoke import CTX_TOL, ULP, W_TOL

    mem_q, mtb_q, mask, mask_add, gen = _q8_operands(b, t, mem_dim, dtype,
                                                     seed=t + mem_dim)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    bundle = SimpleNamespace(
        dtype=dtype, q_streams=True,
        att_kind={"ls": "ls", "forward": "fwd"}.get(kind, "fwd_trans"),
        wq=rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5).to(dtype),
        lc=rnd(_TAPS, _ATT, scale=0.1).to(dtype) if kind == "ls" else None,
        v=rnd(_ATT, scale=_ATT ** -0.5), pre_dims=(_MELS, 256, 2))
    if kind == "forward_transition_agent":
        bundle.ta_wc = rnd(mem_dim, scale=mem_dim ** -0.5).to(dtype)
        bundle.ta_wq = rnd(_HIDDEN, scale=_HIDDEN ** -0.5).to(dtype)
        bundle.ta_wx = rnd(256, scale=1 / 16).to(dtype)
        bundle.ta_b = rnd(1, scale=0.1)
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()
    fd.reset_launch_counts()
    slack = 0.0
    if kind == "ls":
        cum = ramp_alignment(mask, seed=t)
        args = (h_att, cum, mem_q, mtb_q, mask_add, bundle)
        got, again = fd.lsa_attention(*args), fd.lsa_attention(*args)
        ref = fd.lsa_attention_plain(*args)
        slack = _cum_slack(t, ref[1])
        got, again, ref = ((o[0], o[1] - cum) for o in (got, again, ref))
        name = "lsa_attention"
    else:
        prev = torch.softmax(rnd(b, t), -1)
        tp = (rnd(b, 1).sigmoid() if kind == "forward_transition_agent"
              else None)
        args = (h_att, prev, tp, mem_q, mtb_q, mask_add, x, bundle)
        got, again = fd.fwd_attention(*args), fd.fwd_attention(*args)
        ref = fd.fwd_attention_plain(*args)
        name = "fwd_attention"
    inst = fd.instance(name, dtype, True)
    assert fd.LAUNCHES[inst] == 2, fd.LAUNCHES
    assert all(g is a or torch.equal(g, a) for g, a in zip(got, again))
    if dtype == torch.float32:
        # the context, then the weights (the location-sensitive ones read
        # back as cum' - cum) and t_prob
        for i, (g, r) in enumerate(zip(got, ref)):
            if r is not None:
                _f32_close(g, r, slack=slack if i == 1 else 0.0)
        return
    # one bf16 rounding of a context product (an int8 code of up to 127
    # times its weight) that flips where a kernel's softmax sums in another
    # order than the plain one moves the context by 2^-8 of that product
    # times its scale: up to 0.0040 where a weight is large (the parent
    # kernel's too, measured at T=7, E=548, B=240).  The shapes the parent
    # kernel was held at keep CTX_TOL; the others, added with the staged
    # instances, are held to one bf16 ulp, ULP
    parent_grid = (t in (1, 17, 45, 128, 600) and mem_dim in (292, 548)
                   and b in (1, 37, 240))
    ctx_atol = CTX_TOL if parent_grid else ULP
    torch.testing.assert_close(got[0], ref[0], atol=ctx_atol, rtol=CTX_TOL)
    assert float(((got[1] - ref[1]).abs().amax(1)
                  / ref[1].amax(1)).max()) < W_TOL
    if kind == "forward_transition_agent":
        torch.testing.assert_close(got[2], ref[2], atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [120, 128])
@pytest.mark.parametrize("kind", ["forward", "forward_transition_agent"])
def test_f32_fwd_attention_matches_plain(kind, t):
    """``fwd_attention``'s float32 instance at the flagship's widths, B=240,
    also at T=120 (the kernel pads T to 128): context, weights and t_prob
    within F32_TOL of their largest, every row a floored distribution."""
    b = 240
    hp, bundle = _f32_bundle(kind, True)
    rnd, memory, mtb, mask, _ = _attention_operands(b, t, seed=t)
    memory, mtb = memory.float(), mtb.float()
    prev, tp = _fwd_state(b, t, mask, seed=t)
    tp = tp if kind != "forward" else None
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()
    mask_add = torch.where(mask, 0.0, -1e9)
    fd.reset_launch_counts()
    got = fd.fwd_attention(h_att, prev, tp, memory, mtb, mask_add, x, bundle)
    assert fd.LAUNCHES["fwd_attention_f32"] == 1
    ref = fd.fwd_attention_plain(h_att, prev, tp, memory, mtb, mask_add, x,
                                 bundle)
    for g, r in zip(got, ref):
        if r is not None:
            _f32_close(g, r)
    torch.testing.assert_close(got[1].sum(-1), torch.ones_like(got[1][:, 0]))
    assert float(got[1].min()) > 0.0


@pytest.mark.parametrize("int8", [True, False])
def test_f32_synthesis_on_card_matches_cpu(int8):
    """A small float32 ``Synthesizer`` (W8A8 or exact gates) through the
    float32 instances on the card against the plain path on the CPU, with
    cuDNN left at PyTorch's default (TF32 allowed: the port keeps its
    float32 encode in float32 itself): every spectrogram within a relative
    1e-3 (exact gates) or 1e-2 (W8A8: a row that requantizes one level
    apart grows over the steps); launches of the float32 instances only."""
    hp = _hp(int8)
    hp.compute_dtype = "float32"
    sd = init_random_weights(Tacotron(hp), 1).state_dict()
    sd["decoder.cell.stop_prediction.bias"].fill_(-10.0)
    lines = ["1|hallo welt|a|de", "2|salut|b|fr", "3|mix|c|de*0.5:ru*0.5"]
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        fd.reset_launch_counts()
        got = Synthesizer(hp, sd, device="cuda").synthesize_batch_lines(lines)
    finally:
        torch.backends.cudnn.allow_tf32 = old
    path = fd.path_kernels("ls", torch.float32)
    assert all(fd.LAUNCHES[k] > 0 for k in path), fd.LAUNCHES
    assert not any(v for k, v in fd.LAUNCHES.items() if k not in path)
    ref = Synthesizer(hp, sd, device="cpu").synthesize_batch_lines(lines)
    bound = 1e-2 if int8 else 1e-3
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = float(torch.as_tensor(g - r).norm() / torch.as_tensor(r).norm())
        assert err < bound, err


# ---------------------------------------------------------------------------
# the training slice: K2 and K3 kernels, and a train step
# ---------------------------------------------------------------------------

def _train_setup_model(b=10, t=24, frames=12, dropout=0.5, seed=0,
                       dtype=torch.bfloat16,
                       attention_type="location_sensitive"):
    """Compute-type operands and realistic decoder inputs on the card, and
    the model they come from."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    hp = _hp(False)
    hp.dropout = dropout
    hp.attention_type = attention_type
    torch.manual_seed(seed)
    model = init_random_weights(Tacotron(hp, dtype), seed).cuda()
    text = torch.randint(3, hp.total_symbols(), (b, t), device="cuda")
    lengths = torch.randint(t // 2, t + 1, (b,), device="cuda")
    with torch.no_grad():
        enc = model.encoder(model.embedding(text).to(dtype), lengths).float()
        memory, mt = model.decoder.prepare_memory(
            enc, torch.randint(0, 4, (b,), device="cuda"),
            torch.zeros(b, t, dtype=torch.long, device="cuda"))
        cfg = ftd.TrainConfig.from_hp(hp, model.decoder.memory_dim, dtype)
        ops = ftd.compute_operands(
            ftd.train_operands(model.decoder.cell, cfg), cfg)
        mtb = (mt.float()
               + model.decoder.cell.attention.energy_bias).to(dtype)
    mask_add = torch.where(torch.arange(t, device="cuda")[None] < lengths[:, None],
                           0.0, -1e9)
    shifted = torch.randn(frames, b, hp.num_mels, device="cuda").to(dtype)
    teacher = [int(x) for x in (torch.rand(frames) < 0.5)]
    return ftd, model, cfg, ops, memory, mtb, mask_add, shifted, teacher


def _train_setup(b=10, t=24, frames=12, dropout=0.5, seed=0):
    """bf16 operands and realistic decoder inputs on the card."""
    ftd, _, *rest = _train_setup_model(b, t, frames, dropout, seed)
    return (ftd, *rest)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-12))


@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_train_forward_and_backward_kernels_match_plain(regularization):
    """K2 and K3 through their kernels against their plain versions on the
    card, bf16, 12 steps: every output, residual and gradient stream, every
    accumulator and the final cotangent carry within a relative error of
    2e-2 (bf16 roundings that a one-ulp difference of a float32 sum can
    flip, compounded over the steps); the prenet dropout pattern of the
    first step bit-exact."""
    import dataclasses

    ftd, cfg, ops, memory, mtb, mask_add, shifted, teacher = _train_setup()
    if regularization == "dropout":
        cfg = dataclasses.replace(cfg, use_zoneout=False, zoneout_c=0.0)
    seeds = (1234, 98765)
    ftd.reset_launch_counts()
    st_k, carry_k = ftd.train_decode_forward(ops, cfg, memory, mtb, mask_add,
                                             shifted, teacher, seeds)
    st_p, carry_p = ftd.train_decode_forward(ops, cfg, memory, mtb, mask_add,
                                             shifted, teacher, seeds,
                                             plain=True)
    assert all(ftd.LAUNCHES[k] > 0 for k in ftd.K2_KERNELS), ftd.LAUNCHES
    got, ref = (mask_patterns(k, cfg, ops, st_p, shifted, seeds, 3)
                for k in (ftd.KERNELS, ftd.PLAIN))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for k in st_p:
        assert _rel(st_k[k], st_p[k]) < 2e-2, k
    for k in carry_p:
        assert _rel(carry_k[k], carry_p[k]) < 2e-2, k
    gen = torch.Generator(device="cuda").manual_seed(3)
    cts = [torch.randn(x.shape, device="cuda", generator=gen)
           for x in (st_p["spec"], st_p["stop"], st_p["w"])]
    g_k, s_k, c_k = ftd.train_decode_backward(ops, cfg, memory, mtb, st_p,
                                              teacher, seeds, *cts)
    g_p, s_p, c_p = ftd.train_decode_backward(ops, cfg, memory, mtb, st_p,
                                              teacher, seeds, *cts,
                                              plain=True)
    assert all(ftd.LAUNCHES[k] > 0 for k in ftd.K3_KERNELS), ftd.LAUNCHES
    for name, (got, ref) in {**{f"grad {k}": (g_k[k], g_p[k]) for k in g_p},
                             **{f"stream {k}": (s_k[k], s_p[k]) for k in s_p},
                             **{f"carry {k}": (c_k[k], c_p[k]) for k in c_p}
                             }.items():
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, ref) < 2e-2, (name, _rel(got, ref))


def test_train_step_on_card_matches_cpu():
    """One ``train_step`` from the same weights, batch, flags and seeds on
    the card and on the CPU (plain path), both bf16: every loss term and the
    gradient norm within a relative 2e-2, and every parameter moved."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.models.tacotron import (
        TacotronLossState,
    )
    from multilingual_text_to_speech_tpu_torch.training import trainer

    hp = _hp(False)
    hp.dropout = 0.0
    rng = np.random.RandomState(0)
    b, t, f = 10, 16, 16
    text = rng.randint(3, hp.total_symbols(), (b, t))
    lengths = rng.randint(t // 2, t + 1, b)
    text[np.arange(t)[None] >= lengths[:, None]] = 0
    mels = rng.randn(b, f, hp.num_mels).astype(np.float32)
    flen = np.full(b, f)
    batch = trainer.Batch(text, lengths, mels, None, flen,
                          np.zeros((b, f), np.float32),
                          rng.randint(0, 4, b), np.arange(b) % 5)
    sd = init_random_weights(Tacotron(hp, torch.bfloat16), 2).state_dict()
    results = {}
    for dev in ("cuda", "cpu"):
        model = Tacotron(hp, torch.bfloat16)
        model.load_state_dict(sd)
        for m in model.modules():
            if hasattr(m, "dropout"):
                m.dropout = 0.0
        model.to(dev)
        opt, sched = trainer.make_optimizer(model, hp)
        res = trainer.train_step(model, opt, sched, batch,
                                 TacotronLossState.init(hp),
                                 torch.Generator(), teacher=[1, 0] * (f // 2),
                                 seeds=(5, 6), device=dev)
        moved = all(not torch.equal(p.detach().cpu(), sd[n])
                    for n, p in model.named_parameters())
        results[dev] = (res, moved)
    (rk, mk), (rp, mp) = results["cuda"], results["cpu"]
    assert mk and mp
    for k in rp.losses:
        assert abs(float(rk.losses[k]) - float(rp.losses[k])) <= \
            2e-2 * abs(float(rp.losses[k])) + 1e-6, k
    assert abs(float(rk.grad_norm) - float(rp.grad_norm)) <= \
        2e-2 * float(rp.grad_norm)


@pytest.mark.parametrize("b,t", [(5, 512), (510, 16)])
def test_train_kernels_take_long_texts_and_large_batches(b, t):
    """T=512 symbols and B=510 rows (a multiple of the 5 languages):
    3 steps forward and backward through the kernels within a relative 2e-2
    of the plain versions; 513 symbols (7 tiles of 80 positions) too,
    forward, no longer refused."""
    ftd, cfg, ops, memory, mtb, mask_add, shifted, teacher = _train_setup(
        b=b, t=t, frames=3)
    seeds = (7, 8)
    args = (ops, cfg, memory, mtb, mask_add, shifted, teacher, seeds)
    st_k, _ = ftd.train_decode_forward(*args)
    st_p, _ = ftd.train_decode_forward(*args, plain=True)
    for k in ("spec", "stop", "w", "gen_in"):
        assert _rel(st_k[k], st_p[k]) < 2e-2, k
    cts = [torch.ones_like(x) for x in (st_p["spec"], st_p["stop"], st_p["w"])]
    g_k, _, _ = ftd.train_decode_backward(ops, cfg, memory, mtb, st_p,
                                          teacher, seeds, *cts)
    g_p, _, _ = ftd.train_decode_backward(ops, cfg, memory, mtb, st_p,
                                          teacher, seeds, *cts, plain=True)
    for k in g_p:
        assert _rel(g_k[k], g_p[k]) < 2e-2, k
    if t == 512:
        gen = torch.Generator(device="cuda").manual_seed(5)
        long = (torch.randn(b, 513, memory.shape[2], device="cuda",
                            generator=gen).to(memory.dtype),
                torch.randn(b, 513, cfg.att_dim, device="cuda",
                            generator=gen).to(mtb.dtype),
                torch.zeros(b, 513, device="cuda"))
        st_k, _ = ftd.train_decode_forward(ops, cfg, *long, shifted, teacher,
                                           seeds)
        st_p, _ = ftd.train_decode_forward(ops, cfg, *long, shifted, teacher,
                                           seeds, plain=True)
        for k in ("spec", "stop", "w"):
            assert _rel(st_k[k], st_p[k]) < 2e-2, k


# ---------------------------------------------------------------------------
# the tensor-core tile products at the flagship's widths
# ---------------------------------------------------------------------------

# the concat row [x | context | h] of each LSTM at the flagship's widths
_SEGMENTS = {"att": (256, 292, 1024), "gen": (1024, 292, 1024)}
_HIDDEN, _MEM, _ATT, _TAPS, _MELS = 1024, 292, 128, 31, 80


def _gate_bundle(int8, k, seed, which="att"):
    """One LSTM's random gate operands ([4H, K], column scales, bias) in the
    layouts ``extract_decoder_bundle`` makes, as the ``which`` LSTM of a
    bundle."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(4 * _HIDDEN, k, generator=gen) / k ** 0.5
    ws = None
    if int8:
        w, ws = fd._quantize_columns(w)
        ws = ws.cuda()
    w = fd._pad_k(w if int8 else w.to(torch.bfloat16)).cuda()
    b = 0.1 * torch.randn(4 * _HIDDEN, generator=gen)
    return SimpleNamespace(**{"dtype": torch.bfloat16, "quantized": int8,
                              f"{which}_w": w, f"{which}_ws": ws,
                              f"{which}_b": b.cuda()})


@pytest.mark.parametrize("which", ["att", "gen"])
@pytest.mark.parametrize("b", [1, 17, 100, 240])
@pytest.mark.parametrize("int8", [True, False])
def test_gate_lstm_matches_plain_at_flagship_widths(int8, b, which):
    """The row pass and the tensor-core gate product at H=1024 and the
    flagship's gate K (1572 for the attention LSTM, 2340 for the generator;
    32, 64 and 128 rows a block by the batch):
    the int8 activations bit-exact, h and c within atol 2e-3 (float32 sums
    in another order; the int8 sums are exact, so in W8A8 only the device's
    tanh and exp differ), eval zoneout 0.1."""
    ks = _SEGMENTS[which]
    bundle = _gate_bundle(int8, sum(ks), seed=b)
    gen = torch.Generator(device="cuda").manual_seed(b)
    segs = tuple(torch.randn(b, k, device="cuda", generator=gen) for k in ks)
    h, c = (torch.randn(b, _HIDDEN, device="cuda", generator=gen)
            for _ in range(2))
    q_k = torch.zeros(b, sum(ks), dtype=torch.int8, device="cuda")
    q_p = torch.zeros_like(q_k)
    fd.reset_launch_counts()
    got = fd.gate_lstm(segs, h, c, bundle, "att", 0.1, 0.1,
                       q_out=q_k if int8 else None)
    assert fd.LAUNCHES["gate_lstm"] == 1
    ref = fd.gate_lstm_plain(segs, h, c, bundle, "att", 0.1, 0.1,
                             q_out=q_p if int8 else None)
    assert torch.equal(q_k, q_p)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)


def _head_weights(gen):
    """The fused frame and stop head [M + 1, K_pad] (bf16, zero columns past
    K = H + Mem) and its float32 bias, at the flagship's widths."""
    k = _HIDDEN + _MEM
    w = torch.zeros(_MELS + 1, 1344, device="cuda")
    w[:, :k] = torch.randn(_MELS + 1, k, device="cuda", generator=gen) \
        / k ** 0.5
    return (w.bfloat16(),
            0.1 * torch.randn(_MELS + 1, device="cuda", generator=gen))


@pytest.mark.parametrize("b", [1, 17, 240])
@pytest.mark.parametrize("int8", [True, False])
def test_head_matches_plain_through_the_head_row(int8, b):
    """The serving head as a chunk runs it, at the flagship's widths: the
    generator's ``gate_lstm`` (W8A8 or bf16) and ``lsa_attention`` write
    bf16(h) and bf16(context) into the head row, bit for bit, its pad
    columns stay zero, and the split-K head over that row gives the frame
    and stop within ATOL of ``head_plain`` over the same h and context; a
    second head run is bit-identical to the first."""
    bundle = _gate_bundle(int8, sum(_SEGMENTS["gen"]), seed=b, which="gen")
    gen = torch.Generator(device="cuda").manual_seed(b + 2)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    bundle.wq = rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5).bfloat16()
    bundle.lc = rnd(_TAPS, _ATT, scale=0.1).bfloat16()
    bundle.v = rnd(_ATT, scale=_ATT ** -0.5)
    bundle.head_w, bundle.head_b = _head_weights(gen)
    t = 128
    memory = rnd(b, t, _MEM).bfloat16()
    mtb = rnd(b, t, _ATT, scale=0.5).bfloat16()
    lengths = torch.randint(t // 2, t + 1, (b,), device="cuda", generator=gen)
    mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
    mask_add = torch.where(mask, 0.0, -1e9)
    cum = ramp_alignment(mask, seed=b)
    segs = tuple(rnd(b, k) for k in _SEGMENTS["gen"])
    h, c, h_att = rnd(b, _HIDDEN), rnd(b, _HIDDEN), rnd(b, _HIDDEN)

    row = torch.zeros(b, 1344, dtype=torch.bfloat16, device="cuda")
    fd.reset_launch_counts()
    ctx, _ = fd.lsa_attention(h_att, cum, memory, mtb, mask_add, bundle,
                              ctx_row=row[:, _HIDDEN:_HIDDEN + _MEM])
    h_gen, _ = fd.gate_lstm(segs, h, c, bundle, "gen", 0.1, 0.1,
                            h_row=row[:, :_HIDDEN])
    assert torch.equal(row[:, :_HIDDEN], h_gen.bfloat16())
    assert torch.equal(row[:, _HIDDEN:_HIDDEN + _MEM], ctx.bfloat16())
    assert not row[:, _HIDDEN + _MEM:].any()
    got = fd.head(h_gen, ctx, bundle, row=row)
    again = fd.head(h_gen, ctx, bundle, row=row)
    assert fd.LAUNCHES["head"] == 2
    ref = fd.head_plain(h_gen, ctx, bundle)
    for g, a, r in zip(got, again, ref):
        torch.testing.assert_close(g, r, atol=ATOL, rtol=0)
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 50, 77])
def test_bwd_head_matches_plain(b, dtype):
    """The head backward's one tensor-core launch at the flagship's widths
    (M = 80 mels, H + Mem = 1316; 77 rows take a second row tile), in bf16
    (mma.sync m16n8k16) and float32 (three TF32 passes): the da_frame
    stream bit-exact, dh_gen_tot and dctx_tot within chip_smoke's bound of
    their largest value (float32 sums in another order; F32_TOL in
    float32), and a second run bit-identical to the first."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(b + 3)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    cfg = SimpleNamespace(mmel=_MELS, hidden=_HIDDEN, mem_dim=_MEM)
    head_w, _ = _head_weights(gen)
    head_w = head_w.to(dtype)
    dspec, dframe, dstop = rnd(b, _MELS), rnd(b, _MELS), rnd(b)
    dh_gen, dctx = rnd(b, _HIDDEN, scale=0.1), rnd(b, _MEM)

    def run(fn):
        out = [torch.empty(b, _MELS, dtype=dtype, device="cuda"),
               torch.empty(b, _HIDDEN, device="cuda"),
               torch.empty(b, _MEM, device="cuda")]
        fn(dspec, dstop, dframe, head_w, out[0], dh_gen, dctx, out[1],
           out[2], cfg)
        return out

    ftd.reset_launch_counts()
    got, again = run(ftd.bwd_head), run(ftd.bwd_head)
    assert ftd.LAUNCHES[ftd.instance("bwd_head", dtype)] == 2
    ref = run(ftd.PLAIN.bwd_head)
    assert torch.equal(got[0], ref[0])
    bound = train_kernel_bound("bwd_head", dtype)["f32"]
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= bound * float(r.abs().max())
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def _cell_operands(b, regularization, first, seed, dtype=torch.bfloat16):
    """A cell backward's operands at the flagship's widths (H = 1024): the
    stored activations (sigmoid/tanh ranges) and the previous cell state
    (None for the first step) in the compute type ``dtype``, a float32 dc
    carry, and a train-mode regularization of zoneout 0.1 or h dropout
    0.1."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    act = torch.sigmoid(rnd(b, 4 * _HIDDEN))
    act[:, 2 * _HIDDEN:3 * _HIDDEN] = torch.tanh(rnd(b, _HIDDEN))
    c_prev = None if first else rnd(b, _HIDDEN).to(dtype)
    cfg = ftd.TrainConfig(
        hidden=_HIDDEN, mem_dim=_MEM, prenet_dim=256, n_prenet=2,
        mmel=_MELS, att_dim=_ATT, taps=_TAPS, dropout_rate=0.5,
        zoneout_h=0.1, zoneout_c=0.1 if regularization == "zoneout" else 0.0,
        use_zoneout=regularization == "zoneout", dtype=dtype)
    reg = cfg.reg("gen", (2654435761, 40503), 5)
    return act.to(dtype), c_prev, rnd(b, _HIDDEN, scale=0.1), reg, rnd


def _check_cell_outputs(got, again, ref, regularization, f32_tol=1e-6):
    """The fused cell's outputs (dc, dg, dh_reg) against the plain cell's:
    its masks bit-exact (the units zoneout keeps old pass dh through to
    dh_reg; the units dropout drops give a zero o-gate gradient), float32
    within ``f32_tol`` and bf16 within one ulp (2^-7) of the largest
    output, and a second run bit-identical to the first."""
    dc, dg, dh_reg = got
    if regularization == "zoneout":
        assert torch.equal(dh_reg != 0, ref[2] != 0)
        assert 0 < int((ref[2] != 0).sum()) < ref[2].numel()
    else:
        o_g, o_r = dg[:, 3 * _HIDDEN:], ref[1][:, 3 * _HIDDEN:]
        assert torch.equal(o_g == 0, o_r == 0)
        assert 0 < int((o_r == 0).sum()) < o_r.numel()
    for g, r in zip(got, ref):
        bound = 2.0 ** -7 if r.dtype == torch.bfloat16 else f32_tol
        assert float((g.float() - r.float()).abs().max()) <= \
            bound * float(r.float().abs().max())
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
@pytest.mark.parametrize("b", [1, 50])
def test_bwd_head_with_the_generator_cell_matches_plain(b, regularization,
                                                        first, dtype):
    """``bwd_head`` with the generator cell's backward in its epilogue (one
    launch, counted for ``bwd_head`` and ``bwd_cell``), in bf16 and float32,
    against ``bwd_head_plain`` followed by ``bwd_cell_plain``: da_frame
    bit-exact, dctx_tot within chip_smoke's ``bwd_head`` bound (F32_TOL in
    float32), the cell's outputs as ``_check_cell_outputs`` says (every
    float32 instance's output within F32_TOL); the first step's null
    c_prev included."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    act, c_prev, dc0, reg, rnd = _cell_operands(b, regularization, first,
                                                seed=b + 31, dtype=dtype)
    cfg = SimpleNamespace(mmel=_MELS, hidden=_HIDDEN, mem_dim=_MEM)
    head_w, _ = _head_weights(torch.Generator(device="cuda").manual_seed(b))
    head_w = head_w.to(dtype)
    dspec, dframe, dstop = rnd(b, _MELS), rnd(b, _MELS), rnd(b)
    dh_gen, dctx = rnd(b, _HIDDEN, scale=0.1), rnd(b, _MEM)

    def run(fn):
        dc = dc0.clone()
        cell = ftd.CellArgs(act, c_prev, dc, torch.empty(
            b, 4 * _HIDDEN, dtype=dtype, device="cuda"),
            torch.empty(b, _HIDDEN, device="cuda"), reg)
        head = [torch.empty(b, _MELS, dtype=dtype, device="cuda"),
                torch.empty(b, _MEM, device="cuda")]
        fn(dspec, dstop, dframe, head_w, head[0], dh_gen, dctx, None,
           head[1], cfg, cell=cell)
        return head, [dc, cell.dg, cell.dh_reg]

    ftd.reset_launch_counts()
    (h_k, c_k), (h_a, c_a) = run(ftd.bwd_head), run(ftd.bwd_head)
    assert ftd.LAUNCHES[ftd.instance("bwd_head", dtype)] == \
        ftd.LAUNCHES[ftd.instance("bwd_cell", dtype)] == 2
    h_p, c_p = run(ftd.PLAIN.bwd_head)
    assert torch.equal(h_k[0], h_p[0])
    bound = train_kernel_bound("bwd_head", dtype)["f32"]
    assert float((h_k[1] - h_p[1]).abs().max()) <= \
        bound * float(h_p[1].abs().max())
    assert all(torch.equal(g, a) for g, a in zip(h_k, h_a))
    _check_cell_outputs(c_k, c_a, c_p, regularization,
                        f32_tol=1e-6 if dtype == torch.bfloat16 else bound)


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("b", [1, 50])
def test_dq_product_with_the_attention_cell_matches_plain(b, k,
                                                          regularization,
                                                          first):
    """The dq @ Wq^T ``bwd_gemm`` with the attention cell's backward in its
    epilogue: K = 64 leaves K whole (the cell runs in ``splitk_kernel``'s
    epilogue, one launch), K = 128 (the flagship's attention width) splits
    it (the cell runs in the reduction's epilogue on the final sums, a
    second launch of the same wrapper call); against the plain product
    followed by ``bwd_cell_plain``, as ``_check_cell_outputs`` says."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    act, c_prev, dc0, reg, rnd = _cell_operands(b, regularization, first,
                                                seed=b + k)
    dq = rnd(b, k, scale=0.1).bfloat16()
    wq = rnd(_HIDDEN, k, scale=k ** -0.5).bfloat16()
    add = rnd(b, _HIDDEN, scale=0.1)

    def run(fn):
        dc = dc0.clone()
        cell = ftd.CellArgs(act, c_prev, dc, torch.empty(
            b, 4 * _HIDDEN, dtype=torch.bfloat16, device="cuda"),
            torch.empty(b, _HIDDEN, device="cuda"), reg)
        fn(dq, wq, False, [(0, _HIDDEN, None, add)], cell=cell)
        return [dc, cell.dg, cell.dh_reg]

    from multilingual_text_to_speech_tpu_torch.ops import _splitk

    slices, _, _ = _splitk.split(ftd._lib(), b, _HIDDEN, k, None, dq.device)
    assert (slices > 1) == (k == 128)
    ftd.reset_launch_counts()
    got, again = run(ftd.bwd_gemm), run(ftd.bwd_gemm)
    assert ftd.LAUNCHES["bwd_gemm"] == ftd.LAUNCHES["bwd_cell"] == 2
    _check_cell_outputs(got, again, run(ftd.PLAIN.bwd_gemm), regularization)


def _f32_cell_operands(b, h, regularization, seed):
    """A float32 cell backward's operands at H units (the flagship's 1024,
    or a ragged width): the stored activations, the previous cell state, a
    dc carry, and a train-mode regularization of zoneout 0.1, h dropout 0.1
    or none."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    act = torch.sigmoid(rnd(b, 4 * h))
    act[:, 2 * h:3 * h] = torch.tanh(rnd(b, h))
    cfg = ftd.TrainConfig(
        hidden=h, mem_dim=_MEM, prenet_dim=256, n_prenet=2, mmel=_MELS,
        att_dim=_ATT, taps=_TAPS, dropout_rate=0.5,
        zoneout_h=0.0 if regularization == "none" else 0.1,
        zoneout_c=0.1 if regularization == "zoneout" else 0.0,
        use_zoneout=regularization == "zoneout", dtype=torch.float32)
    reg = cfg.reg("gen", (2654435761, 40503), 5)
    assert reg[6] == {"none": 0, "zoneout": 1, "dropout": 2}[regularization]
    return act, rnd(b, h), rnd(b, h, scale=0.1), reg, rnd


@pytest.mark.parametrize("regularization", ["zoneout", "dropout", "none"])
@pytest.mark.parametrize("h", [1024, 1001])
@pytest.mark.parametrize("b", [1, 50])
@pytest.mark.parametrize("host", ["bwd_head", "dq_split", "dq_whole"])
def test_f32_cells_match_plain(host, b, h, regularization):
    """Both float32 LSTM cell backwards as the training path runs them: the
    generator cell in ``bwd_head``'s epilogue, the attention cell in the dq
    @ Wq^T product's, with K = 128 split (the cell in the reduction, its
    operands read before the partials) and K = 64 whole (the cell in the
    product's own epilogue), at the flagship's H = 1024 and a ragged H =
    1001 (the generator cell's scalar fallback), B=1
    and 50, zoneout, dropout and no regularization: against the plain
    product or head followed by ``bwd_cell_plain``, the regularization's
    choices bit-exact, every output within the float32 instances' bound
    (F32_TOL of its largest; their products' sums in another order than
    plain move dh_tot, measured up to 7.7e-7 of the largest output), a
    second run bit-identical."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        _splitk,
        fused_train_decoder as ftd,
    )

    act, c_prev, dc0, reg, rnd = _f32_cell_operands(b, h, regularization,
                                                    seed=b + h)
    if host == "bwd_head":
        cfg = SimpleNamespace(mmel=_MELS, hidden=h, mem_dim=_MEM)
        head_w = torch.zeros(_MELS + 1, h + _MEM + 4, device="cuda")
        head_w[:, :h + _MEM] = rnd(_MELS + 1, h + _MEM,
                                   scale=(h + _MEM) ** -0.5)
        ops = (rnd(b, _MELS), rnd(b), rnd(b, _MELS), head_w,
               rnd(b, h, scale=0.1), rnd(b, _MEM))
    else:
        k = 128 if host == "dq_split" else 64
        dq, wq = rnd(b, k, scale=0.1), rnd(h, k, scale=k ** -0.5)
        add = rnd(b, h, scale=0.1)
        slices, _, _ = _splitk.split(ftd._lib(), b, h, k, None, dq.device)
        assert (slices > 1) == (host == "dq_split")

    def run(kernels):
        dc = dc0.clone()
        cell = ftd.CellArgs(act, c_prev, dc, torch.empty(b, 4 * h,
                                                         device="cuda"),
                            torch.empty(b, h, device="cuda"), reg)
        if host == "bwd_head":
            dspec, dstop, dframe, w, dh_gen, dctx = ops
            kernels.bwd_head(dspec, dstop, dframe, w,
                             torch.empty(b, _MELS, device="cuda"), dh_gen,
                             dctx, None, torch.empty(b, _MEM, device="cuda"),
                             cfg, cell=cell)
        else:
            kernels.bwd_gemm(dq, wq, False, [(0, h, None, add)], cell=cell)
        return [dc, cell.dg, cell.dh_reg]

    ftd.reset_launch_counts()
    got, again = run(ftd.KERNELS), run(ftd.KERNELS)
    assert ftd.LAUNCHES["bwd_cell_f32"] == 2, ftd.LAUNCHES
    ref = run(ftd.PLAIN)
    dc, dg, dh_reg = got
    if regularization == "zoneout":
        assert torch.equal(dh_reg != 0, ref[2] != 0)
        assert 0 < int((ref[2] != 0).sum()) < ref[2].numel()
    elif regularization == "dropout":
        o_g, o_r = dg[:, 3 * h:], ref[1][:, 3 * h:]
        assert torch.equal(o_g == 0, o_r == 0)
        assert 0 < int((o_r == 0).sum()) < o_r.numel()
    else:
        assert not dh_reg.any() and not ref[2].any()
    bound = train_kernel_bound("bwd_cell", torch.float32)["f32"]
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= bound * float(r.abs().max())
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.parametrize("phase", ["serving", "training"])
@pytest.mark.parametrize("strategy", ["shared", "separate"])
def test_kernels_match_plain_at_the_strategies_widths(strategy, phase):
    """K1 (one step and a 16-step chunk at B=240, W8A8 and bf16 gates) and
    K2/K3 (each kernel alone at B=50, 16 chained steps, ``TrainDecode``
    against autograd through the plain K2) against their plain versions at
    the published shared (548-wide memory: 1096-byte rows, which are not
    16-byte aligned, and a gate K of 1828) and separate (288) strategies'
    widths, through ``chip_smoke``'s own checks at its bounds (a failed
    check raises)."""
    import chip_smoke as cs

    hp = cs.switching(strategy, 32, 16)
    sd = cs.seeded_state_dict(hp)
    if phase == "serving":
        with torch.no_grad():
            errs = cs.phase_kernels(hp, sd)
        assert set(errs) == {"prenet", "gate_lstm", "lsa_attention", "head"}
    else:
        errs, _ = cs.phase_train_kernels(hp, sd)
        from multilingual_text_to_speech_tpu_torch.ops import (
            fused_train_decoder as ftd,
        )

        assert set(errs) == set(ftd.K2_KERNELS + ftd.K3_KERNELS)


def _bwd_gemm_operands(m, n, k, b_kn, seed, dtype=torch.bfloat16):
    """``a`` [M, K] and ``b`` ([K, N] or [N, K], contiguous: N=1572 and 2340
    give rows that are not 16-byte aligned in bf16) of ``dtype``, and three
    output segments of N: one with a separate addend, one added in place,
    one plain."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    a = rnd(m, k).to(dtype)
    b = (rnd(k, n) if b_kn else rnd(n, k)).to(dtype)
    t = n // 3
    add0, acc1 = rnd(m, t), rnd(m, t)

    def segments():
        acc = acc1.clone()
        return [(0, t, torch.empty(m, t, device="cuda"), add0),
                (t, 2 * t, acc, acc),
                (2 * t, n, torch.empty(m, n - 2 * t, device="cuda"), None)]

    return a, b, segments


def _run_bwd_gemm(fn, a, b, b_kn, segs):
    fn(a, b, b_kn, segs)
    return [out for _, _, out, _ in segs]


# the split-K products' bounds by operand type: bf16 operands, float32
# sums in another order (chip_smoke's bwd_gemm bound); float32 in three TF32
# passes (F32_TOL)
_PRODUCT_TOL = {torch.bfloat16: 2e-5, torch.float32: F32_TOL}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b_kn", [True, False])
@pytest.mark.parametrize("k", [128, 4096])
@pytest.mark.parametrize("n", [1024, 1572, 2340])
@pytest.mark.parametrize("m", [1, 50])
def test_bwd_gemm_matches_plain(m, n, k, b_kn, dtype):
    """The split-K product against its plain version ("MK" A against "KN"
    or "NK" B; float32: ``splitk_f32_kernel``, three TF32 passes): every
    output within its bound of its largest value (``_PRODUCT_TOL``), a
    second run bit-identical to the first, and only the instance of the
    operands' type launched."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    a, b, segments = _bwd_gemm_operands(m, n, k, b_kn, seed=m + n + k,
                                        dtype=dtype)
    ftd.reset_launch_counts()
    got = _run_bwd_gemm(ftd.bwd_gemm, a, b, b_kn, segments())
    again = _run_bwd_gemm(ftd.bwd_gemm, a, b, b_kn, segments())
    assert {name: v for name, v in ftd.LAUNCHES.items() if v} == {
        ftd.instance("bwd_gemm", dtype): 2}
    ref = _run_bwd_gemm(ftd.PLAIN.bwd_gemm, a, b, b_kn, segments())
    for g, r, g2 in zip(got, ref, again):
        assert float((g - r).abs().max()) <= \
            _PRODUCT_TOL[dtype] * float(r.abs().max())
        assert torch.equal(g, g2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_gemm_matches_plain_at_the_dwq_shape(dtype):
    """dWq = gen_in[:, :H]^T @ dq over all F*B = 25,600 rows of the flagship
    pass: ``a`` a [K, M] view with the generator row's stride ("KM"), ``b``
    [K, A] ("KN"); within its bound of the largest value
    (``_PRODUCT_TOL``), and bit-identical twice."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, hidden, att, ld = 512 * 50, 1024, 128, 2368
    a = torch.randn(rows, ld, device="cuda", generator=gen).to(dtype)
    a = a[:, :hidden]
    b = torch.randn(rows, att, device="cuda", generator=gen).to(dtype)
    outs = []
    for fn in (ftd.bwd_gemm, ftd.bwd_gemm, ftd.PLAIN.bwd_gemm):
        out = torch.empty(hidden, att, device="cuda")
        fn(a, b, True, [(0, att, out, None)], True)
        outs.append(out)
    got, again, ref = outs
    assert float((got - ref).abs().max()) <= \
        _PRODUCT_TOL[dtype] * float(ref.abs().max())
    assert torch.equal(got, again)


def _train_gate_case(b, mode, dtype):
    """The training gate product at H=1024 and both gate K's (bf16: zero
    padded to a multiple of 64, as the model's weights; float32: K = 1572
    and 2340 as they are, which end inside a 64-deep stage) against its
    plain version, zoneout 0.5 in train mode (the zoneout choices
    bit-exact) and its eval interpolation (``LstmEpi`` mode 3, no
    activation or c stream written): float32 outputs within 1e-5 of their
    largest value, bf16 ones within one ulp (chip_smoke's bounds); a second
    kernel run bit-identical to the first; only the instance of ``dtype``
    launched."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(b)
    reg = (11, 12, 5, 6, 2 ** 31, 2 ** 31, 1 if mode == "train" else 3,
           1.0, 0.5, 0.5)
    for which, ks in _SEGMENTS.items():
        k = sum(ks)
        kp = -(-k // 64) * 64 if dtype == torch.bfloat16 else k
        row = torch.zeros(b, kp, device="cuda")
        row[:, :k] = torch.randn(b, k, device="cuda", generator=gen)
        row = row.to(dtype)
        w = (torch.randn(4 * _HIDDEN, kp, device="cuda", generator=gen)
             / kp ** 0.5).to(dtype)
        bias = 0.1 * torch.randn(4 * _HIDDEN, device="cuda",
                                 generator=gen)
        h0, c0 = (torch.randn(b, _HIDDEN, device="cuda", generator=gen)
                  for _ in range(2))
        outs = []
        ftd.reset_launch_counts()
        for fn in (ftd.train_gate_lstm, ftd.train_gate_lstm,
                   ftd.PLAIN.train_gate_lstm):
            h, c = h0.clone(), c0.clone()
            o = [torch.empty(b, 4 * _HIDDEN, dtype=dtype,
                             device="cuda")] + [
                torch.empty(b, _HIDDEN, dtype=dtype, device="cuda")
                for _ in range(3)]
            if mode == "eval":
                o[0] = o[1] = None
            fn(row, w, bias, reg, h, c, *o)
            outs.append([x for x in (h, c, *o) if x is not None])
        assert {n: v for n, v in ftd.LAUNCHES.items() if v} == {
            ftd.instance("train_gate_lstm", dtype): 2}, which
        got, again, ref = outs
        for g, g2, r in zip(got, again, ref):
            bound = 1e-5 if r.dtype == torch.float32 else 8e-3
            assert float((g.float() - r.float()).abs().max()) <= \
                bound * float(r.float().abs().max()), which
            assert torch.equal(g, g2), which
        if mode == "train":
            kept_k = (got[0] == h0)
            kept_p = (ref[0] == h0)
            assert torch.equal(kept_k, kept_p) and bool(kept_p.any()), \
                which


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("b", [1, 50, 67, 100, 240])
def test_train_gate_lstm_matches_plain_at_flagship_widths(b, mode, dtype):
    """The training decoder's gate product in the shared gate routine
    (``csrc/tile.cuh``; 32, 64 or 128 rows a block by the batch, and in
    float32 clusters of two CTAs) at the flagship's widths
    (``_train_gate_case``)."""
    _train_gate_case(b, mode, dtype)


@pytest.mark.parametrize("b", [17, 32, 33, 128, 129])
def test_f32_gate_routine_at_every_geometry(b):
    """The float32 gate routine (three TF32 passes, clusters of two CTAs)
    at each rows a block its launcher picks, on both sides of where the
    pick changes (32 rows up to 32, 64 up to 128, 128 above: full and
    partial row tiles), against its plain version (``_train_gate_case`` in
    train mode)."""
    _train_gate_case(b, "train", torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 50, 240])
def test_train_query_and_head_split_k_match_plain(b, dtype):
    """The attention query (K = H = 1024, 16 slices at B=50) and the
    training and serving heads (K = 1344: 21 slices, and 14 for the serving
    head at B=240) through ``splitk_kernel`` and its ordered reduction, at
    the flagship's widths: q within one bf16 ulp, the frame, stop and frame
    carry within 4e-6 of their largest value (chip_smoke's bound for the
    training head); in float32 (``splitk_f32_kernel``, three TF32 passes)
    every output within F32_TOL; a pass-wide scratch and a call's own give
    bit-identical results, and a scratch too small for the split raises."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        _splitk,
        fused_train_decoder as ftd,
    )

    gen = torch.Generator(device="cuda").manual_seed(b + 1)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    h = rnd(b, 2368).to(dtype)[:, :_HIDDEN]      # a generator-row view
    wq = rnd(_HIDDEN, 128, scale=_HIDDEN ** -0.5).to(dtype)
    row = rnd(b, 1344).to(dtype)
    head_w = rnd(81, 1344, scale=1344 ** -0.5).to(dtype)
    head_b = rnd(81, scale=0.1)
    scratch = _splitk.splitk_scratch(
        ftd._lib(), [(b, 128, _HIDDEN), (b, 81, 1344)], h)
    serving = SimpleNamespace(dtype=dtype, head_w=head_w, head_b=head_b)
    f32 = dtype == torch.float32

    def query(fn, **kw):
        out = torch.empty(b, 128, device="cuda")
        fn(h, wq, out, **kw)
        return [out]

    def head(fn, **kw):
        out = [torch.empty(b, 80, device="cuda"),
               torch.empty(b, device="cuda"),
               torch.empty(b, 80, device="cuda")]
        fn(row, head_w, head_b, *out, **kw)
        return out

    # the serving head row: [h_gen | ctx], zero past K = H + Mem
    srow = row.clone()
    srow[:, _HIDDEN + _MEM:] = 0

    def serving_head(fn, **kw):
        h_gen, ctx = srow[:, :_HIDDEN], srow[:, _HIDDEN:_HIDDEN + _MEM]
        if fn is fd.head:
            kw["row"] = srow
        return list(fn(h_gen, ctx, serving, **kw))

    for run, kernel, plain, bound in (
            (query, ftd.train_query, ftd.PLAIN.train_query,
             F32_TOL if f32 else 1e-2),
            (head, ftd.train_head, ftd.PLAIN.train_head,
             F32_TOL if f32 else 4e-6),
            (serving_head, fd.head, fd.head_plain,
             F32_TOL if f32 else 4e-6)):
        got = run(kernel, scratch=scratch)
        own = run(kernel)
        ref = run(plain)
        assert len(got) == len(ref)
        for g, o, r in zip(got, own, ref):
            assert float((g - r).abs().max()) <= bound * float(r.abs().max())
            assert torch.equal(g, o)
    if b == 50:
        with pytest.raises(ValueError, match="split-K scratch"):
            query(ftd.train_query, scratch=torch.empty(16, device="cuda"))


# ---------------------------------------------------------------------------
# the attention kernels on the band routine, at the flagship's widths
# ---------------------------------------------------------------------------

def _attention_operands(b, t, seed, mem_dim=_MEM):
    """Random bf16 memory [B, T, Mem] and memory transform [B, T, A], the
    additive mask of random lengths, and a cumulative attention of 1 up to
    a point part way through each text."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    memory = rnd(b, t, mem_dim).bfloat16()
    mtb = rnd(b, t, _ATT, scale=0.5).bfloat16()
    lengths = torch.randint(max(1, t // 2), t + 1, (b,), device="cuda",
                            generator=gen)
    mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
    return rnd, memory, mtb, mask, ramp_alignment(mask, seed=seed)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 17, 45, 128, 200, 512, 600])
@pytest.mark.parametrize("b", [1, 37, 50, 240])
@pytest.mark.parametrize("int8", [True, False])
def test_lsa_attention_matches_plain_at_flagship_widths(int8, b, t, dtype,
                                                        _full_f32):
    """``lsa_attention`` (clusters of 8 rows sharing the query product, the
    location conv as a band product) at H=1024, A=128, Mem=292, 31 taps, in
    a W8A8 and a bf16 bundle, and in float32 (the query and the band
    product in three TF32 passes): B=37 leaves a cluster part empty, T=1,
    17, 45, 200 and 600 are not multiples of 16, and at T=45 the rows of
    memory are not all 16-byte aligned (the context's scalar loads); bf16:
    the context within atol and rtol 2e-3 of ``lsa_attention_plain``, the
    step's attention weights within 1e-2 of each row's largest; float32:
    the context and the weights within F32_TOL of their largest (past T =
    128 plus the rounding of the weights read back as cum' - cum,
    ``_cum_slack``); the head row's context bit-exact CT(context), one
    launch, and a second run bit-identical to the first."""
    f32 = dtype == torch.float32
    bundle = _gate_bundle(int8, sum(_SEGMENTS["att"]), seed=b)
    bundle.dtype = dtype
    rnd, memory, mtb, mask, cum = _attention_operands(b, t, seed=b + t)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    bundle.wq = rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5).to(dtype)
    bundle.lc = rnd(_TAPS, _ATT, scale=0.1).to(dtype)
    bundle.v = rnd(_ATT, scale=_ATT ** -0.5)
    h_att = rnd(b, _HIDDEN)
    mask_add = torch.where(mask, 0.0, -1e9)
    row = torch.zeros(b, 1344, dtype=dtype, device="cuda")
    fd.reset_launch_counts()
    ctx_k, cum_k = fd.lsa_attention(h_att, cum, memory, mtb, mask_add, bundle,
                                    ctx_row=row[:, _HIDDEN:_HIDDEN + _MEM])
    assert fd.LAUNCHES[fd.instance("lsa_attention", dtype)] == 1
    again = fd.lsa_attention(h_att, cum, memory, mtb, mask_add, bundle)
    ctx_p, cum_p = fd.lsa_attention_plain(h_att, cum, memory, mtb, mask_add,
                                          bundle)
    w_k, w_p = cum_k - cum, cum_p - cum
    if f32:
        _f32_close(ctx_k, ctx_p)
        _f32_close(w_k, w_p, slack=_cum_slack(t, cum_p))
    else:
        torch.testing.assert_close(ctx_k, ctx_p, atol=2e-3, rtol=2e-3)
        assert float(((w_k - w_p).abs().amax(1) / w_p.amax(1)).max()) < 1e-2
    assert torch.equal(row[:, _HIDDEN:_HIDDEN + _MEM], ctx_k.to(dtype))
    assert not row[:, :_HIDDEN].any() and not row[:, _HIDDEN + _MEM:].any()
    assert torch.equal(again[0], ctx_k) and torch.equal(again[1], cum_k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [45, 128, 200, 512])
@pytest.mark.parametrize("b", [1, 50, 96])
def test_att_bwd_matches_plain_at_flagship_widths(b, t, dtype, _full_f32):
    """``att_bwd`` (a cluster of CTAs over tiles of each row's positions:
    3 of 16 at T=45, whose memory rows are not all 16-byte aligned, 8 of
    16 at T=128, 7 of 32 at T=200 with a part-filled last tile, 8 of 64 at
    T=512) at A=128, Mem=292, 31 taps, in bf16 and float32 (the band
    products in three TF32 passes), three chained calls so that the dmt,
    dlc and dv "+=" and the dcum carry are covered: every float32 output
    within chip_smoke's bound of its largest value (every output of the
    float32 instance within F32_TOL, against the plain version's conv in
    full float32), the bf16 dq and dctx streams within one ulp; two chains
    from the same start bit-identical."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    rnd, memory, mtb, mask, cum = _attention_operands(b, t, seed=3 * b + t)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    lc = rnd(_TAPS, _ATT, scale=0.1).to(dtype)
    v = rnd(_ATT, scale=_ATT ** -0.5)
    steps = []
    for _ in range(3):
        e = torch.where(mask, rnd(b, t), torch.full_like(cum, -1e9))
        steps.append((rnd(b, _ATT).to(dtype).float(),           # q
                      (cum + 0.1 * rnd(b, t).abs()).to(dtype),  # cum_s
                      torch.softmax(e, -1),                     # w_s
                      rnd(b, _MEM), rnd(b, t, scale=0.1)))      # dctx, dw
    dcum0 = rnd(b, t, scale=0.1)

    def chain(fn):
        acc = [torch.zeros(b, t, _ATT, device="cuda"),
               torch.zeros(b, _TAPS, _ATT, device="cuda"),
               torch.zeros(b, _ATT, device="cuda"), dcum0.clone()]
        outs = []
        for q, cum_s, w_s, dctx, dw in steps:
            o = [torch.empty(b, _ATT, dtype=dtype, device="cuda"),
                 torch.empty(b, _MEM, dtype=dtype, device="cuda")]
            fn(q, cum_s, w_s, memory, mtb, lc, v, dctx, dw, acc[3], acc[0],
               acc[1], acc[2], *o)
            outs += o
        return acc + outs

    ftd.reset_launch_counts()
    got = chain(ftd.att_bwd)
    assert ftd.LAUNCHES[ftd.instance("att_bwd", dtype)] == 3
    again = chain(ftd.att_bwd)
    ref = chain(ftd.PLAIN.att_bwd)
    bound = train_kernel_bound("att_bwd", dtype)
    for g, a, r in zip(got, again, ref):
        kind = "bf16" if r.dtype == torch.bfloat16 else "f32"
        err = float((g.float() - r.float()).abs().max())
        assert err <= bound[kind] * float(r.float().abs().max()), kind
        assert torch.equal(g, a)


@pytest.fixture
def _full_f32():
    """The plain versions' float32 convolutions in full float32, as
    chip_smoke runs them (cuDNN takes TF32 by default)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("t", [17, 128, 512])
@pytest.mark.parametrize("b", [1, 50, 67])
def test_train_attention_matches_plain_at_flagship_widths(b, t, _full_f32):
    """``train_attention`` (a cluster of CTAs over tiles of each row's
    positions: 2 of 16 at T=17, whose memory rows are not all 16-byte
    aligned, 8 of 16 at T=128, 8 of 64 at T=512) at A=128, Mem=292, 31
    taps, on three sets of random inputs, each with the cum stream and
    without it (the eval forward), against the plain version on the same
    inputs, at the bounds of ``lsa_attention``'s test of the same function:
    each row's weights (and the cum increment) within W_TOL of the row's
    largest weight, the context within atol and rtol CTX_TOL; the bf16
    concat rows equal to the kernel's own context in bf16, the cum stream
    exact; two runs bit-identical.  (On random cum the plain version's
    float32 conv1d rounds a few bf16(loc) values to the other neighbour
    than the kernel's sums: the weights then differ by up to 7e-5 of the
    largest at B=50, T=512, the same with the location conv in the plain
    version's tap order, tools/torch_kernel_variants.py train_attention_taps;
    chip_smoke's check holds the kernel to 1e-6 on the training path's
    inputs.)"""
    from chip_smoke import CTX_TOL, W_TOL
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    rnd, memory, mtb, mask, cum0 = _attention_operands(b, t, seed=5 * b + t)
    mask_add = torch.where(mask, 0.0, -1e9)
    lc = rnd(_TAPS, _ATT, scale=0.1).bfloat16()
    v = rnd(_ATT, scale=_ATT ** -0.5)
    ftd.reset_launch_counts()
    for step in range(3):
        q = rnd(b, _ATT).bfloat16().float()
        cum = cum0 + 0.3 * step * rnd(b, t).abs() * mask

        def run(fn, streams=True):
            cc, ctx = cum.clone(), torch.empty(b, _MEM, device="cuda")
            w = torch.empty(b, t, device="cuda")
            cum_s = (torch.empty(b, t, dtype=torch.bfloat16, device="cuda")
                     if streams else None)
            dsts = [torch.empty(b, _MEM, dtype=torch.bfloat16, device="cuda")
                    for _ in range(3)]
            fn(q, cc, memory, mtb, mask_add, lc, v, w, cum_s, ctx, dsts)
            return [x for x in (cc, w, ctx, cum_s, *dsts) if x is not None]

        for streams in (True, False):
            got, again = (run(ftd.train_attention, streams) for _ in range(2))
            ref = run(ftd.PLAIN.train_attention, streams)
            (cc_k, w_k, ctx_k, *rows_k), (cc_p, w_p, ctx_p, *rows_p) = got, ref
            w_max = w_p.amax(1)
            for g in (w_k, cc_k - cum):
                assert float(((g - w_p).abs().amax(1) / w_max).max()) < W_TOL
            torch.testing.assert_close(ctx_k, ctx_p, atol=CTX_TOL,
                                       rtol=CTX_TOL)
            for row in rows_k[-3:]:
                assert torch.equal(row, ctx_k.bfloat16())
            if streams:
                assert torch.equal(rows_k[0], rows_p[0])
            assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert ftd.LAUNCHES["train_attention"] == 12


@pytest.mark.parametrize("teacher", [0, 1])
@pytest.mark.parametrize("n_prenet", [1, 2, 3])
@pytest.mark.parametrize("b", [1, 50, 67])
def test_bwd_prenet_matches_plain_at_flagship_widths(b, n_prenet, teacher):
    """``bwd_prenet`` (one launch: a cluster of 8 CTAs for each 64 rows,
    each a column slice of every layer, the products on mma.sync) at P=256
    and M=80 for prenet depths 1 to 3 and both teacher flags: the da
    streams within one bf16 ulp of their largest value, the frame
    cotangent within chip_smoke's float32 bound of the plain product of the
    kernel's own first-layer da (``chip_smoke.bwd_prenet_reference``); two
    runs bit-identical."""
    from chip_smoke import bwd_prenet_reference
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    p, m = 256, _MELS
    cfg = ftd.TrainConfig(hidden=_HIDDEN, mem_dim=_MEM, prenet_dim=p,
                          n_prenet=n_prenet, mmel=m, att_dim=_ATT,
                          taps=_TAPS, dropout_rate=0.5, zoneout_h=0.1,
                          zoneout_c=0.1, use_zoneout=True,
                          dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(b + 10 * n_prenet)
    n_w = m * p + (n_prenet - 1) * p * p
    ops = {"pre_w": (torch.randn(n_w, device="cuda", generator=gen)
                     / 16.0).bfloat16(),
           "pre_b": torch.zeros(n_prenet * p, device="cuda")}
    x = torch.randn(n_prenet, b, p, device="cuda", generator=gen)
    keep = torch.rand(n_prenet, b, p, device="cuda", generator=gen) < 0.5
    pre = (x.clamp(min=0.0) * keep).bfloat16()
    dx = 0.1 * torch.randn(b, p, device="cuda", generator=gen)

    def run(fn):
        o = [torch.empty(n_prenet, b, p, dtype=torch.bfloat16, device="cuda"),
             torch.empty(b, m, dtype=torch.bfloat16, device="cuda"),
             torch.empty(b, m, device="cuda")]
        fn(dx, pre, ops, cfg, teacher, *o)
        return o

    ftd.reset_launch_counts()
    got = run(ftd.bwd_prenet)
    assert ftd.LAUNCHES["bwd_prenet"] == 1
    again = run(ftd.bwd_prenet)
    ref = bwd_prenet_reference(ftd, ops, cfg, teacher, got,
                               run(ftd.PLAIN.bwd_prenet))
    bound = TRAIN_KERNEL_TOL["bwd_prenet"]
    for g, a, r in zip(got, again, ref):
        kind = "bf16" if r.dtype == torch.bfloat16 else "f32"
        err = float((g.float() - r.float()).abs().max())
        assert err <= bound[kind] * (float(r.float().abs().max()) + 1e-30), \
            kind
        assert torch.equal(g, a)


@pytest.mark.parametrize("n_prenet", [1, 2, 6])
@pytest.mark.parametrize("b", [1, 50])
def test_f32_bwd_prenet_matches_plain_up_to_its_deepest_prenet(b, n_prenet):
    """``bwd_prenet``'s float32 instance (its products in three TF32 passes,
    K split over the warps, the warps' partials summed in K order) at P=256
    and M=80, a teacher step and a free-running one, up to six layers (the
    deepest whose weight slices fit a CTA's shared memory in float32):
    the masks replayed bit-exact, every output within F32_TOL of its
    largest value, two runs bit-identical."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    p, m = 256, _MELS
    cfg = ftd.TrainConfig(hidden=_HIDDEN, mem_dim=_MEM, prenet_dim=p,
                          n_prenet=n_prenet, mmel=m, att_dim=_ATT,
                          taps=_TAPS, dropout_rate=0.5, zoneout_h=0.1,
                          zoneout_c=0.1, use_zoneout=True,
                          dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(b + 10 * n_prenet)
    n_w = m * p + (n_prenet - 1) * p * p
    ops = {"pre_w": torch.randn(n_w, device="cuda", generator=gen) / 16.0,
           "pre_b": torch.zeros(n_prenet * p, device="cuda")}
    x = torch.randn(n_prenet, b, p, device="cuda", generator=gen)
    keep = torch.rand(n_prenet, b, p, device="cuda", generator=gen) < 0.5
    pre = x.clamp(min=0.0) * keep
    dx = 0.1 * torch.randn(b, p, device="cuda", generator=gen)
    for teacher in (0, 1):
        def run(fn):
            o = [torch.empty(n_prenet, b, p, device="cuda"),
                 torch.empty(b, m, device="cuda"),
                 torch.empty(b, m, device="cuda")]
            fn(dx, pre, ops, cfg, teacher, *o)
            return o

        ftd.reset_launch_counts()
        got = run(ftd.bwd_prenet)
        assert ftd.LAUNCHES["bwd_prenet_f32"] == 1
        again = run(ftd.bwd_prenet)
        ref = run(ftd.PLAIN.bwd_prenet)
        # the masks replayed bit-exact: the da streams' zeros
        assert torch.equal(got[0] == 0, ref[0] == 0)
        for g, a, r in zip(got, again, ref):
            _f32_close(g, r)
            assert torch.equal(g, a)


def _prenet_operands(n_prenet, b, seed):
    """Random bf16 prenet weights and float32 biases at the flagship's
    widths (M=80, P=256), as K1's bundle and as the training decoder's
    operands, and a float32 frame and a bf16 shifted target of b rows."""
    import dataclasses

    p, m = 256, _MELS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_w = m * p + (n_prenet - 1) * p * p
    w = (torch.randn(n_w, device="cuda", generator=gen) / 16.0).bfloat16()
    bias = 0.1 * torch.randn(n_prenet * p, device="cuda", generator=gen)
    fields = {f.name: None for f in dataclasses.fields(fd.DecoderBundle)}
    fields.update(dtype=torch.bfloat16, quantized=False, pre_w=w,
                  pre_b=bias, pre_dims=(m, p, n_prenet))
    frame = torch.randn(b, m, device="cuda", generator=gen)
    shifted = torch.randn(b, m, device="cuda", generator=gen).bfloat16()
    return fd.DecoderBundle(**fields), {"pre_w": w, "pre_b": bias}, frame, \
        shifted


@pytest.mark.parametrize("kernel", ["prenet", "train_prenet"])
@pytest.mark.parametrize("n_prenet", [1, 2, 3])
@pytest.mark.parametrize("b", [1, 50, 240])
def test_prenet_matches_plain_at_flagship_widths(b, n_prenet, kernel):
    """K1 ``prenet`` and K2 ``train_prenet`` (one launch each: a cluster of
    8 CTAs for each 16 rows, each a column slice of every layer, the layers
    on mma.sync) at P=256 and M=80 for prenet depths 1 to 3, dropout 0.5,
    against their plain versions on the same inputs.
    K1, with ``keep_out`` and without: the keep masks bit-exact at steps 0
    and 3; the float32 output within 1e-6 of its largest value of the plain
    last layer over the kernel's own bf16 input to it (the kernel run on
    the first n - 1 layers at step 0, where their salts are the same),
    since a float32 sum order that differs can flip one bf16 rounding of a
    lower layer's output.
    K2, at both teacher flags, with the raw and per-layer streams and
    without them (the eval forward): the raw frame exact; each layer's bf16
    output within one ulp (ULP of the largest value), the concat row equal
    to the last layer; the masks (zero weights, positive biases: every
    zero a dropped unit) bit-exact.
    Two runs bit-identical; one launch a call."""
    import dataclasses

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    bundle, ops, frame, shifted = _prenet_operands(n_prenet, b,
                                                   b + 10 * n_prenet)
    p, m = 256, _MELS
    seeds = (123456789, 987654321)
    if kernel == "prenet":
        def run(fn, step, keep=True, bnd=bundle):
            k = (torch.zeros(bnd.pre_dims[2], b, p, dtype=torch.uint8,
                             device="cuda") if keep else None)
            return fn(frame, bnd, 0.5, seeds, step, keep_out=k), k

        for step in (0, 3):
            fd.reset_launch_counts()
            got, keep_k = run(fd.prenet, step)
            assert fd.LAUNCHES["prenet"] == 1
            again, keep_a = run(fd.prenet, step)
            alone, _ = run(fd.prenet, step, keep=False)
            ref, keep_p = run(fd.prenet_plain, step)
            assert torch.equal(keep_k, keep_p)
            assert bool((keep_p == 0).any() and (keep_p == 1).any())
            assert torch.equal(got, again) and torch.equal(keep_k, keep_a)
            assert torch.equal(got, alone)
            assert fd.LAUNCHES["prenet"] == 3
        # step 0: the last layer of the plain version over the kernel's own
        # bf16 input to it
        x_in = frame
        if n_prenet > 1:
            w_lo = bundle.prenet_layers()[:-1]
            lower = dataclasses.replace(
                bundle, pre_w=torch.cat([w.reshape(-1) for w, _ in w_lo]),
                pre_b=torch.cat([bb for _, bb in w_lo]),
                pre_dims=(m, p, n_prenet - 1))
            x_in, _ = run(fd.prenet, 0, keep=False, bnd=lower)
        w_top, b_top = bundle.prenet_layers()[-1]
        want = fd.hashed_dropout(torch.relu(fd._mm(x_in, w_top) + b_top),
                                 0.5, seeds, n_prenet)
        got, _ = run(fd.prenet, 0)
        err = float((got - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), err
        return

    cfg = ftd.TrainConfig(hidden=_HIDDEN, mem_dim=_MEM, prenet_dim=p,
                          n_prenet=n_prenet, mmel=m, att_dim=_ATT,
                          taps=_TAPS, dropout_rate=0.5, zoneout_h=0.1,
                          zoneout_c=0.1, use_zoneout=True,
                          dtype=torch.bfloat16)
    masks = {"pre_w": torch.zeros_like(ops["pre_w"]),
             "pre_b": ops["pre_b"].abs() + 1.0}

    def run(fn, teacher, streams, o=ops):
        row = torch.zeros(b, p + 96, dtype=torch.bfloat16, device="cuda")
        raw = (torch.empty(b, m, dtype=torch.bfloat16, device="cuda")
               if streams else None)
        pre = (torch.empty(n_prenet, b, p, dtype=torch.bfloat16,
                           device="cuda") if streams else None)
        fn(shifted, frame, teacher, o, cfg, seeds, 7, raw, pre, row[:, :p])
        return [x for x in (raw, pre, row) if x is not None]

    ulp = TRAIN_KERNEL_TOL["train_prenet"]["bf16"]
    for teacher in (0, 1):
        for streams in (True, False):
            ftd.reset_launch_counts()
            got = run(ftd.train_prenet, teacher, streams)
            assert ftd.LAUNCHES["train_prenet"] == 1
            again = run(ftd.train_prenet, teacher, streams)
            ref = run(ftd.PLAIN.train_prenet, teacher, streams)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            row = got[-1]
            assert not row[:, p:].any()
            if streams:
                raw, pre = got[0], got[1]
                assert torch.equal(raw, (shifted if teacher
                                         else frame.bfloat16()))
                assert torch.equal(row[:, :p], pre[-1])
                outs, refs = list(pre), list(ref[1])
            else:
                outs, refs = [row[:, :p]], [ref[-1][:, :p]]
            for g, r in zip(outs, refs):
                err = float((g.float() - r.float()).abs().max())
                assert err <= ulp * float(r.float().abs().max()), err
            got_m = run(ftd.train_prenet, teacher, streams, masks)
            ref_m = run(ftd.PLAIN.train_prenet, teacher, streams, masks)
            for g, r in zip(got_m[1:] if streams else got_m,
                            ref_m[1:] if streams else ref_m):
                assert torch.equal(g == 0, r == 0)
            assert bool((got_m[-1][:, :p] == 0).any())


@pytest.mark.parametrize("kernel", ["prenet", "train_prenet"])
@pytest.mark.parametrize("n_prenet", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("b", [1, 50, 240])
def test_f32_prenet_matches_plain_up_to_its_deepest_prenet(b, n_prenet,
                                                           kernel):
    """The float32 instances of K1 ``prenet`` and K2 ``train_prenet`` (the
    layers' products on the tensor cores in three TF32 passes, K split
    over the warps, the warps' partials summed in K order) at P=256 and
    M=80, dropout 0.5, up to six layers (the deepest whose float32 weight
    slices fit a CTA's shared memory, as before the tensor cores), against
    their plain versions on the same inputs: K1 at steps 0 and 3 with
    ``keep_out``, K2 at both teacher flags with its raw and per-layer
    streams; the masks bit-exact (K1's keep masks; K2's zeros with zero
    weights and positive biases, where every zero is a dropped unit), the
    raw frame exact, every float32 output within F32_TOL of its largest
    value, two runs bit-identical, one launch a call."""
    import dataclasses

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    bundle, ops, frame, shifted = _prenet_operands(n_prenet, b,
                                                   b + 10 * n_prenet)
    ops = {"pre_w": ops["pre_w"].float(), "pre_b": ops["pre_b"]}
    bundle = dataclasses.replace(bundle, dtype=torch.float32,
                                 pre_w=ops["pre_w"])
    shifted = shifted.float()
    p, m = 256, _MELS
    seeds = (123456789, 987654321)
    if kernel == "prenet":
        def run(fn, step):
            k = torch.zeros(n_prenet, b, p, dtype=torch.uint8, device="cuda")
            return fn(frame, bundle, 0.5, seeds, step, keep_out=k), k

        for step in (0, 3):
            fd.reset_launch_counts()
            got, keep_k = run(fd.prenet, step)
            assert fd.LAUNCHES["prenet_f32"] == 1
            again, keep_a = run(fd.prenet, step)
            ref, keep_p = run(fd.prenet_plain, step)
            assert torch.equal(keep_k, keep_p) and torch.equal(keep_k, keep_a)
            assert torch.equal(got, again)
            _f32_close(got, ref)
        return

    cfg = ftd.TrainConfig(hidden=_HIDDEN, mem_dim=_MEM, prenet_dim=p,
                          n_prenet=n_prenet, mmel=m, att_dim=_ATT,
                          taps=_TAPS, dropout_rate=0.5, zoneout_h=0.1,
                          zoneout_c=0.1, use_zoneout=True,
                          dtype=torch.float32)
    masks = {"pre_w": torch.zeros_like(ops["pre_w"]),
             "pre_b": ops["pre_b"].abs() + 1.0}

    def run(fn, teacher, o=ops):
        row = torch.zeros(b, p + 96, device="cuda")
        raw = torch.empty(b, m, device="cuda")
        pre = torch.empty(n_prenet, b, p, device="cuda")
        fn(shifted, frame, teacher, o, cfg, seeds, 7, raw, pre, row[:, :p])
        return [raw, pre, row]

    for teacher in (0, 1):
        ftd.reset_launch_counts()
        got = run(ftd.train_prenet, teacher)
        assert ftd.LAUNCHES["train_prenet_f32"] == 1
        again = run(ftd.train_prenet, teacher)
        ref = run(ftd.PLAIN.train_prenet, teacher)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        raw, pre, row = got
        assert torch.equal(raw, shifted if teacher else frame)
        assert torch.equal(row[:, :p], pre[-1]) and not row[:, p:].any()
        for g, r in zip(pre, ref[1]):
            _f32_close(g, r)
        got_m = run(ftd.train_prenet, teacher, masks)
        ref_m = run(ftd.PLAIN.train_prenet, teacher, masks)
        assert torch.equal(got_m[1] == 0, ref_m[1] == 0)
        assert bool((got_m[1] == 0).any())


@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_eval_forward_kernels_match_plain(regularization):
    """The eval forward (``TrainConfig.train`` False) through the K2
    kernels against its plain version on the card, bf16, 12 steps: spec,
    stop and weights within a relative 2e-2, as the train-mode forward; no
    residual stream, and no K3 kernel launched."""
    import dataclasses

    ftd, cfg, ops, memory, mtb, mask_add, shifted, teacher = _train_setup()
    cfg = dataclasses.replace(cfg, train=False)
    if regularization == "dropout":
        cfg = dataclasses.replace(cfg, use_zoneout=False, zoneout_c=0.0)
    args = (ops, cfg, memory, mtb, mask_add, shifted, teacher, (5, 6))
    ftd.reset_launch_counts()
    st_k, carry_k = ftd.train_decode_forward(*args)
    st_p, carry_p = ftd.train_decode_forward(*args, plain=True)
    assert all(ftd.LAUNCHES[k] > 0 for k in ftd.K2_KERNELS), ftd.LAUNCHES
    assert not any(ftd.LAUNCHES[k] for k in ftd.K3_KERNELS), ftd.LAUNCHES
    assert set(st_k) == {"spec", "stop", "w"}
    for k in st_p:
        assert _rel(st_k[k], st_p[k]) < 2e-2, k
    for k in carry_p:
        assert _rel(carry_k[k], carry_p[k]) < 2e-2, k


# ---------------------------------------------------------------------------
# the forward-attention family: K1 fwd_attention, K2's and K3's variants
# ---------------------------------------------------------------------------

_FAMILY = ("forward", "forward_transition_agent")


def _fwd_state(b, t, mask, seed):
    """A floored, renormalized alignment part way through each text (the
    state the family carries) and a transition probability."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.rand(b, t, device="cuda", generator=gen) ** 4 * mask
    w = torch.clamp(w, min=1e-6)
    return (w / w.sum(-1, keepdim=True),
            0.1 + 0.8 * torch.rand(b, 1, device="cuda", generator=gen))


def _fwd_bundle(kind, rnd, int8=True, mem_dim=_MEM):
    bundle = _gate_bundle(int8, sum(_SEGMENTS["att"]), seed=7)
    bundle.att_kind = "fwd" if kind == "forward" else "fwd_trans"
    bundle.wq = rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5).bfloat16()
    bundle.lc = None
    bundle.v = rnd(_ATT, scale=_ATT ** -0.5)
    bundle.pre_dims = (_MELS, 256, 2)
    if kind != "forward":
        bundle.ta_wc = rnd(mem_dim, scale=mem_dim ** -0.5).bfloat16()
        bundle.ta_wq = rnd(_HIDDEN, scale=_HIDDEN ** -0.5).bfloat16()
        bundle.ta_wx = rnd(256, scale=256 ** -0.5).bfloat16()
        bundle.ta_b = rnd(1, scale=0.1)
    return bundle


@pytest.mark.parametrize("mem_dim", [292, 288, 548])
@pytest.mark.parametrize("t", [1, 7, 16, 45, 120, 128, 129, 200, 600, 1500])
@pytest.mark.parametrize("b", [1, 7, 37, 240])
@pytest.mark.parametrize("kind", _FAMILY)
def test_fwd_attention_matches_plain_at_flagship_widths(kind, b, t,
                                                        mem_dim):
    """K1 ``fwd_attention`` (``lsa_attention``'s kernel without the
    location conv; the staged bf16 instance: the streams' rings of tiles)
    at H=1024, A=128, Mem=292 (and the separate and shared strategies' 288
    and 548), P=256 against ``fwd_attention_plain``, T from 1 to 1500, B
    1, 7, 37 and 240: the context within atol and rtol 2e-3, the
    weights within 1e-2 of each row's largest, every row a distribution,
    the floored masked positions, t_prob within 2e-3, the head row's
    context bf16(context), one launch, a second run bit-identical."""
    from chip_smoke import CTX_TOL, ULP, W_TOL

    rnd, memory, mtb, mask, _ = _attention_operands(b, t, seed=b + t,
                                                    mem_dim=mem_dim)
    bundle = _fwd_bundle(kind, rnd, mem_dim=mem_dim)
    prev, tp = _fwd_state(b, t, mask, seed=b * t)
    tp = tp if kind != "forward" else None
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()
    mask_add = torch.where(mask, 0.0, -1e9)
    row = torch.zeros(b, _HIDDEN + mem_dim + 32, dtype=torch.bfloat16,
                      device="cuda")
    fd.reset_launch_counts()
    ctx_k, w_k, tp_k = fd.fwd_attention(
        h_att, prev, tp, memory, mtb, mask_add, x, bundle,
        ctx_row=row[:, _HIDDEN:_HIDDEN + mem_dim])
    assert fd.LAUNCHES["fwd_attention"] == 1
    again = fd.fwd_attention(h_att, prev, tp, memory, mtb, mask_add, x,
                             bundle)
    ctx_p, w_p, tp_p = fd.fwd_attention_plain(h_att, prev, tp, memory, mtb,
                                              mask_add, x, bundle)
    # a flipped bf16 rounding of a context product moves the context by
    # 2^-8 of it (test_attention_on_int8_streams_matches_plain): the shapes
    # the parent kernel was held at keep CTX_TOL, the others one bf16 ulp
    parent_grid = (t in (45, 128, 200) and b in (1, 37, 240)
                   and mem_dim == _MEM)
    ctx_atol = CTX_TOL if parent_grid else ULP
    torch.testing.assert_close(ctx_k, ctx_p, atol=ctx_atol, rtol=CTX_TOL)
    assert float(((w_k - w_p).abs().amax(1) / w_p.amax(1)).max()) < W_TOL
    torch.testing.assert_close(w_k.sum(-1), torch.ones_like(w_k[:, 0]))
    assert float(w_k.min()) > 0.0
    assert torch.equal(row[:, _HIDDEN:_HIDDEN + mem_dim], ctx_k.bfloat16())
    assert torch.equal(again[0], ctx_k) and torch.equal(again[1], w_k)
    if kind == "forward":
        assert tp_k is None and again[2] is None
    else:
        torch.testing.assert_close(tp_k, tp_p, atol=2e-3, rtol=0)
        assert torch.equal(again[2], tp_k)


@pytest.mark.parametrize("mem_dim", [288, 292, 548])
@pytest.mark.parametrize("t", [1, 7, 120, 128, 600, 1500])
@pytest.mark.parametrize("b", [1, 7, 240])
@pytest.mark.parametrize("kind", _FAMILY)
def test_f32_fwd_attention_matches_plain_at_every_shape(kind, b, t,
                                                        mem_dim, _full_f32):
    """K1 ``fwd_attention``'s float32 instance on float32 streams (the
    energy a lane per four channels with FE32_UNROLL positions' reads in
    flight, the softmax's max and sum in one reduction, the agent's h_att
    and x terms in the prologue) at the separate, flagship and shared
    strategies' 288-, 292- and 548-wide memory, B=1, 7 and 240, T from 1
    to 1500: the context, the weights and t_prob within F32_TOL of their
    largest, every row a floored distribution, one launch, a second run
    bit-identical.  Its instance on int8 streams is held by
    ``test_attention_on_int8_streams_matches_plain``."""
    gen = torch.Generator(device="cuda").manual_seed(3 * b + t + mem_dim)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    memory, mtb = rnd(b, t, mem_dim), rnd(b, t, _ATT, scale=0.5)
    lengths = torch.randint(max(1, t // 2), t + 1, (b,), device="cuda",
                            generator=gen)
    mask = torch.arange(t, device="cuda")[None] < lengths[:, None]
    mask_add = torch.where(mask, 0.0, -1e9)
    bundle = SimpleNamespace(
        dtype=torch.float32, q_streams=False,
        att_kind="fwd" if kind == "forward" else "fwd_trans",
        wq=rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5), lc=None,
        v=rnd(_ATT, scale=_ATT ** -0.5), pre_dims=(_MELS, 256, 2))
    if kind != "forward":
        bundle.ta_wc = rnd(mem_dim, scale=mem_dim ** -0.5)
        bundle.ta_wq = rnd(_HIDDEN, scale=_HIDDEN ** -0.5)
        bundle.ta_wx = rnd(256, scale=1 / 16)
        bundle.ta_b = rnd(1, scale=0.1)
    prev, tp = _fwd_state(b, t, mask, seed=b * t + 1)
    tp = tp if kind != "forward" else None
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()
    args = (h_att, prev, tp, memory, mtb, mask_add, x, bundle)
    fd.reset_launch_counts()
    got = fd.fwd_attention(*args)
    assert fd.LAUNCHES["fwd_attention_f32"] == 1
    again = fd.fwd_attention(*args)
    ref = fd.fwd_attention_plain(*args)
    for g, a, r in zip(got, again, ref):
        if r is None:
            assert g is None and a is None
            continue
        _f32_close(g, r)
        assert torch.equal(g, a)
    torch.testing.assert_close(got[1].sum(-1), torch.ones_like(got[1][:, 0]))
    assert float(got[1].min()) > 0.0


def _family_train_operands(kind, b, t, seed):
    """The family's K2/K3 operands at the flagship's widths, random."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    rnd, memory, mtb, mask, _ = _attention_operands(b, t, seed=seed)
    ta = SimpleNamespace(
        w=rnd(_MEM + _HIDDEN + 256, scale=0.03),
        b=rnd(1, scale=0.1)) if kind != "forward" else None
    return ftd, rnd, memory, mtb, mask, ta


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [1, 17, 128, 512, 600])
@pytest.mark.parametrize("b", [1, 50, 67, 240])
@pytest.mark.parametrize("kind", _FAMILY)
def test_train_fwd_attention_matches_plain(kind, b, t, dtype):
    """K2 ``train_attention``'s family variant (clusters over tiles of the
    row's positions; three one-way exchanges: the softmax's (maximum,
    sum) pairs, the renorm's sums and the context partials with the
    agent's partials beside them) against the plain version, in both compute
    types, three steps chained through the carries, with and without the
    streams: bf16, the weights (also the new state) within 1e-2 of each
    row's largest, the context within 2e-3, t_prob within 2e-3; float32,
    the weights, the new state and the context within F32_TOL of their
    largest, t_prob within 1e-5; the state stream exact; two runs
    bit-identical."""
    from chip_smoke import CTX_TOL, W_TOL

    f32 = dtype == torch.float32
    ftd, rnd, memory, mtb, mask, ta = _family_train_operands(
        kind, b, t, seed=7 * b + t)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    mask_add = torch.where(mask, 0.0, -1e9)
    v = rnd(_ATT, scale=_ATT ** -0.5)
    state, tp0 = _fwd_state(b, t, mask, seed=b + 3 * t)
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()
    for step in range(3):
        q = rnd(b, _ATT).to(dtype).float()

        def run(fn, streams=True):
            cc, ctx = state.clone(), torch.empty(b, _MEM, device="cuda")
            w = torch.empty(b, t, device="cuda")
            cum_s = (torch.empty(b, t, dtype=dtype, device="cuda")
                     if streams else None)
            dsts = [torch.empty(b, _MEM, dtype=dtype, device="cuda")
                    for _ in range(3)]
            agent = None
            outs = [cc, w, ctx]
            if ta is not None:
                tp = tp0[:, 0].clone()
                tp_s = torch.empty(b, device="cuda") if streams else None
                agent = ftd.AgentArgs(tp, tp_s, h_att, x, ta.w, ta.b)
                outs += [tp] + ([tp_s] if streams else [])
            fn(q, cc, memory, mtb, mask_add, None, v, w, cum_s, ctx, dsts,
               agent=agent)
            return outs + [x for x in (cum_s, *dsts) if x is not None]

        for streams in (True, False):
            ftd.reset_launch_counts()
            got = run(ftd.train_attention, streams)
            assert ftd.LAUNCHES[ftd.instance("train_attention_fwd",
                                             dtype)] == 1
            assert sum(ftd.LAUNCHES.values()) == 1
            again = run(ftd.train_attention, streams)
            ref = run(ftd.PLAIN.train_attention, streams)
            assert all(torch.equal(g, a) for g, a in zip(got, again))
            cc_k, w_k, ctx_k = got[:3]
            cc_p, w_p, ctx_p = ref[:3]
            n_tp = 0 if ta is None else (2 if streams else 1)
            if f32:
                for g in (w_k, cc_k):
                    _f32_close(g, w_p)
                _f32_close(ctx_k, ctx_p)
            else:
                w_max = w_p.amax(1)
                for g in (w_k, cc_k):
                    assert float(((g - w_p).abs().amax(1)
                                  / w_max).max()) < W_TOL
                torch.testing.assert_close(ctx_k, ctx_p, atol=CTX_TOL,
                                           rtol=CTX_TOL)
            for g, r in zip(got[3:3 + n_tp], ref[3:3 + n_tp]):
                torch.testing.assert_close(g, r, atol=1e-5 if f32 else 2e-3,
                                           rtol=0)
            rows_k = got[3 + n_tp:]
            for row in rows_k[-3:]:
                assert torch.equal(row, ctx_k.to(dtype))
            if streams:
                assert torch.equal(rows_k[0], state.to(dtype))
        state = ref[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [45, 128, 512, 1500])
@pytest.mark.parametrize("b", [1, 50, 96])
@pytest.mark.parametrize("kind", _FAMILY)
def test_fwd_att_bwd_matches_plain(kind, b, t, dtype):
    """K3 ``att_bwd``'s family variant (the replayed softmax and
    recurrence, the renorm, floor and shift backward, the agent's backward
    in its prologue; the dz pass a thread a channel pair and a group of
    positions) against the plain version, in both compute types, at T = 45
    (3 tiles of 16), 128 (8 of 16), 512 (8 of 64) and 1500 (8 of 192),
    three chained calls so that the dmt and dv "+=" and the state and
    t_prob cotangent carries are covered: bf16, every float32 output within
    chip_smoke's ``att_bwd_fwd`` bound of its largest value, the bf16 dq
    and dctx streams within one ulp; float32, every output within F32_TOL;
    two chains from the same start bit-identical."""
    ftd, rnd, memory, mtb, mask, ta = _family_train_operands(
        kind, b, t, seed=11 * b + t)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    mask_add = torch.where(mask, 0.0, -1e9)
    v = rnd(_ATT, scale=_ATT ** -0.5)
    steps = []
    for _ in range(3):
        w_s, tp = _fwd_state(b, t, mask, seed=int(rnd(1).abs() * 1e4))
        prev, tp_prev = _fwd_state(b, t, mask, seed=int(rnd(1).abs() * 1e4))
        steps.append((rnd(b, _ATT).to(dtype).float(), prev.to(dtype), w_s,
                      rnd(b, _MEM), rnd(b, t, scale=0.1), tp_prev[:, 0],
                      tp[:, 0]))
    dcum0, dtp0 = rnd(b, t, scale=0.1), rnd(b, scale=0.5)
    dh0 = rnd(b, _HIDDEN, scale=0.1)

    def chain(fn):
        acc = [torch.zeros(b, t, _ATT, device="cuda"),
               torch.zeros(b, _ATT, device="cuda"), dcum0.clone()]
        extra = [dtp0.clone(), dh0.clone()] if ta is not None else []
        outs = []
        for q, cum_s, w_s, dctx, dw, tp_prev, tp in steps:
            o = [torch.empty(b, _ATT, dtype=dtype, device="cuda"),
                 torch.empty(b, _MEM, dtype=dtype, device="cuda")]
            if ta is None:
                fam = ftd.FamilyBwd(mask_add)
            else:
                o += [torch.empty(b, device="cuda"),
                      torch.empty(b, 256, device="cuda")]
                fam = ftd.FamilyBwd(mask_add, tp_prev, tp, extra[0], o[2],
                                    ta.w, extra[1], o[3])
            fn(q, cum_s, w_s, memory, mtb, None, v, dctx, dw, acc[2], acc[0],
               None, acc[1], o[0], o[1], fam=fam)
            outs += o
        return acc + extra + outs

    ftd.reset_launch_counts()
    got = chain(ftd.att_bwd)
    inst = ftd.instance("att_bwd_fwd", dtype)
    assert ftd.LAUNCHES[inst] == 3 and not any(
        v for k, v in ftd.LAUNCHES.items() if k != inst)
    again = chain(ftd.att_bwd)
    ref = chain(ftd.PLAIN.att_bwd)
    bound = train_kernel_bound("att_bwd_fwd", dtype)
    for g, a, r in zip(got, again, ref):
        kind_ = "bf16" if r.dtype == torch.bfloat16 else "f32"
        err = float((g.float() - r.float()).abs().max())
        assert err <= bound[kind_] * float(r.float().abs().max()), kind_
        assert torch.equal(g, a)


@pytest.mark.parametrize("kind", _FAMILY)
def test_family_decode_and_training_run_the_kernels(kind):
    """A whole small model of the family on the card: a serving chunk
    through the kernels against the plain chunk (relative 1e-2), a
    synthesis that launches ``fwd_attention`` and not ``lsa_attention``,
    and 12 training steps forward and backward through the K2/K3 family
    variants against their plain versions (relative 2e-2, as the
    location-sensitive test), launching the family's kernels only."""
    hp = _hp(True)
    hp.attention_type = kind
    torch.manual_seed(0)
    sd = init_random_weights(Tacotron(hp), 0).state_dict()
    syn = Synthesizer(hp, sd, device="cuda")
    b, t = 10, 24
    text = torch.randint(3, hp.total_symbols(), (b, t), device="cuda")
    lengths = torch.randint(t // 2, t + 1, (b,), device="cuda")
    memory, mt, mask, carry = syn.model.encode_for_inference(
        text, lengths, torch.randint(0, 4, (b,), device="cuda"),
        torch.arange(b, device="cuda") % 5)
    kw = syn.decode_kwargs
    c_k, (spec_k, _) = fd.decode_chunk(syn.bundle, carry, memory, mt, mask,
                                       (5, 6), 8, **kw)
    c_p, (spec_p, _) = fd.decode_chunk_plain(syn.bundle, carry, memory, mt,
                                             mask, (5, 6), 8, **kw)
    assert _rel(spec_k, spec_p) < 1e-2
    assert set(c_k["att_state"]) == set(c_p["att_state"])
    fd.reset_launch_counts()
    out = syn.synthesize_batch_lines(["1|hallo|a|de", "2|salut|b|fr"])
    assert all(fd.LAUNCHES[k] > 0 for k in fd.path_kernels("fwd")), \
        fd.LAUNCHES
    assert fd.LAUNCHES["lsa_attention"] == 0
    assert all(torch.isfinite(torch.as_tensor(o)).all() for o in out)

    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    hp.dropout = 0.5
    model = init_random_weights(Tacotron(hp, torch.bfloat16), 0).cuda()
    with torch.no_grad():
        enc = model.encoder(model.embedding(text).bfloat16(), lengths).float()
        memory, mt = model.decoder.prepare_memory(
            enc, torch.randint(0, 4, (b,), device="cuda"),
            torch.zeros(b, t, dtype=torch.long, device="cuda"))
        cfg = ftd.TrainConfig.from_hp(hp, model.decoder.memory_dim,
                                      torch.bfloat16)
        ops = ftd.compute_operands(
            ftd.train_operands(model.decoder.cell, cfg), cfg)
        mtb = (mt.float()
               + model.decoder.cell.attention.energy_bias).bfloat16()
    mask_add = torch.where(mask, 0.0, -1e9)
    shifted = torch.randn(12, b, hp.num_mels, device="cuda").bfloat16()
    teacher = [1, 0] * 6
    seeds = (1234, 98765)
    k2, k3 = ftd.path_kernels(cfg.att_kind)
    ftd.reset_launch_counts()
    args = (ops, cfg, memory.contiguous(), mtb.contiguous(), mask_add,
            shifted, teacher, seeds)
    st_k, carry_k = ftd.train_decode_forward(*args)
    st_p, carry_p = ftd.train_decode_forward(*args, plain=True)
    for k in st_p:
        assert _rel(st_k[k], st_p[k]) < 2e-2, k
    for k in carry_p:
        assert _rel(carry_k[k], carry_p[k]) < 2e-2, k
    gen = torch.Generator(device="cuda").manual_seed(3)
    cts = [torch.randn(x.shape, device="cuda", generator=gen)
           for x in (st_p["spec"], st_p["stop"], st_p["w"])]
    bargs = (ops, cfg, memory.contiguous(), mtb.contiguous(), st_p, teacher,
             seeds, *cts)
    g_k, s_k, c_k = ftd.train_decode_backward(*bargs, mask_add=mask_add)
    g_p, s_p, c_p = ftd.train_decode_backward(*bargs, plain=True,
                                              mask_add=mask_add)
    assert all(ftd.LAUNCHES[k] > 0 for k in k2 + k3), ftd.LAUNCHES
    assert not ftd.LAUNCHES["train_attention"] and not ftd.LAUNCHES["att_bwd"]
    for name, (got, ref) in {**{f"grad {k}": (g_k[k], g_p[k]) for k in g_p},
                             **{f"stream {k}": (s_k[k], s_p[k]) for k in s_p},
                             **{f"carry {k}": (c_k[k], c_p[k]) for k in c_p}
                             }.items():
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, ref) < 2e-2, (name, _rel(got, ref))


# ---------------------------------------------------------------------------
# all three attention kernels on long texts
# ---------------------------------------------------------------------------

def _check_att_bwd_chain(att_bwd, kind, dtype, b, t, rnd, memory, mtb, mask,
                         mask_add, cum0, lc, v, ta):
    """Two chained ``att_bwd`` calls (the accumulators and carries passed
    on) against its plain version on the same random inputs: float32
    outputs within F32_TOL of their largest value, bf16 within its
    chip_smoke bound; the instance launched twice."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    f32 = dtype == torch.float32
    family = kind != "location_sensitive"
    steps = []
    for _ in range(2):
        if family:
            w_s, tp = _fwd_state(b, t, mask, seed=int(rnd(1).abs() * 1e4))
            prev, tp_prev = _fwd_state(b, t, mask,
                                       seed=int(rnd(1).abs() * 1e4))
            cum_s, tps = prev.to(dtype), (tp_prev[:, 0], tp[:, 0])
        else:
            e = torch.where(mask, rnd(b, t), torch.full_like(cum0, -1e9))
            w_s = torch.softmax(e, -1)
            cum_s, tps = (cum0 + 0.1 * rnd(b, t).abs()).to(dtype), None
        steps.append((rnd(b, _ATT).to(dtype).float(), cum_s, w_s,
                      rnd(b, _MEM), rnd(b, t, scale=0.1), tps))
    dcum0, dtp0 = rnd(b, t, scale=0.1), rnd(b, scale=0.5)
    dh0 = rnd(b, _HIDDEN, scale=0.1)

    def backward(fn):
        acc = [torch.zeros(b, t, _ATT, device="cuda"),
               None if family else torch.zeros(b, _TAPS, _ATT, device="cuda"),
               torch.zeros(b, _ATT, device="cuda"), dcum0.clone()]
        extra = [dtp0.clone(), dh0.clone()] if ta is not None else []
        outs = []
        for q_s, cum_s, w_s, dctx, dw, tps in steps:
            o = [torch.empty(b, _ATT, dtype=dtype, device="cuda"),
                 torch.empty(b, _MEM, dtype=dtype, device="cuda")]
            fam = None
            if ta is not None:
                o += [torch.empty(b, device="cuda"),
                      torch.empty(b, 256, device="cuda")]
                fam = ftd.FamilyBwd(mask_add, tps[0], tps[1], extra[0], o[2],
                                    ta.w, extra[1], o[3])
            elif family:
                fam = ftd.FamilyBwd(mask_add)
            fn(q_s, cum_s, w_s, memory, mtb, lc, v, dctx, dw, acc[3], acc[0],
               acc[1], acc[2], o[0], o[1], fam=fam)
            outs += o
        return [a for a in acc if a is not None] + extra + outs

    ftd.reset_launch_counts()
    got, ref = backward(att_bwd), backward(ftd.PLAIN.att_bwd)
    bwd = "att_bwd_fwd" if family else "att_bwd"
    assert ftd.LAUNCHES[ftd.instance(bwd, dtype)] == 2, ftd.LAUNCHES
    bound = TRAIN_KERNEL_TOL["att_bwd"]
    for g, r in zip(got, ref):
        if f32:
            _f32_close(g, r)
        else:
            kind_ = "bf16" if r.dtype == torch.bfloat16 else "f32"
            err = float((g.float() - r.float()).abs().max())
            assert err <= bound[kind_] * float(r.float().abs().max()), kind_


# T = 2,304 (tiles of 288 positions) is the float32 att_bwd's single-tile
# limit at the flagship's widths; 4,096 and 8,192 (tiles of 512 and 1,024)
# run its sub-tiled layout in every instance
# (ops/fused_train_decoder.py::att_bwd_plan)
@pytest.mark.parametrize("kind,dtype,t,b", [
    (kind, dtype, t, b) for kind in ("location_sensitive", *_FAMILY)
    for dtype in (torch.bfloat16, torch.float32) for t in (600, 1000, 1500)
    for b in (1, 3, 50, 240)
] + [("location_sensitive", torch.float32, 2304, b)
     for b in (1, 3, 50, 240)] + [
    (kind, dtype, t, b) for kind in ("location_sensitive", *_FAMILY)
    for dtype in (torch.bfloat16, torch.float32) for t in (4096, 8192)
    for b in (1, 3, 8)])
def test_attention_kernels_take_long_texts(kind, dtype, t, b, _full_f32):
    """T = 600, 1000 and 1500 symbols (tiles of 80, 128 and 192 positions,
    past what a CTA's shared memory holds of the rows in float32) at B = 1,
    3, 50 and 240, in float32 the 2,304 that the location-sensitive
    ``att_bwd``'s single tile takes at most, and 4,096 and 8,192 at B = 1,
    3 and 8, at the flagship's widths, each attention kind and compute
    type: K2's
    ``train_attention`` (one step with its streams: weights, new state,
    context, t_prob), K3's ``att_bwd`` (two chained calls) and K1's
    ``lsa_attention`` or ``fwd_attention`` against their plain versions on
    the same inputs (K2's new state exactly cum + w of its own weights;
    K1's weights, read back as cum' - cum, with that subtraction's
    rounding, ``_cum_slack``).  float32: the weights within 1e-4 of each row's
    largest (a weight carries the absolute float32 error of its energy,
    whose sums over 128 channels run in another order on each side:
    measured up to 2.8e-5 at T=600), every other output within F32_TOL of
    its largest value; bf16: the bounds of the T <= 512 tests (weights
    within W_TOL of the row's largest, contexts within CTX_TOL,
    ``att_bwd`` within its chip_smoke bound)."""
    from chip_smoke import CTX_TOL, W_TOL
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    f32 = dtype == torch.float32
    family = kind != "location_sensitive"
    rnd, memory, mtb, mask, cum0 = _attention_operands(b, t, seed=t + 3)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    mask_add = torch.where(mask, 0.0, -1e9)
    lc = None if family else rnd(_TAPS, _ATT, scale=0.1).to(dtype)
    v = rnd(_ATT, scale=_ATT ** -0.5)
    if family:
        cum0, tp0 = _fwd_state(b, t, mask, seed=t)
        tp0 = tp0[:, 0]
    ta = (SimpleNamespace(w=rnd(_MEM + _HIDDEN + 256, scale=0.03),
                          b=rnd(1, scale=0.1))
          if kind == "forward_transition_agent" else None)
    h_att, x = rnd(b, _HIDDEN), rnd(b, 256).relu()

    def close(g, r, w_rows=False, slack=0.0):
        if w_rows:
            bound = 1e-4 if f32 else W_TOL
            assert float((((g - r).abs().amax(1) - slack)
                          / r.amax(1)).max()) < bound
        elif f32:
            _f32_close(g, r)
        else:
            torch.testing.assert_close(g.float(), r.float(), atol=CTX_TOL,
                                       rtol=CTX_TOL)

    # K2: one step with its streams
    q = rnd(b, _ATT).to(dtype).float()

    def forward(fn):
        cc, ctx = cum0.clone(), torch.empty(b, _MEM, device="cuda")
        w = torch.empty(b, t, device="cuda")
        cum_s = torch.empty(b, t, dtype=dtype, device="cuda")
        dsts = [torch.empty(b, _MEM, dtype=dtype, device="cuda")
                for _ in range(3)]
        outs, agent = [w, cc, ctx, cum_s], None
        if ta is not None:
            tp, tp_s = tp0.clone(), torch.empty(b, device="cuda")
            agent = ftd.AgentArgs(tp, tp_s, h_att, x, ta.w, ta.b)
            outs += [tp, tp_s]
        fn(q, cc, memory, mtb, mask_add, lc, v, w, cum_s, ctx, dsts,
           agent=agent)
        return outs + dsts

    ftd.reset_launch_counts()
    got, ref = forward(ftd.train_attention), forward(ftd.PLAIN.train_attention)
    att = "train_attention_fwd" if family else "train_attention"
    assert ftd.LAUNCHES[ftd.instance(att, dtype)] == 1, ftd.LAUNCHES
    w_k, cc_k, ctx_k, cs_k, *rest_k = got
    w_p, cc_p, ctx_p, cs_p, *rest_p = ref
    close(w_k, w_p, w_rows=True)
    # the new state: cum + w, or the family's w itself, of the kernel's own
    # weights (held against the plain version's above) exactly; read back
    # as cum' - cum it would carry cum's float32 rounding, one ulp of cum'
    # (1.2e-7 near 1), past 1e-4 of a row's largest weight at T = 2,304
    assert torch.equal(cc_k, w_k if family else cum0 + w_k)
    close(ctx_k, ctx_p)
    assert torch.equal(cs_k, cs_p)
    for g, r in zip(rest_k[:2] if ta is not None else [],
                    rest_p[:2] if ta is not None else []):
        torch.testing.assert_close(g, r, atol=1e-5 if f32 else 2e-3, rtol=0)
    for row in rest_k[-3:]:
        assert torch.equal(row, ctx_k.to(dtype))

    # K3: two chained calls
    _check_att_bwd_chain(ftd.att_bwd, kind, dtype, b, t, rnd, memory, mtb,
                         mask, mask_add, cum0, lc, v, ta)

    # K1: one serving step
    if f32:
        _, bundle = _f32_bundle(kind, True)
    elif family:
        bundle = _fwd_bundle(kind, rnd)
    else:
        bundle = _gate_bundle(True, sum(_SEGMENTS["att"]), seed=t)
        bundle.wq = rnd(_HIDDEN, _ATT, scale=_HIDDEN ** -0.5).bfloat16()
        bundle.lc = rnd(_TAPS, _ATT, scale=0.1).bfloat16()
        bundle.v = rnd(_ATT, scale=_ATT ** -0.5)
    fd.reset_launch_counts()
    if family:
        tp = None if ta is None else tp0[:, None]
        got = fd.fwd_attention(h_att, cum0, tp, memory, mtb, mask_add, x,
                               bundle)
        ref = fd.fwd_attention_plain(h_att, cum0, tp, memory, mtb, mask_add,
                                     x, bundle)
        close(got[0], ref[0])
        close(got[1], ref[1], w_rows=True)
        if ta is not None:
            torch.testing.assert_close(got[2], ref[2],
                                       atol=1e-5 if f32 else 2e-3, rtol=0)
        k1 = "fwd_attention"
    else:
        ctx_k, cum_k = fd.lsa_attention(h_att, cum0, memory, mtb, mask_add,
                                        bundle)
        ctx_p, cum_p = fd.lsa_attention_plain(h_att, cum0, memory, mtb,
                                              mask_add, bundle)
        close(ctx_k, ctx_p)
        # the weights read back as cum' - cum (K1 returns cum' alone)
        close(cum_k - cum0, cum_p - cum0, w_rows=True,
              slack=_cum_slack(t, cum_p) if f32 else 0.0)
        k1 = "lsa_attention"
    assert fd.LAUNCHES[fd.instance(k1, dtype)] == 1, fd.LAUNCHES


def _att_bwd_setup(kind, dtype, b, t, seed):
    """``_check_att_bwd_chain``'s operands of the long-text test's kind:
    random bf16 streams in the compute type, lc (location-sensitive), v and
    the transition agent's weights."""
    rnd, memory, mtb, mask, cum0 = _attention_operands(b, t, seed=seed)
    memory, mtb = memory.to(dtype), mtb.to(dtype)
    mask_add = torch.where(mask, 0.0, -1e9)
    family = kind != "location_sensitive"
    lc = None if family else rnd(_TAPS, _ATT, scale=0.1).to(dtype)
    v = rnd(_ATT, scale=_ATT ** -0.5)
    if family:
        cum0, _ = _fwd_state(b, t, mask, seed=t)
    ta = (SimpleNamespace(w=rnd(_MEM + _HIDDEN + 256, scale=0.03),
                          b=rnd(1, scale=0.1))
          if kind == "forward_transition_agent" else None)
    return (rnd, memory, mtb, mask, mask_add, cum0, lc, v, ta)


@pytest.mark.parametrize("kind", ["location_sensitive", *_FAMILY])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [128, 600])
@pytest.mark.parametrize("b", [1, 50])
def test_att_bwd_sub_tiled_layout_matches_plain(kind, dtype, t, b,
                                                _full_f32):
    """``att_bwd``'s sub-tiled layout of long texts, forced at T = 128 and
    600 (tiles of 16 and 80 positions in sub-tiles of 16 and 64: a tile's
    last sub-tile short, P's diagonals reaching past the neighbour's first
    sub-tile), at the flagship's widths, each kind and compute type,
    against the plain version at the bounds of the single tile's tests."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    plan = ftd.att_bwd_plan(t, _ATT, _MEM, kind != "location_sensitive",
                            dtype, sub_tiled=True)
    assert plan.sub == min(64, plan.tile) > 0
    rnd, memory, mtb, mask, mask_add, cum0, lc, v, ta = _att_bwd_setup(
        kind, dtype, b, t, seed=t + 7)
    _check_att_bwd_chain(functools.partial(ftd.att_bwd, sub_tiled=True),
                         kind, dtype, b, t, rnd, memory, mtb, mask, mask_add,
                         cum0, lc, v, ta)


@pytest.mark.parametrize("kind", ["location_sensitive", *_FAMILY])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_att_bwd_takes_the_single_tile_at_t128(kind, dtype, monkeypatch):
    """At T = 128 (B = 50) ``att_bwd``'s plan is the single tile (8 CTAs of
    16, no sub-tiles), and its outputs are bit-identical to those of a call
    whose plan is pinned to the single tile's layout: the shapes that fit
    the single tile run its code."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    b, t = 50, 128
    family = kind != "location_sensitive"
    assert ftd.att_bwd_plan(t, _ATT, _MEM, family, dtype) == (16, 8, 0)
    rnd, memory, mtb, mask, mask_add, cum0, lc, v, ta = _att_bwd_setup(
        kind, dtype, b, t, seed=11)
    w_s = torch.softmax(torch.where(mask, rnd(b, t), -1e9), -1)
    q = rnd(b, _ATT).to(dtype).float()
    dctx, dw, dcum = rnd(b, _MEM), rnd(b, t, scale=0.1), rnd(b, t, scale=0.1)
    tp_prev, tp = torch.rand(b, device="cuda"), torch.rand(b, device="cuda")
    dtp, dh = rnd(b, scale=0.5), rnd(b, _HIDDEN, scale=0.1)

    def run():
        outs = [dcum.clone(), torch.zeros(b, t, _ATT, device="cuda"),
                None if family else torch.zeros(b, _TAPS, _ATT,
                                                device="cuda"),
                torch.zeros(b, _ATT, device="cuda"),
                torch.empty(b, _ATT, dtype=dtype, device="cuda"),
                torch.empty(b, _MEM, dtype=dtype, device="cuda")]
        fam = None
        if ta is not None:
            outs += [dtp.clone(), torch.empty(b, device="cuda"), dh.clone(),
                     torch.empty(b, 256, device="cuda")]
            fam = ftd.FamilyBwd(mask_add, tp_prev, tp, outs[6], outs[7],
                                ta.w, outs[8], outs[9])
        elif family:
            fam = ftd.FamilyBwd(mask_add)
        ftd.att_bwd(q, cum0.to(dtype), w_s, memory, mtb, lc, v, dctx, dw,
                    *outs[:6], fam=fam)
        return [o for o in outs if o is not None]

    got = run()

    def single(t_len, *args, **kw):
        return ftd.AttBwdPlan(*ftd.att_bwd_tiles(t_len), 0)

    monkeypatch.setattr(ftd, "att_bwd_plan", single)
    for g, r in zip(got, run()):
        assert torch.equal(g, r)


@pytest.mark.parametrize("family", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_att_bwd_smem_mirror_matches_the_kernels_count(family, dtype):
    """The planner's byte mirror (``ftd.att_bwd_smem_bytes``) equals the
    count the built library exports (``AbLayout``), single tile and
    sub-tiled, over T from 1 to 8,192, memories of 288, 292 and 548, and
    attention widths of 128 and 256."""
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )

    es, f32 = dtype.itemsize, int(dtype == torch.float32)
    lib = ftd._lib()
    for t in (1, 17, 128, 600, 1500, 2304, 2320, 3200, 3968, 3984, 4096,
              6272, 6288, 8192):
        tile, _ = ftd.att_bwd_tiles(t)
        for mem in (288, 292, 548):
            for a in (128, 256):
                for sub in (0, 16, min(64, tile)):
                    assert ftd.att_bwd_smem_bytes(tile, a, mem, family, es,
                                                  sub) == \
                        lib.att_bwd_smem_bytes(tile, a, mem, int(family), f32,
                                               sub), (t, mem, a, sub)


def test_make_mesh_runs_on_the_card_by_default():
    """``make_mesh`` without a device puts the rank on the card, as every
    other entry point of the port."""
    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.parallel import make_mesh

    assert make_mesh(HParams()).device.type == "cuda"
    assert make_mesh(HParams(), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# from a checkpoint to a waveform on the card
# ---------------------------------------------------------------------------

def _serving_weights():
    hp = _hp(True)
    sd = init_random_weights(Tacotron(hp), 0).state_dict()
    sd["decoder.cell.stop_prediction.bias"].fill_(-10.0)
    return hp, sd


def test_from_checkpoint_on_cuda(tmp_path):
    """A port-written checkpoint restored on the card (its default device):
    the state dict bit-identical, spectrograms bit-identical to an
    in-memory synthesizer's, every kernel of the path launched."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.training import checkpoint

    hp, sd = _serving_weights()
    path = str(tmp_path / "model.ckpt")
    checkpoint.save_checkpoint(path, epoch=2, step=40, state_dict=sd, hp=hp,
                               criterion_state={"guided_att_weight": 0.5})
    syn = Synthesizer.from_checkpoint(path)
    assert syn.device.type == "cuda"
    got_sd = syn.model.state_dict()
    assert set(got_sd) == set(sd)
    for k, t in sd.items():
        assert torch.equal(got_sd[k].cpu(), t), k
    lines = ["a|hallo welt|a|de", "b|bonjour|b|fr", "c|mix|c|de*0.5:fr*0.5"]
    ref = Synthesizer(hp, sd, device="cuda").synthesize_batch_lines(
        lines, seed=3)
    fd.reset_launch_counts()
    got = syn.synthesize_batch_lines(lines, seed=3)
    b = syn.bundle
    assert all(fd.LAUNCHES[k] > 0
               for k in fd.path_kernels(b.att_kind, b.dtype, b.q_streams))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("shape", [(300,), (2, 22050), (3, 4096)])
def test_stft_istft_on_cuda_match_cpu(shape):
    """cuFFT against the CPU's FFT: each output within 1e-5 of its largest
    magnitude (n_fft 1102 = 2 x 19 x 29, unpadded)."""
    from multilingual_text_to_speech_tpu_torch.ops import stft

    y = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    ref = stft.stft(y, 1102, 275)
    got = stft.stft(y.cuda(), 1102, 275)
    assert (got.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()
    back_ref = stft.istft(ref, 1102, 275)
    back = stft.istft(ref.cuda(), 1102, 275)
    assert back.shape == back_ref.shape
    assert (back.cpu() - back_ref).abs().max() <= (
        1e-5 * back_ref.abs().max())


@pytest.mark.parametrize("n_iter", [0, 2, 10])
@pytest.mark.parametrize("frames", [2, 7, 120, 512])
def test_griffin_lim_on_cuda_matches_cpu(n_iter, frames):
    """The same initial phases on both devices: every sample within
    GL_TOL of the waveform's peak at up to 10 iterations."""
    from multilingual_text_to_speech_tpu_torch.ops import stft

    g = torch.Generator().manual_seed(frames)
    mag = torch.rand((2, 552, frames), generator=g) ** 2
    angles = stft.random_angles(mag.shape, g)
    ref = stft.griffin_lim(mag, 1102, 275, n_iter=n_iter, angles=angles)
    got = stft.griffin_lim(mag.cuda(), 1102, 275, n_iter=n_iter,
                           angles=angles.cuda())
    assert got.shape == ref.shape
    if ref.numel():
        assert (got.cpu() - ref).abs().max() <= GL_TOL * ref.abs().max()


def test_vocode_batch_on_cuda():
    """``vocode_batch`` on the card: cropped lengths, finite,
    peak-normalized, the same seed the same waveforms; from shared
    phases the card's batch within GL_TOL of the CPU's at 10 iterations."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.config import HParams
    from multilingual_text_to_speech_tpu_torch.ops import audio, stft

    hp, sd = _serving_weights()
    hp.griffin_lim_iters = 10
    syn = Synthesizer(hp, sd, device="cuda")
    specs = syn.synthesize_batch_lines(["a|hallo welt|a|de",
                                        "b|bonjour|b|fr"], seed=1)
    specs[1] = specs[1][:, :15]
    wavs = syn.vocode_batch(specs, seed=4)
    assert [len(w) for w in wavs] == [275 * (s.shape[1] - 1) for s in specs]
    assert all(np.isfinite(w).all() for w in wavs)
    assert wavs[0].max() == 1.0
    again = syn.vocode_batch(specs, seed=4)
    for w, a in zip(wavs, again):
        np.testing.assert_array_equal(w, a)

    full = np.stack([specs[0], specs[0][::-1]])
    hp_cpu = HParams.from_state_dict(hp.state_dict())
    angles = stft.random_angles((2, 552, full.shape[2]),
                                torch.Generator().manual_seed(2))
    got = audio.inverse_spectrogram_batch(full, hp, mel=True, angles=angles,
                                          device="cuda")
    ref = audio.inverse_spectrogram_batch(full, hp_cpu, mel=True,
                                          angles=angles, device="cpu")
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= GL_TOL * np.abs(r).max()


# ---------------------------------------------------------------------------
# the training loop: data on disk, Trainer, the optimizer mapping
# ---------------------------------------------------------------------------

def _loop_corpus(root, hp, n_per_lang=5):
    """A CSS10-layout corpus in ``hp.languages`` (tones and noise), its
    metafile and caches made on the card, split 4 train / 1 val a
    language."""
    import os

    import numpy as np

    from multilingual_text_to_speech_tpu_torch.data import create_meta_file
    from multilingual_text_to_speech_tpu_torch.ops.io import save_wav

    rng = np.random.RandomState(0)
    for li, lang in enumerate(hp.languages):
        os.makedirs(os.path.join(root, lang, "wavs"))
        with open(os.path.join(root, lang, "transcript.txt"), "w",
                  encoding="utf-8") as f:
            for i in range(n_per_lang):
                t = np.arange(2500 + 400 * i) / 22050
                save_wav(0.2 * np.sin(2 * np.pi * (180 + 40 * li) * t)
                         + 0.01 * rng.randn(len(t)),
                         os.path.join(root, lang, "wavs", f"{i}.wav"), 22050)
                print(f"wavs/{i}.wav|x|hallo welt {i} {lang}", file=f)
    create_meta_file("css10", root, "all.txt", hp, 22050, 1102,
                     phonemes=False, device="cuda")
    lines = open(os.path.join(root, "all.txt"), encoding="utf-8"
                 ).read().splitlines()
    for name, keep in (("train.txt", lambda i: i % n_per_lang != 0),
                       ("val.txt", lambda i: i % n_per_lang == 0)):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(l for i, l in enumerate(lines) if keep(i))
                    + "\n")


def _loop_hp():
    hp = _hp(False)
    hp.batch_size = 10
    hp.mel_normalize_mean = hp.mel_normalize_variance = None
    hp.speaker_number = 0
    return hp


def test_trainer_epoch_and_evaluate_launch_the_kernels(tmp_path):
    """``Trainer.train_epoch`` on the card launches every K2 and K3 kernel
    of the path; ``evaluate`` every K2 kernel (the eval variant) and no K3;
    losses, eval loss and MCD finite; a checkpoint resumes bit-identical,
    Adam moments on the card."""
    import math

    from multilingual_text_to_speech_tpu_torch.data import (
        TextToSpeechDatasetCollection,
    )
    from multilingual_text_to_speech_tpu_torch.ops import (
        fused_train_decoder as ftd,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import Trainer

    hp = _loop_hp()
    _loop_corpus(str(tmp_path / "corpus"), hp)
    data = TextToSpeechDatasetCollection(str(tmp_path / "corpus"), hp,
                                         device="cuda")
    tr = Trainer(hp, data, device="cuda", seed=0,
                 log_dir=str(tmp_path / "logs"),
                 checkpoint_dir=str(tmp_path / "ckpt"))
    k2, k3 = ftd.TrainConfig.from_hp(hp, tr.model.decoder.memory_dim,
                                     tr.model.dtype).kernels
    ftd.reset_launch_counts()
    assert tr.train_epoch() == 2
    torch.cuda.synchronize()
    missing = [k for k in k2 + k3 if ftd.LAUNCHES[k] == 0]
    assert not missing, missing
    ftd.reset_launch_counts()
    loss = tr.evaluate()
    torch.cuda.synchronize()
    assert math.isfinite(loss)
    assert all(ftd.LAUNCHES[k] > 0 for k in k2)
    assert not any(ftd.LAUNCHES[k] for k in k3)
    path = tr.save(loss)
    again = Trainer(hp.copy(), data, device="cuda", seed=0,
                    from_checkpoint=path)
    saved = tr.model.state_dict()
    for name, t in again.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(t, saved[name]), name
    for p, st in again.optimizer.state.items():
        assert st["exp_avg"].is_cuda and st["exp_avg_sq"].is_cuda
    assert (again.epoch, again.step) == (1, 2)


def test_optimizer_mapping_round_trips_cuda_tensors():
    """Adam's state on the card -> the optax section (numpy) -> a fresh
    optimizer on the card: bit-identical, both group layouts."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.interop.optax_state import (
        optimizer_from_optax,
        optimizer_to_optax,
    )
    from multilingual_text_to_speech_tpu_torch.training.trainer import (
        make_optimizer,
    )

    for encoder_optimizer in (False, True):
        hp = _hp(False)
        hp.encoder_optimizer = encoder_optimizer
        model = init_random_weights(Tacotron(hp, torch.bfloat16), 1).cuda()
        opt, sched = make_optimizer(model, hp)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for _ in range(2):
            for p in model.parameters():
                if p.requires_grad:
                    p.grad = torch.randn(p.shape, device="cuda",
                                         generator=gen)
            opt.step()
            sched.step()
        section = optimizer_to_optax(model, opt, sched, hp)
        leaf = section["1"]["1"]["mu"] if not encoder_optimizer else \
            section["1"]["inner_states"]["other"]["inner_state"]["1"]["mu"]
        assert isinstance(leaf["decoder"]["cell"]["stop_prediction"][
            "kernel"], np.ndarray)
        opt2, sched2 = make_optimizer(model, hp)
        optimizer_from_optax(section, model, opt2, sched2, hp)
        assert sched2.last_epoch == 2
        for p in model.parameters():
            if not p.requires_grad:
                continue
            a, b = opt.state[p], opt2.state[p]
            assert b["exp_avg"].is_cuda
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a[k], b[k]), k
            assert int(a["step"]) == int(b["step"]) == 2


def test_dataset_computes_uncached_spectrograms_on_the_card(tmp_path):
    """``cache_spectrograms`` off: the dataset's spectrogram from the audio
    on the card, within 1e-5 of the largest amplitude of the CPU's."""
    import numpy as np

    from multilingual_text_to_speech_tpu_torch.data import TextToSpeechDataset

    hp = _loop_hp()
    root = str(tmp_path / "corpus")
    _loop_corpus(root, hp)
    hp.cache_spectrograms = False
    hp.normalize_spectrogram = False
    meta = str(tmp_path / "corpus" / "train.txt")
    card = TextToSpeechDataset(meta, root, hp, device="cuda")
    cpu = TextToSpeechDataset(meta, root, hp, device="cpu")
    assert card.device.type == "cuda"
    for i in (0, 7):
        a, b = 10.0 ** (card[i][3] / 20.0), 10.0 ** (cpu[i][3] / 20.0)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# ---------------------------------------------------------------------------
# data parallel: the mesh of one over NCCL, two gloo ranks on the card
# ---------------------------------------------------------------------------

DP_SHAPE = (10, 16, 16)


def _dp_hp(dtype):
    hp = _hp(False)
    hp.compute_dtype = dtype
    hp.batch_size = DP_SHAPE[0]
    hp.dropout = 0.0
    hp.zoneout_hidden = hp.zoneout_cell = 0.0
    return hp


def test_nccl_mesh_of_one_is_bit_identical_to_the_plain_step():
    """A one-rank NCCL group (a store in the process): the mesh's
    ``train_step`` and the plain one give bit-identical loss terms,
    gradient norm, gradients and weights, prenet dropout and zoneout on."""
    import datetime

    import torch.distributed as dist

    from chip_smoke import deterministic, dp_step
    from multilingual_text_to_speech_tpu_torch.parallel import make_mesh

    hp = _dp_hp("bfloat16")
    hp.dropout, hp.zoneout_hidden, hp.zoneout_cell = 0.5, 0.1, 0.1
    dist.init_process_group(
        "nccl", store=dist.HashStore(), rank=0, world_size=1,
        device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(hp, device="cuda")
        assert (mesh.size, mesh.backend) == (1, "nccl")
        with deterministic():
            plain = dp_step(hp, None, shape=DP_SHAPE)
            one = dp_step(hp, mesh, shape=DP_SHAPE)
    finally:
        dist.destroy_process_group()
    assert plain[1] == one[1] and plain[2] == one[2] and plain[4] == one[4]
    assert plain[3].keys() == one[3].keys()
    for name, g in plain[3].items():
        assert torch.equal(g, one[3][name]), name


def test_two_gloo_ranks_on_the_card_match_the_single_process(tmp_path):
    """Two ranks on the one card over gloo (child processes, 5 rows each)
    against the single process on the global batch, float32: every loss
    term, the gradient norm and each parameter's gradient within 1e-4 of
    its largest value."""
    import os
    import socket
    import subprocess
    import sys

    from chip_smoke import dp_errors, dp_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = (
        "import datetime, sys, torch, torch.distributed as dist\n"
        f"sys.path[:0] = [{repo!r}, {os.path.join(repo, 'tests')!r}]\n"
        "from chip_smoke import dp_step\n"
        "from test_torch_gpu import DP_SHAPE, _dp_hp\n"
        "from multilingual_text_to_speech_tpu_torch.parallel import "
        "make_mesh\n"
        "rank = int(sys.argv[1])\n"
        "torch.cuda.set_device(0)\n"
        f"dist.init_process_group('gloo', init_method='tcp://127.0.0.1:"
        f"{port}', world_size=2, rank=rank, "
        "timeout=datetime.timedelta(seconds=120))\n"
        "hp = _dp_hp('float32')\n"
        "res = dp_step(hp, make_mesh(hp, device='cuda'), shape=DP_SHAPE)\n"
        f"if rank == 0: torch.save(res[1:5], {str(tmp_path / 'r0.pt')!r})\n"
        "dist.destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)],
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = (None, *torch.load(tmp_path / "r0.pt", weights_only=False), None)
    errs = dp_errors(got, dp_step(_dp_hp("float32"), None, shape=DP_SHAPE))
    name, top = max(errs.items(), key=lambda kv: kv[1])
    assert top <= 1e-4, (name, top)
