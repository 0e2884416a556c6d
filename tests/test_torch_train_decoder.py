"""The port's training decode (K2 forward, K3 backward) against the JAX
package's fused train decoder, on the CPU in float32.

The JAX side runs its Pallas kernels in interpret mode
(``pallas_train_decoder.make_train_decode_fn(..., interpret=True)``); the
port runs the plain PyTorch versions of its kernels.  Both get the same
numpy-seeded weights and inputs, the same teacher flags and the same two
uint32 decoder seeds (the JAX package draws them from its key as
``jax.random.bits(rng, (2,), uint32)``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.ops import pallas_decoder
from multilingual_text_to_speech_tpu.ops import pallas_train_decoder as ptd
from multilingual_text_to_speech_tpu_torch.interop import params_from_jax
from multilingual_text_to_speech_tpu_torch.models.decoder import DecoderCell
from multilingual_text_to_speech_tpu_torch.ops import fused_decoder
from multilingual_text_to_speech_tpu_torch.ops import fused_train_decoder as ftd
from tests.torch_port_utils import port_hp, tiny_hp, to_np

B, T, MEM, FRAMES = 4, 10, 12, 7


def _hp(regularization="zoneout", n_prenet=2, dropout=0.5):
    return tiny_hp(decoder_regularization=regularization,
                   prenet_layers=n_prenet, dropout=dropout,
                   zoneout_hidden=0.1, zoneout_cell=0.1, dropout_hidden=0.1)


def _cell_params(hp, seed=0):
    """numpy weights of one DecoderCell (flax layout, scale 0.3)."""
    rng = np.random.RandomState(seed)
    h, p, a = hp.decoder_dimension, hp.prenet_dimension, hp.attention_dimension
    m, k, c = hp.num_mels, hp.attention_kernel_size, \
        hp.attention_location_dimension

    def r(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    prenet = {f"fc{i}": {"kernel": r(m if i == 0 else p, p), "bias": r(p)}
              for i in range(hp.prenet_layers)}
    return {
        "prenet": prenet,
        "attention_lstm": {"cell": {"gates": {
            "kernel": r(p + MEM + h, 4 * h), "bias": r(4 * h)}}},
        "attention": {"query_kernel": r(h, a), "loc_filter": r(k, 1, c),
                      "location_kernel": r(c, a), "bias": r(1, a),
                      "energy_kernel": r(a, 1)},
        "generator_lstm": {"cell": {"gates": {
            "kernel": r(h + MEM + h, 4 * h), "bias": r(4 * h)}}},
        "frame_prediction": {"kernel": r(h + MEM, m), "bias": r(m)},
        "stop_prediction": {"kernel": r(h + MEM, 1), "bias": r(1)},
    }


def _port_cell(hp, params):
    cell = DecoderCell(port_hp(hp), MEM)
    sd = params_from_jax({"params": {"decoder": {"cell": params}}})
    cell.load_state_dict({k[len("decoder.cell."):]: v for k, v in sd.items()},
                         strict=True)
    return cell


def _inputs(hp, ratio, seed=1):
    rng = np.random.RandomState(seed)
    memory = rng.randn(B, T, MEM).astype(np.float32)
    mt = (rng.randn(B, T, hp.attention_dimension) * 0.5).astype(np.float32)
    lengths = np.array([T, T - 3, T - 1, 4])
    mask = np.arange(T)[None, :] < lengths[:, None]
    shifted = rng.randn(B, FRAMES, hp.num_mels).astype(np.float32)
    teacher = (rng.uniform(size=FRAMES) < ratio).astype(np.int32)
    key = jax.random.PRNGKey(seed + 7)
    seeds = tuple(int(s) for s in np.asarray(
        jax.random.bits(key, (2,), jnp.uint32)))
    return memory, mt, mask, shifted, teacher, key, seeds


def _jax_decode(hp):
    return ptd.make_train_decode_fn(hp, dtype=jnp.float32, interpret=True,
                                    fwd_chunk=4, bwd_chunk=3)


def _port_cfg(hp):
    return ftd.TrainConfig.from_hp(port_hp(hp), MEM, torch.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(regularization, n_prenet, ratio):
    hp = _hp(regularization, n_prenet)
    params = _cell_params(hp)
    memory, mt, mask, shifted, teacher, key, _ = _inputs(hp, ratio)
    out = _jax_decode(hp)(jax.tree_util.tree_map(jnp.asarray, params),
                          jnp.asarray(memory), jnp.asarray(mt),
                          jnp.asarray(mask), jnp.asarray(shifted),
                          jnp.asarray(teacher), key)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("ratio", [1.0, 0.5, 0.0])
def test_forward_matches_interpret_kernel(ratio):
    """Plain K2 (through ``decode``) against interpret-mode K2 at prenet
    dropout 0.5 and zoneout 0.1: spec, stop and attention weights within
    atol 2e-5 (float32 sums in another order).  A single different mask
    element moves the outputs by far more than that."""
    hp = _hp()
    cell = _port_cell(hp, _cell_params(hp))
    memory, mt, mask, shifted, teacher, _, seeds = _inputs(hp, ratio)
    with torch.no_grad():
        got = ftd.decode(cell, _port_cfg(hp), torch.as_tensor(memory),
                         torch.as_tensor(mt), torch.as_tensor(mask),
                         torch.as_tensor(shifted), teacher.tolist(), seeds)
    for g, r, name in zip(got, _jax_forward("zoneout", 2, ratio),
                          ("spec", "stop", "alignment")):
        np.testing.assert_allclose(to_np(g), r, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("which", ["att", "gen"])
@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_masks_bit_exact(regularization, which):
    """The port's cell and prenet masks are the JAX kernels' draws: the
    same salt layout (``_salt_layout``) and thresholds, bit for bit."""
    hp = _hp(regularization)
    cfg = _port_cfg(hp)
    jcfg = ptd._make_cfg(hp, t_len=T, mem_dim=MEM,
                         att_dim=hp.attention_dimension, dtype=jnp.float32)
    seeds = (123456789, 3987654321)
    site_h = jcfg.salt_att_h if which == "att" else jcfg.salt_gen_h
    site_c = jcfg.salt_att_c if which == "att" else jcfg.salt_gen_c
    for gs in (0, 5, 511):
        reg = cfg.reg(which, seeds, gs)
        for site, th, k in ((site_h, ptd._thresh(1.0 - jcfg.zoneout_h), 0),
                            (site_c, ptd._thresh(1.0 - jcfg.zoneout_c), 1)):
            ref = np.asarray(pallas_decoder._rand_bits(
                (B, cfg.hidden), jnp.uint32(seeds[0]), jnp.uint32(seeds[1]),
                jnp.asarray(gs * jcfg.salt_sites + site, jnp.int32))) < th
            got = to_np(ftd._masks((B, cfg.hidden), reg, k, None))
            np.testing.assert_array_equal(got, ref)
        for layer in range(cfg.n_prenet):
            ref = np.asarray(pallas_decoder._rand_bits(
                (B, cfg.prenet_dim), jnp.uint32(seeds[0]),
                jnp.uint32(seeds[1]),
                jnp.asarray(gs * jcfg.salt_sites + layer, jnp.int32)))
            got = fused_decoder.rand_bits((B, cfg.prenet_dim), *seeds,
                                          cfg.prenet_salt(gs) + layer)
            np.testing.assert_array_equal(to_np(got).astype(np.uint32), ref)


def _cotangents(hp, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, FRAMES, hp.num_mels).astype(np.float32),
            rng.randn(B, FRAMES).astype(np.float32),
            rng.randn(B, FRAMES, T).astype(np.float32))


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat_grads(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _to_jax_layout(cell, grads):
    """The port's parameter gradients in the flax layout, keyed by path."""
    out = {}
    for (name, p), g in zip(cell.named_parameters(), grads):
        g = to_np(g)
        leaf = name.split(".")[-1]
        path = "/".join(name.split(".")[:-1])
        if leaf == "weight":
            out[f"{path}/kernel"] = g.T
        else:
            out[f"{path}/{leaf}"] = g
    return out


def _check_backward_against_jax_vjp(regularization, n_prenet):
    """Plain K3 through ``TrainDecode`` against the JAX custom VJP (the
    interpret-mode K3): every parameter gradient and the memory and memory
    transform gradients within 1e-4 of that tensor's largest value."""
    hp = _hp(regularization, n_prenet)
    params = _cell_params(hp)
    memory, mt, mask, shifted, teacher, key, seeds = _inputs(hp, 0.5)
    cts = _cotangents(hp)
    decode = _jax_decode(hp)

    def f(cp, mem, mtr):
        return decode(cp, mem, mtr, jnp.asarray(mask), jnp.asarray(shifted),
                      jnp.asarray(teacher), key)

    _, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(memory), jnp.asarray(mt))
    g_cell, g_mem, g_mt = vjp(tuple(jnp.asarray(c) for c in cts))
    ref = _flat_grads(g_cell)

    cell = _port_cell(hp, params)
    mem_t = torch.as_tensor(memory).requires_grad_()
    mt_t = torch.as_tensor(mt).requires_grad_()
    out = ftd.decode(cell, _port_cfg(hp), mem_t, mt_t, torch.as_tensor(mask),
                     torch.as_tensor(shifted), teacher.tolist(), seeds)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(out, cts))
    grads = torch.autograd.grad(loss, list(cell.parameters()) + [mem_t, mt_t])
    got = _to_jax_layout(cell, grads[:-2])
    got["memory"], got["memory_transform"] = to_np(grads[-2]), to_np(grads[-1])
    ref["memory"], ref["memory_transform"] = np.asarray(g_mem), np.asarray(g_mt)
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for name, r in ref.items():
        scale = np.abs(r).max() + 1e-6
        err = np.abs(got[name].reshape(r.shape) - r).max() / scale
        assert err < 1e-4, (name, err)


@pytest.mark.parametrize("n_prenet", [1, 2])
@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_backward_matches_jax_vjp(regularization, n_prenet):
    """Plain K3 through ``TrainDecode`` against the JAX custom VJP: see
    ``_check_backward_against_jax_vjp``."""
    _check_backward_against_jax_vjp(regularization, n_prenet)


# a K3 step's wrapper calls in order: each LSTM cell's backward runs inside
# the call that sums its h cotangent's last term
_K3_STEP = ("bwd_head", "bwd_gemm", "train_query", "att_bwd", "bwd_gemm",
            "bwd_gemm", "bwd_prenet")


@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_k3_loop_runs_each_cell_in_its_producer(regularization, monkeypatch):
    """The K3 loop in its new order, through the plain versions (the CPU
    route of the kernel wrappers): 7 wrapper calls a step, no standalone
    ``bwd_cell``; the generator cell rides on ``bwd_head`` and the
    attention cell on the dq @ Wq^T ``bwd_gemm`` (a zoneout or dropout cell
    at that step's salts, its previous c the forward's stream, None at the
    first step); and in that order the gradients match the JAX custom VJP
    at the file's bound (1e-4 of each tensor's largest value)."""
    calls = []

    def recorder(name, fn):
        def call(*args, **kw):
            calls.append((name, kw.get("cell")))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ftd, "KERNELS", ftd.SimpleNamespace(**{
        name: recorder(name, fn) for name, fn in vars(ftd.PLAIN).items()}))
    _check_backward_against_jax_vjp(regularization, 2)
    assert not any(name == "bwd_cell" for name, _ in calls)
    first = [name for name, _ in calls].index("bwd_head")   # K2 before it
    k3, n = calls[first:], len(_K3_STEP)
    assert len(k3) == FRAMES * n + 1 and k3[-1][0] == "bwd_gemm"   # dWq
    steps = [k3[i * n:(i + 1) * n] for i in range(FRAMES)]
    cfg = _port_cfg(_hp(regularization))
    seeds = _inputs(_hp(regularization), 0.5)[-1]
    for s, step in zip(range(FRAMES - 1, -1, -1), steps):
        assert tuple(name for name, _ in step) == _K3_STEP
        cells = {i: c for i, (_, c) in enumerate(step) if c is not None}
        assert sorted(cells) == [0, 4]
        for i, which in ((0, "gen"), (4, "att")):
            assert cells[i].reg == cfg.reg(which, seeds, s)
            assert (cells[i].c_prev is None) == (s == 0)


def _operands(hp, cfg, seed=0):
    cell = _port_cell(hp, _cell_params(hp, seed))
    return {k: v.detach().clone().requires_grad_()
            for k, v in ftd.train_operands(cell, cfg).items()}


@pytest.mark.parametrize("regularization,n_prenet",
                         [("zoneout", 2), ("dropout", 1)])
def test_plain_backward_matches_autograd(regularization, n_prenet):
    """Plain K3 (``TrainDecode.backward``) against ``torch.autograd.grad``
    through plain K2 written in differentiable ops: every operand, memory
    and memory-transform gradient within 1e-4 of its largest value."""
    hp = _hp(regularization, n_prenet)
    cfg = _port_cfg(hp)
    ops = _operands(hp, cfg)
    memory, mt, mask, shifted, teacher, _, seeds = _inputs(hp, 0.5)
    mem = torch.as_tensor(memory).requires_grad_()
    mtb = torch.as_tensor(mt).requires_grad_()
    mask_add = torch.where(torch.as_tensor(mask), 0.0, -1e9)
    sh = torch.as_tensor(shifted).transpose(0, 1).contiguous()
    cts = [torch.as_tensor(c) for c in _cotangents(hp)]
    cts = [cts[0].transpose(0, 1), cts[1].t(), cts[2].transpose(0, 1)]
    inputs = [mem, mtb] + [ops[k] for k in ftd.OPERAND_KEYS]

    def loss_of(outs):
        return sum((o * c).sum() for o, c in zip(outs, cts))

    ref = torch.autograd.grad(loss_of(ftd.train_decode_forward_plain(
        ops, cfg, mem, mtb, mask_add, sh, teacher.tolist(), seeds)), inputs)
    got = torch.autograd.grad(loss_of(ftd.TrainDecode.apply(
        cfg, tuple(teacher.tolist()), seeds, mem, mtb, mask_add, sh,
        *[ops[k] for k in ftd.OPERAND_KEYS])), inputs)
    for name, g, r in zip(["memory", "mtb", *ftd.OPERAND_KEYS], got, ref):
        scale = float(r.abs().max()) + 1e-6
        assert float((g - r).abs().max()) / scale < 1e-4, name


@pytest.mark.parametrize("ratio", [1.0, 0.0])
def test_stream_driver_equals_plain_forward(ratio):
    """The kernel driver (its wrappers run their plain versions on the CPU)
    gives the pure plain forward's outputs, and its residual streams hold
    the concat rows the gate products read."""
    hp = _hp()
    cfg = _port_cfg(hp)
    ops = {k: v.detach() for k, v in _operands(hp, cfg).items()}
    memory, mt, mask, shifted, teacher, _, seeds = _inputs(hp, ratio)
    args = (ops, cfg, torch.as_tensor(memory), torch.as_tensor(mt),
            torch.where(torch.as_tensor(mask), 0.0, -1e9),
            torch.as_tensor(shifted).transpose(0, 1).contiguous(),
            teacher.tolist(), seeds)
    st, carry = ftd.train_decode_forward(*args)
    ref = ftd.train_decode_forward_plain(*args)
    for k, r in zip(("spec", "stop", "w"), ref):
        torch.testing.assert_close(st[k], r, atol=1e-6, rtol=0)
    h, p, mem = cfg.hidden, cfg.prenet_dim, cfg.mem_dim
    torch.testing.assert_close(st["att_in"][1:, :, p:p + mem],
                               st["gen_in"][:-1, :, h:h + mem])
    torch.testing.assert_close(st["gen_in"][1:, :, h + mem:2 * h + mem],
                               st["head_in"][:-1, :, :h])
    torch.testing.assert_close(carry["frame"], st["spec"][-1])


# ---------------------------------------------------------------------------
# the eval/GTA forward: K2 with train=False
# ---------------------------------------------------------------------------

def _port_cfg_eval(hp):
    return ftd.TrainConfig.from_hp(port_hp(hp), MEM, torch.float32,
                                   train=False)


@functools.lru_cache(maxsize=None)
def _jax_forward_eval(regularization, n_prenet, ratio):
    hp = _hp(regularization, n_prenet)
    memory, mt, mask, shifted, teacher, key, _ = _inputs(hp, ratio)
    decode = ptd.make_train_decode_fn(hp, dtype=jnp.float32, interpret=True,
                                      fwd_chunk=4, bwd_chunk=3, train=False)
    out = decode(jax.tree_util.tree_map(jnp.asarray, _cell_params(hp)),
                 jnp.asarray(memory), jnp.asarray(mt), jnp.asarray(mask),
                 jnp.asarray(shifted), jnp.asarray(teacher), key)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("ratio", [1.0, 0.5])
@pytest.mark.parametrize("n_prenet", [1, 2])
@pytest.mark.parametrize("regularization", ["zoneout", "dropout"])
def test_eval_forward_matches_interpret_kernel(regularization, n_prenet,
                                               ratio):
    """The eval forward (``TrainConfig.train`` False: zoneout interpolated,
    a dropout cell's h left alone, prenet dropout 0.5 still on) against
    interpret-mode K2 built with ``train=False``: spec, stop and attention
    weights within atol 2e-5, as the train-mode forward test.  It differs
    from the train-mode forward by far more than that."""
    hp = _hp(regularization, n_prenet)
    cell = _port_cell(hp, _cell_params(hp))
    memory, mt, mask, shifted, teacher, _, seeds = _inputs(hp, ratio)
    args = (torch.as_tensor(memory), torch.as_tensor(mt),
            torch.as_tensor(mask), torch.as_tensor(shifted), teacher.tolist(),
            seeds)
    got = ftd.decode(cell, _port_cfg_eval(hp), *args)
    ref = _jax_forward_eval(regularization, n_prenet, ratio)
    for g, r, name in zip(got, ref, ("spec", "stop", "alignment")):
        np.testing.assert_allclose(to_np(g), r, atol=2e-5, err_msg=name)
    with torch.no_grad():
        train = ftd.decode(cell, _port_cfg(hp), *args)
    assert np.abs(to_np(train[0]) - ref[0]).max() > 1e-3


@pytest.mark.parametrize("n_prenet", [1, 2])
def test_eval_forward_keeps_prenet_dropout_bit_exact(n_prenet):
    """Eval mode leaves the prenet's dropout on: each layer's dropped units
    at a step are the JAX kernels' draws at that step's salt, bit for bit
    (zero weights and unit biases, so that no ReLU zeroes a unit)."""
    hp = _hp("zoneout", n_prenet)
    cfg = _port_cfg_eval(hp)
    jcfg = ptd._make_cfg(hp, t_len=T, mem_dim=MEM,
                         att_dim=hp.attention_dimension, dtype=jnp.float32,
                         train=False)
    ops = {k: v.detach() for k, v in _operands(hp, cfg).items()}
    ops["pre_w"] = torch.zeros_like(ops["pre_w"])
    ops["pre_b"] = torch.ones_like(ops["pre_b"])
    seeds = (2654435761, 40503)
    rng = np.random.RandomState(n_prenet)
    frame = torch.as_tensor(rng.randn(B, cfg.mmel).astype(np.float32))
    thresh = ptd._thresh(1.0 - jcfg.dropout_rate)
    for gs in (0, 6):
        pre = torch.zeros(cfg.n_prenet, B, cfg.prenet_dim)
        ftd.train_prenet(frame, frame, 1, ops, cfg, seeds, gs, None, pre,
                         torch.zeros(B, cfg.prenet_dim))
        for layer in range(cfg.n_prenet):
            ref = np.asarray(pallas_decoder._rand_bits(
                (B, cfg.prenet_dim), jnp.uint32(seeds[0]),
                jnp.uint32(seeds[1]),
                jnp.asarray(gs * jcfg.salt_sites + layer, jnp.int32))) >= thresh
            np.testing.assert_array_equal(to_np(pre[layer] == 0), ref)


def test_eval_forward_keeps_no_streams_and_no_graph():
    """An eval forward allocates and returns no residual stream (spec, stop
    and weights only), equals the differentiable plain K2 run with the same
    eval config, and carries no ``grad_fn`` even from inputs that require
    gradients; ``TrainDecode`` refuses it, as the JAX eval forward has no
    VJP."""
    hp = _hp("zoneout", 2)
    cfg = _port_cfg_eval(hp)
    ops = {k: v.detach() for k, v in _operands(hp, cfg).items()}
    memory, mt, mask, shifted, teacher, _, seeds = _inputs(hp, 0.5)
    args = (ops, cfg, torch.as_tensor(memory), torch.as_tensor(mt),
            torch.where(torch.as_tensor(mask), 0.0, -1e9),
            torch.as_tensor(shifted).transpose(0, 1).contiguous(),
            teacher.tolist(), seeds)
    st, carry = ftd.train_decode_forward(*args)
    assert set(st) == {"spec", "stop", "w"}
    for k, r in zip(("spec", "stop", "w"),
                    ftd.train_decode_forward_plain(*args)):
        torch.testing.assert_close(st[k], r, atol=1e-6, rtol=0)
    torch.testing.assert_close(carry["frame"], st["spec"][-1])

    cell = _port_cell(hp, _cell_params(hp))
    mem_t = torch.as_tensor(memory).requires_grad_()
    out = ftd.decode(cell, cfg, mem_t, torch.as_tensor(mt),
                     torch.as_tensor(mask), torch.as_tensor(shifted),
                     teacher.tolist(), seeds)
    assert all(o.grad_fn is None and not o.requires_grad for o in out)
    with pytest.raises(ValueError, match="eval"):
        ftd.TrainDecode.apply(cfg, tuple(teacher.tolist()), seeds, *args[2:6],
                              *[ops[k] for k in ftd.OPERAND_KEYS])


@pytest.mark.parametrize("attention_type", ["location_sensitive", "forward",
                                            "forward_transition_agent"])
def test_float32_dispatch_names_the_f32_instances(attention_type):
    """A float32 ``TrainConfig`` names the kernels' float32 instances, the
    ``LAUNCHES`` keys a card run counts them under: ``path_kernels(kind,
    float32)`` is the bf16 path with ``_f32`` on every name; the CPU runs
    the plain versions and counts no launch."""
    hp = port_hp(tiny_hp(attention_type=attention_type))
    cfg = ftd.TrainConfig.from_hp(hp, 24, torch.float32)
    k2, k3 = cfg.kernels
    assert (k2, k3) == ftd.path_kernels(cfg.att_kind, torch.float32)
    b2, b3 = ftd.path_kernels(cfg.att_kind)
    assert list(k2 + k3) == [k + "_f32" for k in b2 + b3]
    assert set(k2 + k3) <= set(ftd.LAUNCHES)
    att = "train_attention_fwd" if cfg.family else "train_attention"
    assert ftd.instance(att, torch.float32) in k2
    ftd.reset_launch_counts()
    b, t = 2, 5
    state = ftd.initial_state(cfg, b, t, "cpu")
    ftd.train_attention(torch.zeros(b, cfg.att_dim), state["cum"],
                        torch.zeros(b, t, 24), torch.zeros(b, t, cfg.att_dim),
                        torch.zeros(b, t), None if cfg.family else torch.zeros(
                            cfg.taps, cfg.att_dim), torch.zeros(cfg.att_dim),
                        torch.zeros(b, t), None, torch.zeros(b, 24),
                        (torch.zeros(b, 24),) * 2 + (None,),
                        agent=ftd.AgentArgs(
                            state["tp"], None, torch.zeros(b, cfg.hidden),
                            torch.zeros(b, cfg.prenet_dim),
                            torch.zeros(24 + cfg.hidden + cfg.prenet_dim),
                            torch.zeros(1)) if cfg.agent else None)
    assert not any(ftd.LAUNCHES.values())
