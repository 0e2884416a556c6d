"""The port's data-parallel mesh and loss contributions on the CPU, in one
process.

The mesh (``parallel.make_mesh``) against JAX ``make_mesh`` on conftest's 8
virtual devices: its shape for ``mesh_data_parallel`` -1 and explicit,
``mesh_model_parallel`` 1 and 2, the assertion, and
``parallelization = False``.  Each rank's rows and seed index
(``Mesh.shard_rows``, ``Mesh.seed_index``) against where JAX puts the
global batch on the mesh's devices (rank ``r`` is the device at flat
position ``r`` of the JAX mesh, laid out here in reversed order so that
the position matters) and the index its decode folds in
(``models/decoder.py``'s ``axis_index`` arithmetic), for both schemes of
``Decoder._mesh_shard_batch``.  The loss terms' shard contributions with
explicit global denominators sum to the one-shard loss, values and
gradients, also where the reversal classifier's clamp bites (where a mean
per shard averaged over the shards does not).  Per-shard seeds are a pure
function of the step's seeds and the index, distinct by index, and a mesh
of one keeps the step's seeds.  ``parallel/`` runs with JAX blocked.
Exact up to float32 sums in another order: rtol 1e-6.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multilingual_text_to_speech_tpu.config import HParams as JaxHParams
from multilingual_text_to_speech_tpu.models.decoder import (
    Decoder as JaxDecoder,
)
from multilingual_text_to_speech_tpu.parallel import make_mesh as jax_mesh
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.models.classifier import (
    CosineSimilarityClassifier,
    ReversalClassifier,
    cosine_similarity_classifier_loss,
    reversal_classifier_loss,
)
from multilingual_text_to_speech_tpu_torch.models.tacotron import (
    _bce_with_logits_pos_weight,
    guided_attention_loss,
    shard_mean,
)
from multilingual_text_to_speech_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    shard_batch,
    shard_seeds,
)
from multilingual_text_to_speech_tpu_torch.training.trainer import (
    Batch,
    Draws,
)

RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hps(data, model, parallelization=True):
    out = []
    for cls in (JaxHParams, HParams):
        hp = cls()
        hp.mesh_data_parallel, hp.mesh_model_parallel = data, model
        hp.parallelization = parallelization
        out.append(hp)
    return out


@pytest.mark.parametrize("data,model,world,fits", [
    (-1, 1, 8, True), (-1, 2, 8, True), (2, 4, 8, True), (-1, 1, 1, True),
    (3, 1, 8, False), (-1, 3, 8, False)])
def test_mesh_shape_matches_jax(data, model, world, fits):
    jhp, php = _hps(data, model)
    devices = jax.devices()[:world]
    if not fits:
        with pytest.raises(AssertionError):
            jax_mesh(jhp, devices=devices)
        with pytest.raises(AssertionError):
            make_mesh(php, world=world, rank=0, device="cpu")
        return
    ref = jax_mesh(jhp, devices=devices)
    got = make_mesh(php, world=world, rank=world - 1, device="cpu")
    assert got.shape == dict(ref.shape)
    assert got.size == ref.size == world
    assert got.data_index == got.data - 1


def test_parallelization_false_pins_one_device():
    jhp, php = _hps(-1, 1, parallelization=False)
    assert jax_mesh(jhp, devices=jax.devices()[:8]).size == 1
    mesh = make_mesh(php, device="cpu")
    assert mesh.size == 1 and mesh.seed_index(50) is None
    with pytest.raises(ValueError, match="parallelization"):
        make_mesh(php, world=8, rank=3, device="cpu")


def _jax_layout(mesh, batch, axes):
    """Per flat mesh position: (rows of a [batch] array sharded over
    ``axes``, the index the decode folds in there)."""
    mp = mesh.shape["model"]

    def idx(x):
        i = jax.lax.axis_index("data")
        if axes == ("data", "model"):
            i = i * mp + jax.lax.axis_index("model")
        return i[None] + 0 * x[:1]

    x = jax.device_put(np.arange(batch), NamedSharding(mesh, P(axes)))
    out = jax.shard_map(idx, mesh=mesh, in_specs=P(axes), out_specs=P(axes),
                        check_vma=False)(x)
    rows = {s.device: np.asarray(s.data) for s in x.addressable_shards}
    folded = {s.device: int(np.asarray(s.data)[0])
              for s in out.addressable_shards}
    flat = list(mesh.devices.flat)
    return [(rows[d], folded[d]) for d in flat]


@pytest.mark.parametrize("batch,scheme", [(16, 1), (24, 1), (12, 2),
                                          (4, 2), (10, None)])
def test_rank_rows_and_seed_index_match_jax(batch, scheme):
    """A (data=4, model=2) mesh: a batch that divides 8 splits over every
    rank (scheme 1), one that divides only 4 over the data shards (scheme
    2), any other raises; rows and fold-in index per rank as JAX's."""
    jhp, php = _hps(-1, 2)
    mesh = jax_mesh(jhp, devices=jax.devices()[:8][::-1])
    per = JaxDecoder._mesh_shard_batch(mesh, batch)
    ranks = [Mesh(4, 2, r, torch.device("cpu")) for r in range(8)]
    if scheme is None:
        assert per is None
        for m in ranks:
            with pytest.raises(ValueError, match="divides neither"):
                m.shard_rows(batch)
        return
    axes = ("data", "model") if scheme == 1 else ("data",)
    for m, (rows, folded) in zip(ranks, _jax_layout(mesh, batch, axes)):
        got = np.arange(batch)[m.shard_rows(batch)]
        assert len(got) == per
        np.testing.assert_array_equal(got, rows)
        assert m.seed_index(batch) == folded


def test_shard_batch_takes_each_arrays_rows():
    rng = np.random.RandomState(0)
    b = 12
    batch = Batch(rng.randint(0, 9, (b, 5)), np.arange(b), rng.randn(b, 4, 3),
                  None, np.arange(b) + 1, rng.rand(b, 4), np.arange(b) % 3,
                  np.arange(b) % 2)
    got = shard_batch(batch, Mesh(2, 2, 3, torch.device("cpu")))
    assert got.linear_spectrograms is None
    for g, x in zip(got, batch):
        if x is not None:
            np.testing.assert_array_equal(g, x[9:12])
    # a mesh of one keeps the whole batch
    for g, x in zip(shard_batch(batch, make_mesh(device="cpu")), batch):
        assert g is x or np.array_equal(g, x)


def _halves(x):
    return x[:len(x) // 2], x[len(x) // 2:]


def _inputs(seed=0, b=6, t=9, speakers=5):
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, t + 1, (b,), generator=gen)
    lengths[1] = t
    spk = torch.randint(0, speakers, (b,), generator=gen)
    return gen, lengths, spk


@pytest.mark.parametrize("kind", ["reversal", "cosine"])
def test_classifier_contributions_sum_to_the_loss(kind):
    """Two shards' contributions (global valid count, global positions)
    sum to the one-shard loss, and their gradients, through the gradient
    reversal's or the clipping's clamp, to its gradient; a mean per shard
    averaged over the shards (a scaled loss under DDP) moves where the
    clamp bites."""
    gen, lengths, spk = _inputs()
    b, t, c, s = 6, 9, 7, 5
    x = torch.randn(b, t, c, generator=gen) * 3.0
    kernel = torch.randn(c, s, generator=gen)
    if kind == "reversal":
        clf = ReversalClassifier(c, 8, s, gradient_clipping_bounds=1e-3)
        torch.nn.init.normal_(clf.fc1.weight, std=2.0, generator=gen)
    else:
        clf = CosineSimilarityClassifier(c, s, gradient_clipping_bounds=1e-3)
        torch.nn.init.normal_(clf.fc.weight, std=2.0, generator=gen)
    mask = torch.arange(t)[None] < lengths[:, None]

    def loss(xx, ln, sp, count=None, positions=None):
        pred = clf(xx)
        if kind == "reversal":
            return reversal_classifier_loss(ln, sp, pred, count)
        return cosine_similarity_classifier_loss(ln, sp, pred, xx, kernel,
                                                 count, positions)

    def grads(fn):
        xx = x.clone().requires_grad_(True)
        value = fn(xx)
        value.backward()
        return value.detach(), xx.grad

    ref, g_ref = grads(lambda xx: loss(xx, lengths, spk))
    count, positions = mask.sum(), b * t
    got, g_got = grads(lambda xx: sum(
        loss(xh, lh, sh, count, positions) for xh, lh, sh in zip(
            _halves(xx), _halves(lengths), _halves(spk))))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL)
    np.testing.assert_allclose(g_got.numpy(), g_ref.numpy(), rtol=RTOL,
                               atol=1e-9)
    _, g_avg = grads(lambda xx: sum(
        loss(xh, lh, sh) for xh, lh, sh in zip(
            _halves(xx), _halves(lengths), _halves(spk))) / 2)
    assert not torch.allclose(g_avg, g_ref, rtol=1e-3)


def test_mean_and_guided_contributions_sum_to_the_loss():
    """The means (``shard_mean``, the stop BCE) over the global element
    count and the guided penalty over the global batch: the shards'
    contributions sum to the one-shard values, and so do their
    gradients."""
    gen, lengths, _ = _inputs(1)
    b, f, t = 6, 11, 9
    flens = torch.randint(2, f + 1, (b,), generator=gen)
    align = torch.rand(b, f, t, generator=gen).requires_grad_(True)
    logits = torch.randn(b, f, generator=gen).requires_grad_(True)
    target = (torch.rand(b, f, generator=gen) > 0.7).float()

    def terms(a, lg, tg, ln, fl, shards=1, rows=None):
        return torch.stack([
            shard_mean(lg ** 2, shards),
            _bce_with_logits_pos_weight(lg, tg, 100.0, shards),
            guided_attention_loss(a, ln, fl, 0.2, rows)])

    ref = terms(align, logits, target, lengths, flens)
    g_ref = torch.autograd.grad(ref.sum(), (align, logits))
    got = sum(terms(*parts, shards=2, rows=b) for parts in zip(
        *map(_halves, (align, logits, target, lengths, flens))))
    g_got = torch.autograd.grad(got.sum(), (align, logits))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(),
                               rtol=RTOL)
    for g, r in zip(g_got, g_ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                   atol=1e-9)


def test_shard_seeds_are_pure_distinct_and_kept_at_world_one():
    seeds = (123456789, 4000000000)
    got = [shard_seeds(seeds, i) for i in range(8)]
    assert got == [shard_seeds(seeds, i) for i in range(8)]
    assert len(set(got)) == 8 and seeds not in got
    assert all(0 <= s < 2 ** 32 for pair in got for s in pair)
    assert shard_seeds((seeds[1], seeds[0]), 0) != got[0]
    assert Draws(0).shard_seeds(seeds, 3) == got[3]
    # a mesh of one: no index, the step's seeds
    assert make_mesh(HParams(), device="cpu").seed_index(50) is None
    assert Mesh(2, 1, 1, torch.device("cpu")).seed_index(50) == 1


def test_parallel_runs_with_jax_blocked():
    """``parallel/`` without JAX: a one-rank gloo group through
    ``init_distributed``'s environment, its mesh, and every collective the
    identity."""
    script = textwrap.dedent("""
        import socket, sys
        sys.modules["jax"] = None
        import os, torch
        from multilingual_text_to_speech_tpu_torch import parallel
        from multilingual_text_to_speech_tpu_torch.config import HParams
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        dev = parallel.init_distributed(cpu=True)
        mesh = parallel.make_mesh(HParams(), device=dev)
        assert (mesh.size, mesh.backend, mesh.seed_index(8)) == (
            1, "gloo", None)
        x = torch.arange(4.0, requires_grad=True)
        assert parallel.all_sum(x, mesh) is x
        assert parallel.total(x, mesh) is x
        assert parallel.all_gather_rows(x, mesh, 4) is x
        torch.distributed.destroy_process_group()
        assert not any(m == "jax" or m.startswith(
            ("jax.", "multilingual_text_to_speech_tpu."))
            for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "backend gloo" in proc.stdout
    assert proc.stdout.strip().endswith("OK")
