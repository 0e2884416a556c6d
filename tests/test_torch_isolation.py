"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, nor ``msgpack`` or ``flax`` (the machine with the card has
neither), and runs a tiny synthesis, a checkpoint round trip, a vocoding,
a tiny training step, and a corpus on disk through the prepare step, an
epoch of the ``Trainer``, its evaluation, checkpoint and resume and the
GTA export on the CPU with all of them blocked; every module imports."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "multilingual_text_to_speech_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"multilingual_text_to_speech_tpu\.",
    r"^\s*(import|from)\s+(msgpack|flax)\b",
])
def test_port_sources_do_not_reach_jax(pattern):
    hits = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for no, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{no}: {line}")
    assert not hits, "".join(hits)


def test_port_synthesizes_with_jax_blocked():
    script = textwrap.dedent("""
        import os, sys, tempfile
        for blocked in ("jax", "msgpack", "flax"):
            sys.modules[blocked] = None
        import numpy as np, torch
        from multilingual_text_to_speech_tpu_torch import (
            Synthesizer, flagship_hparams)
        from multilingual_text_to_speech_tpu_torch.models.tacotron import (
            Tacotron, init_random_weights)
        hp = flagship_hparams()
        for k, v in dict(embedding_dimension=16, encoder_dimension=16,
                         decoder_dimension=16, prenet_dimension=8,
                         attention_dimension=8, attention_kernel_size=5,
                         attention_location_dimension=4, postnet_dimension=8,
                         postnet_blocks=2, num_mels=20, generator_dim=4,
                         generator_bottleneck_dim=2, bucket_text_multiple=8,
                         bucket_frame_multiple=16, speaker_number=4,
                         compute_dtype="float32", max_output_length=16,
                         decode_chunk_frames=8).items():
            setattr(hp, k, v)
        hp.unique_speakers = ["a", "b", "c", "d"]
        hp.mel_normalize_mean = [0.0] * 20
        hp.mel_normalize_variance = [1.0] * 20
        sd = init_random_weights(Tacotron(hp), 0).state_dict()
        syn = Synthesizer(hp, sd, device="cpu")
        out = syn.synthesize_batch_lines(
            ["1|hallo|a|de", "2|salut|b|fr", "3|mix|c|de*0.5:ru*0.5"])
        assert all(o.shape[0] == 20 and np.isfinite(o).all() for o in out)
        hp.griffin_lim_iters = 2
        with tempfile.TemporaryDirectory() as tmp:
            from multilingual_text_to_speech_tpu_torch.training import (
                checkpoint)
            path = os.path.join(tmp, "ckpt")
            checkpoint.save_checkpoint(path, epoch=0, step=0, state_dict=sd,
                                       hp=hp, criterion_state={})
            restored = Synthesizer.from_checkpoint(path, device="cpu")
            again = restored.synthesize_batch_lines(
                ["1|hallo|a|de", "2|salut|b|fr", "3|mix|c|de*0.5:ru*0.5"])
            assert all(np.array_equal(a, o) for a, o in zip(again, out))
            wavs = restored.vocode_batch(again, seed=1)
            assert all(np.isfinite(w).all() for w in wavs)
        from multilingual_text_to_speech_tpu_torch.models.tacotron import (
            TacotronLossState)
        from multilingual_text_to_speech_tpu_torch.training import trainer
        model = Tacotron(hp)
        model.load_state_dict(sd)
        opt, sched = trainer.make_optimizer(model, hp)
        rng = np.random.RandomState(0)
        b, t, f = 5, 8, 6
        batch = trainer.Batch(
            rng.randint(3, hp.total_symbols(), (b, t)), np.full(b, t),
            rng.randn(b, f, 20).astype(np.float32), None, np.full(b, f),
            np.zeros((b, f), np.float32), rng.randint(0, 4, b),
            np.arange(b) % 5)
        res = trainer.train_step(model, opt, sched, batch,
                                 TacotronLossState.init(hp),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
        assert all(np.isfinite(float(v)) for v in res.losses.values())

        # every module of the package imports; a corpus on disk through
        # prepare, the Trainer (an epoch, evaluate, save, resume) and GTA
        import importlib, pkgutil
        import multilingual_text_to_speech_tpu_torch as pkg
        for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(info.name)
        from multilingual_text_to_speech_tpu_torch.cli import gta
        from multilingual_text_to_speech_tpu_torch.data import (
            TextToSpeechDatasetCollection, create_meta_file)
        from multilingual_text_to_speech_tpu_torch.ops.io import save_wav
        sys.modules["torch.utils.tensorboard"] = None
        hp.languages = ["de", "fr"]
        hp.speaker_number, hp.batch_size, hp.dataset = 0, 2, "corpus"
        hp.mel_normalize_mean = hp.mel_normalize_variance = None
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "corpus")
            for lang in hp.languages:
                os.makedirs(os.path.join(root, lang, "wavs"))
                with open(os.path.join(root, lang, "transcript.txt"), "w") as f:
                    for i in range(3):
                        save_wav(0.1 * rng.randn(2200 + 300 * i),
                                 os.path.join(root, lang, "wavs", f"{i}.wav"),
                                 22050)
                        print(f"wavs/{i}.wav|x|hallo {i}", file=f)
            create_meta_file("css10", root, "train.txt", hp, 22050, 1102,
                             phonemes=False, device="cpu")
            os.link(os.path.join(root, "train.txt"),
                    os.path.join(root, "val.txt"))
            data = TextToSpeechDatasetCollection(root, hp, device="cpu")
            tr = trainer.Trainer(hp, data, device="cpu", seed=0,
                                 checkpoint_dir=os.path.join(tmp, "ckpt"))
            assert tr.train_epoch() == 3
            path = tr.save(tr.evaluate())
            again = trainer.Trainer(hp, data, device="cpu", seed=0,
                                    from_checkpoint=path)
            assert (again.epoch, again.step) == (1, 3)
            gta.main(["--checkpoint", path, "--data_root", tmp, "--output",
                      os.path.join(tmp, "gta"), "--cpu"])
            assert len(os.listdir(os.path.join(tmp, "gta"))) == 6
        assert not any(m in ("jax", "msgpack", "flax") or m.startswith(
            ("jax.", "msgpack.", "flax.", "multilingual_text_to_speech_tpu."))
            for m in sys.modules if sys.modules[m] is not None)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
