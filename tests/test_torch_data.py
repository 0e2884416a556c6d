"""The port's data pipeline against the JAX package's, on the CPU.

Loaders, the three samplers (the same index lists from the same seeds,
epoch after epoch), ``Collate`` (bit-identical ``Batch`` arrays), the
datasets (items, speakers, normalization constants), ``create_meta_file``
and ``cli/prepare.py --fill_metafile`` (the same metafile text; caches
within ``SPEC_TOL``), ``prefetch`` and ``phonemize`` with the fake
backend of ``tests/test_phonemize.py``.  Spectrograms of the port run on
the CPU here (``device="cpu"``); without it they need the card.
"""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from multilingual_text_to_speech_tpu.cli import prepare as jax_prepare
from multilingual_text_to_speech_tpu.config import HParams as JaxHParams
from multilingual_text_to_speech_tpu.data import batching as jbatching
from multilingual_text_to_speech_tpu.data import dataset as jdataset
from multilingual_text_to_speech_tpu.data import loaders as jloaders
from multilingual_text_to_speech_tpu.data import prefetch as jprefetch
from multilingual_text_to_speech_tpu.data import sampling as jsampling
from multilingual_text_to_speech_tpu.text import phonemize as jph
from multilingual_text_to_speech_tpu_torch.cli import prepare as port_prepare
from multilingual_text_to_speech_tpu_torch.config import HParams
from multilingual_text_to_speech_tpu_torch.data import batching, dataset
from multilingual_text_to_speech_tpu_torch.data import loaders
from multilingual_text_to_speech_tpu_torch.data import prefetch as pprefetch
from multilingual_text_to_speech_tpu_torch.data import sampling
from multilingual_text_to_speech_tpu_torch.text import phonemize as ph
from multilingual_text_to_speech_tpu_torch.training import trainer
from tests.corpus_utils import make_css10_corpus

# dB spectrograms of the same waveform, torch.stft against jnp.fft on the
# CPU, compared as tests/test_torch_dsp.py does: their amplitudes
# 10 ** (dB / 20) within SPEC_TOL of the largest (float32 transforms in
# another order; near the -80 dB floor a few 1e-3 dB apart)
SPEC_TOL = 1e-5
LANGS = ["german", "french"]


def _hps(**over):
    jhp = JaxHParams()
    jhp.languages = list(LANGS)
    jhp.multi_language = True
    jhp.multi_speaker = True
    jhp.case_sensitive = False
    for k, v in over.items():
        setattr(jhp, k, v)
    return jhp, HParams.from_state_dict(jhp.state_dict())


def _close_spectrograms(got, ref, what):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    a, b = 10.0 ** (got / 20.0), 10.0 ** (ref / 20.0)
    assert np.abs(a - b).max() <= SPEC_TOL * np.abs(b).max(), what


def _metafile(root, name):
    with open(os.path.join(root, name), encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same CSS10-layout corpus twice, a metafile and caches made by
    each package's ``create_meta_file``, split into train/val."""
    jroot = str(tmp_path_factory.mktemp("jax_corpus"))
    make_css10_corpus(jroot, n_per_lang=6)
    proot = str(tmp_path_factory.mktemp("port_corpus"))
    shutil.copytree(jroot, proot, dirs_exist_ok=True)
    jhp, php = _hps()
    jdataset.create_meta_file("css10", jroot, "all.txt", jhp, 22050, 1102,
                              spectrograms=True, phonemes=False)
    dataset.create_meta_file("css10", proot, "all.txt", php, 22050, 1102,
                             spectrograms=True, phonemes=False, device="cpu")
    for root in (jroot, proot):
        lines = _metafile(root, "all.txt").splitlines()
        for name, keep in (("train.txt", lambda i: i % 3 != 2),
                           ("val.txt", lambda i: i % 3 == 2)):
            with open(os.path.join(root, name), "w", encoding="utf-8") as f:
                f.write("\n".join(l for i, l in enumerate(lines) if keep(i))
                        + "\n")
    return jroot, proot


def test_create_meta_file_matches_jax(corpora):
    jroot, proot = corpora
    text = _metafile(proot, "all.txt")
    assert text == _metafile(jroot, "all.txt")
    assert len(text.splitlines()) == 12
    for line in text.splitlines():
        for col in line.split("|")[4:6]:
            _close_spectrograms(np.load(os.path.join(proot, col)),
                                np.load(os.path.join(jroot, col)), col)


def test_fill_metafile_matches_jax(corpora, tmp_path):
    """``--fill_metafile`` through both CLIs on a metafile without cache
    columns: the same rewritten metafile, caches within SPEC_TOL."""
    jroot, proot = corpora
    bare = "\n".join("|".join(l.split("|")[:4] + ["", ""] + l.split("|")[6:])
                     for l in _metafile(jroot, "train.txt").splitlines())
    roots = {}
    for name, root in (("jax", jroot), ("port", proot)):
        dst = str(tmp_path / name)
        shutil.copytree(os.path.join(root, "german"),
                        os.path.join(dst, "german"))
        shutil.copytree(os.path.join(root, "french"),
                        os.path.join(dst, "french"))
        with open(os.path.join(dst, "meta.txt"), "w", encoding="utf-8") as f:
            f.write(bare + "\n")
        roots[name] = dst
    jax_prepare.main(["--fill_metafile", os.path.join(roots["jax"],
                                                      "meta.txt"),
                      "--root", roots["jax"]])
    port_prepare.main(["--fill_metafile", os.path.join(roots["port"],
                                                       "meta.txt"),
                       "--root", roots["port"], "--cpu"])
    text = _metafile(roots["port"], "meta.txt")
    assert text == _metafile(roots["jax"], "meta.txt")
    for line in text.splitlines():
        for col in line.split("|")[4:6]:
            _close_spectrograms(np.load(os.path.join(roots["port"], col)),
                                np.load(os.path.join(roots["jax"], col)), col)


def test_prepare_cli_needs_the_card_unless_asked(corpora, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_prepare.main(["--dataset", "css10", "--root", str(tmp_path)])


@pytest.mark.parametrize("loader", ["css10", "my_common_voice", "ljspeech"])
def test_loaders_match_jax(loader, tmp_path, corpora):
    """Each loader's rows on a tree of its layout (the CSS10 corpus, and
    small CommonVoice and LJ Speech trees of empty wavs)."""
    root = corpora[0]
    if loader == "my_common_voice":
        root = str(tmp_path)
        for lang in ("de", "fr"):
            os.makedirs(os.path.join(root, lang, "wavs", "07"))
            with open(os.path.join(root, lang, "meta.csv"), "w",
                      encoding="utf-8") as f:
                for i in range(3):
                    open(os.path.join(root, lang, "wavs", "07", f"{i}.wav"),
                         "w").close()
                    f.write(f"07|{i}.wav|satz {i} {lang}\n")
    elif loader == "ljspeech":
        root = str(tmp_path)
        os.makedirs(os.path.join(root, "wavs"))
        with open(os.path.join(root, "metadata.csv"), "w",
                  encoding="utf-8") as f:
            for i in range(3):
                open(os.path.join(root, "wavs", f"LJ{i}.wav"), "w").close()
                f.write(f"LJ{i}|raw {i}|Text {i}.\n")
    rows = loaders.get_loader_by_name(loader)(root)
    assert rows and rows == jloaders.get_loader_by_name(loader)(root)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_simple_sampler_matches_jax(shuffle, drop_last):
    args = (23, 5)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3)
    ref = jsampling.SimpleBatchSampler(*args, **kw)
    got = sampling.SimpleBatchSampler(*args, **kw)
    for _ in range(3):      # epoch after epoch: the same RNG stream
        assert list(got) == list(ref)
    assert len(got) == len(ref)


@pytest.mark.parametrize("drop_last", [True, False])
def test_balanced_sampler_matches_jax(drop_last):
    langs = list(np.random.RandomState(0).randint(0, 3, 40))
    ref = jsampling.BalancedBatchSampler(langs, 6, drop_last=drop_last,
                                         seed=7)
    got = sampling.BalancedBatchSampler(langs, 6, drop_last=drop_last,
                                        seed=7)
    for _ in range(3):
        assert list(got) == list(ref)
    assert len(got) == len(ref)


@pytest.mark.parametrize("shards,shuffle,drop_last", [
    (1, True, True), (1, False, False), (2, True, False), (2, False, True)])
def test_perfect_sampler_matches_jax(shards, shuffle, drop_last):
    langs = list(np.random.RandomState(1).randint(0, 3, 50))
    args = (langs, 3, 12)
    kw = dict(data_parallel_shards=shards, shuffle=shuffle,
              drop_last=drop_last, seed=5)
    ref = jsampling.PerfectBatchSampler(*args, **kw)
    got = sampling.PerfectBatchSampler(*args, **kw)
    for _ in range(3):
        lists = list(got)
        assert lists and lists == list(ref)
    assert len(got) == len(ref)


def test_perfect_sampler_refuses_what_jax_refuses():
    for mod in (jsampling, sampling):
        with pytest.raises(AssertionError):
            mod.PerfectBatchSampler([0, 1] * 5, 2, 5)


@pytest.mark.parametrize("sort", [False, True])
def test_collate_is_bit_identical_to_jax(sort):
    """Random items (ragged texts and frames, speakers, languages, linear
    spectrograms) through both collates at two bucket sizes."""
    rng = np.random.RandomState(2)
    jhp, php = _hps(predict_linear=True, bucket_text_multiple=16,
                    bucket_frame_multiple=32, num_mels=20, num_fft=62)
    items = []
    for i in range(5):
        n, f = rng.randint(3, 40), rng.randint(4, 70)
        items.append((i % 3, i % 2, list(rng.randint(3, 50, n)),
                      rng.randn(f, 20).astype(np.float32),
                      rng.randn(f, 32).astype(np.float32)))
    ref = jbatching.Collate(jhp, sort_by_text_length=sort)(items)
    got = batching.Collate(php, sort_by_text_length=sort)(items)
    assert type(got) is trainer.Batch      # trainer re-exports data's Batch
    for field in ref._fields:
        r, g = getattr(ref, field), getattr(got, field)
        assert g.dtype == r.dtype and np.array_equal(g, r), field


def test_datasets_and_batches_match_jax(corpora):
    """Both packages' collections on the JAX-made corpus: items, speakers,
    normalization constants, and the batches of ``batch_iterator`` under a
    perfect sampler, bit for bit (the caches are the same files)."""
    jroot, _ = corpora
    jhp, php = _hps()
    ref = jdataset.TextToSpeechDatasetCollection(jroot, jhp)
    got = dataset.TextToSpeechDatasetCollection(jroot, php, device="cpu")
    for a, b in ((ref.train, got.train), (ref.dev, got.dev)):
        assert b.items == a.items and b.unique_speakers == a.unique_speakers
        assert b.get_num_speakers() == a.get_num_speakers() == 2
        assert b.get_num_languages() == a.get_num_languages()
    for is_mel in (True, False):
        for r, g in zip(ref.train.get_normalization_constants(is_mel),
                        got.train.get_normalization_constants(is_mel)):
            assert g.shape == r.shape and np.array_equal(g, r)
    jhp.mel_normalize_mean, jhp.mel_normalize_variance = (
        ref.train.get_normalization_constants(True))
    php.mel_normalize_mean, php.mel_normalize_variance = (
        jhp.mel_normalize_mean, jhp.mel_normalize_variance)
    langs = [it["language"] for it in got.train.items]
    ref_b = jbatching.batch_iterator(
        ref.train, jsampling.PerfectBatchSampler(langs, 2, 4, seed=1),
        jbatching.Collate(jhp))
    got_b = batching.batch_iterator(
        got.train, sampling.PerfectBatchSampler(langs, 2, 4, seed=1),
        batching.Collate(php))
    n = 0
    for r, g in zip(ref_b, got_b):
        for field in r._fields:
            rv, gv = getattr(r, field), getattr(g, field)
            assert (rv is None and gv is None) or np.array_equal(gv, rv)
        n += 1
    assert n == 2


def test_uncached_spectrograms_match_jax(corpora):
    """``cache_spectrograms`` off: the spectrogram computed from the audio
    (the port's on the CPU here), normalized by the same constants."""
    jroot, _ = corpora
    jhp, php = _hps(cache_spectrograms=False, normalize_spectrogram=False)
    ref = jdataset.TextToSpeechDataset(os.path.join(jroot, "train.txt"),
                                       jroot, jhp)
    got = dataset.TextToSpeechDataset(os.path.join(jroot, "train.txt"),
                                      jroot, php, device="cpu")
    for i in (0, 3):
        _close_spectrograms(got[i][3].T, ref[i][3].T, i)
    if not torch.cuda.is_available():   # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dataset.TextToSpeechDataset(os.path.join(jroot, "train.txt"),
                                        jroot, php)


def test_comvoi_five_field_form_matches_jax(tmp_path):
    """The corpus-inventory form ``id|speaker|language|audio|text``: the
    speaker suffixed with the language, no caches."""
    meta = tmp_path / "all.txt"
    meta.write_text("1|01|de|de/a.wav|Hallo Welt.\n"
                    "2|01|fr|fr/b.wav|Bonjour.\n"
                    "3|02|de|de/c.wav|Guten Tag.\n", encoding="utf-8")
    jhp, php = _hps(languages=["de", "fr"])
    ref = jdataset.TextToSpeechDataset(str(meta), str(tmp_path), jhp)
    got = dataset.TextToSpeechDataset(str(meta), str(tmp_path), php,
                                      device="cpu")
    assert got.items == ref.items
    assert got.unique_speakers == ref.unique_speakers == [
        "01-de", "01-fr", "02-de"]


def test_prefetch_keeps_order_and_passes_errors():
    assert list(pprefetch.prefetch(iter(range(50)), depth=2)) == list(
        jprefetch.prefetch(iter(range(50)), depth=2)) == list(range(50))
    assert list(pprefetch.prefetch(iter([]))) == []

    def failing():
        yield 1
        yield 2
        raise ValueError("corrupt cache")

    it = pprefetch.prefetch(failing())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(ValueError, match="corrupt cache"):
        next(it)

    # the producer runs ahead of the consumer, at most depth items
    produced = []
    gate = threading.Event()

    def producer():
        for i in range(10):
            produced.append(i)
            yield i
        gate.set()

    it = pprefetch.prefetch(producer(), depth=2)
    assert next(it) == 0
    assert gate.wait(0.2) is False and len(produced) <= 4
    assert list(it) == list(range(1, 10))


@pytest.fixture
def fake_backends(monkeypatch):
    """``tests/test_phonemize.py``'s fake: word -> '<WORD> ' (the trailing
    separator the callers strip), in both packages."""
    def fake(text, language):
        return f"<{text.upper()}> "

    monkeypatch.setattr(jph, "phonemize_word", fake)
    monkeypatch.setattr(ph, "phonemize_word", fake)


@pytest.mark.parametrize("text,lang,ignore", [
    ("hallo welt", "de", False), ("hallo, welt!", "de", False),
    ("jean-paul ok", "fr", False), ("  wie  geht's? gut.", "de", False),
    ("hallo welt", "de", True)])
def test_phonemize_matches_jax(fake_backends, text, lang, ignore):
    jhp, php = _hps()
    assert ph.to_phoneme(text, ignore, lang, php) == jph.to_phoneme(
        text, ignore, lang, jhp)
    pairs = [(text, lang), ("noch mehr worte", "fr")]
    assert ph.build_phoneme_dicts(pairs, php) == jph.build_phoneme_dicts(
        pairs, jhp)


def test_phonemize_without_a_backend_raises_like_jax():
    if ph._HAS_PHONEMIZER or ph._HAS_EPITRAN:
        pytest.skip("a phonemization backend is installed")
    for mod in (jph, ph):
        with pytest.raises(RuntimeError, match="No phonemization backend"):
            mod.phonemize_word("hallo", "de")


def test_create_meta_file_with_phonemes_matches_jax(fake_backends,
                                                    tmp_path):
    """``phonemes=True`` (the metafile's last column through the fake
    backend), no spectrograms."""
    roots = {}
    for name in ("jax", "port"):
        roots[name] = str(tmp_path / name)
        make_css10_corpus(roots[name], n_per_lang=2)
    jhp, php = _hps()
    jdataset.create_meta_file("css10", roots["jax"], "all.txt", jhp, 22050,
                              1102, spectrograms=False, phonemes=True)
    dataset.create_meta_file("css10", roots["port"], "all.txt", php, 22050,
                             1102, spectrograms=False, phonemes=True)
    text = _metafile(roots["port"], "all.txt")
    assert text == _metafile(roots["jax"], "all.txt") and "<HALLO>" in text
