"""The port's ``dataset_prepare/`` against the JAX package's, on the CPU.

Mirrors ``tests/test_prepare.py`` with both packages on the same inputs:
the CSS10 and M-AILABS normalizers give the same strings and rewrite the
same files byte for byte, the CommonVoice filter keeps and deletes the
same files and writes the same ``validated.tsv``, silence trimming writes
the same wavs at each file's own rate, and the romanizers run the same
line filters on fake backends.  ``common_voice.download`` needs the
network and is not called.
"""

import csv
import os
import shutil
import sys
import types

import numpy as np
import pytest

from multilingual_text_to_speech_tpu.dataset_prepare import (
    common_voice as jax_cv,
)
from multilingual_text_to_speech_tpu.dataset_prepare import (
    normalize as jax_norm,
)
from multilingual_text_to_speech_tpu.dataset_prepare import (
    romanize as jax_rom,
)
from multilingual_text_to_speech_tpu.dataset_prepare import trim as jax_trim
from multilingual_text_to_speech_tpu_torch.dataset_prepare import (
    common_voice,
    normalize,
    romanize,
    trim,
)
from multilingual_text_to_speech_tpu_torch.ops.io import (
    load_wav_with_rate,
    save_wav,
)

CSS10 = ["cœur—æther", "ja！so？", "！：；？", "l’été", "hallo , welt !!",
         "... leading dots", "end.  -  dash", "Ὁ ϊ ϋ ΐ « x »", "々ab·c"]
MAILABS = [".. hello ..", "- (quoted) -", "wait... what", "A -- b", "IV.",
           "Chapter 12 begins", "\"Yes,\" she said."]


@pytest.mark.parametrize("text", CSS10)
def test_css10_text_matches_jax(text):
    assert normalize.normalize_css10_text(text) == \
        jax_norm.normalize_css10_text(text)


@pytest.mark.parametrize("text", MAILABS)
def test_mailabs_text_matches_jax(text):
    assert normalize.normalize_mailabs_text(text) == \
        jax_norm.normalize_mailabs_text(text)


def test_normalizers_known_values():
    assert normalize.normalize_css10_text("cœur—æther") == "coeur-aether"
    assert normalize.normalize_css10_text("hallo , welt !!") == "hallo, welt!"
    assert normalize.normalize_mailabs_text("wait... what") == "wait- what"


def _twice(tmp_path, name, content, port_fn, jax_fn):
    """``content`` written to two files, each rewritten by one package:
    both return values and both files."""
    out = []
    for tag, fn in (("port", port_fn), ("jax", jax_fn)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        p = d / name
        p.write_text(content, encoding="utf-8")
        out.append((fn(str(p)), p.read_text(encoding="utf-8")))
    return out


def test_css10_transcript_matches_jax(tmp_path):
    got, ref = _twice(
        tmp_path, "transcript.txt",
        "a.wav|x|hallo , welt !!|3.2\nb.wav|x|...|1.0\nc.wav|x|guten tag|2.0\n"
        "d.wav|x|ja！so？|1.1\n",
        normalize.normalize_css10_transcript,
        jax_norm.normalize_css10_transcript)
    assert got == ref and got[0] == 3
    assert got[1].splitlines()[0] == "a.wav|x|hallo, welt!"


def test_mailabs_metadata_matches_jax(tmp_path):
    got, ref = _twice(
        tmp_path, "metadata.csv",
        "a|a|Hello there.\nb|b|IV.\nc|c|Chapter 12 begins\nd|d|Good night\n"
        "e|e|.. wait... what ..\n",
        normalize.normalize_mailabs_metadata,
        jax_norm.normalize_mailabs_metadata)
    assert got == ref and got[0] == 3


def _cv_tree(lang):
    clips = lang / "clips"
    clips.mkdir(parents=True)
    for name in ("k1.mp3", "k2.mp3", "bad.mp3", "stray.mp3"):
        (clips / name).write_bytes(b"\0")
    rows = [["client_id", "path", "sentence", "up_votes", "down_votes"],
            ["s1", "k1.mp3", "hello", "2", "0"],
            ["s2", "k2.mp3", "world", "1", "0"],
            ["s3", "bad.mp3", "noisy", "0", "2"]]
    with open(lang / "validated.tsv", "w", newline="", encoding="utf-8") as f:
        csv.writer(f, delimiter="\t").writerows(rows)
    (lang / "other.tsv").write_text("junk\n", encoding="utf-8")


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_common_voice_filter_matches_jax(tmp_path):
    results = []
    for tag, fn in (("port", common_voice.filter_language),
                    ("jax", jax_cv.filter_language)):
        lang = tmp_path / tag / "xx"
        _cv_tree(lang)
        kept = fn(str(lang))
        files = _listing(lang)
        results.append((kept, files, {
            f: (lang / f).read_bytes() for f in files if f.endswith(".tsv")}))
    assert results[0] == results[1]
    assert results[0][0] == 2
    assert sorted(os.listdir(tmp_path / "port" / "xx" / "clips")) == [
        "k1.mp3", "k2.mp3"]
    assert common_voice.DOWNLOAD_URLS == jax_cv.DOWNLOAD_URLS


@pytest.mark.parametrize("sr", [22050, 48000])
def test_trim_tree_matches_jax(tmp_path, sr):
    """Two wavs under nested folders at ``sr``: the same count and the same
    trimmed samples, each file keeping its own rate; a required rate that
    differs raises in both."""
    pad = np.zeros(sr // 2, np.float32)
    t = np.arange(sr) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    src = tmp_path / "src"
    (src / "a" / "wavs").mkdir(parents=True)
    save_wav(np.concatenate([pad, tone, pad]), str(src / "a" / "wavs" /
                                                   "x.wav"), sr)
    save_wav(np.concatenate([tone[:sr // 3], pad]), str(src / "y.wav"), sr)
    results = []
    for tag, fn in (("port", trim.trim_tree), ("jax", jax_trim.trim_tree)):
        root = tmp_path / tag
        shutil.copytree(src, root)
        n = fn(str(root))
        wavs = {f: load_wav_with_rate(str(root / f)) for f in _listing(root)}
        results.append((n, wavs))
        with pytest.raises(ValueError, match="sample rate"):
            fn(str(root), sample_rate=sr + 1)
    (n, got), (n_ref, ref) = results
    assert n == n_ref == 2 and set(got) == set(ref)
    for f in got:
        assert got[f][1] == ref[f][1] == sr
        np.testing.assert_array_equal(got[f][0], ref[f][0])
    x = got[os.path.join("a", "wavs", "x.wav")][0]
    assert len(tone) * 0.9 <= len(x) < len(tone) + 2 * len(pad)


def test_romanize_matches_jax_on_fake_backends(monkeypatch, capsys):
    fake_jieba = types.SimpleNamespace(cut=lambda s: s.split())
    fake_pinyin = types.SimpleNamespace(get=lambda w: f"p({w})")

    class FakeTagger:
        def __init__(self, mode):
            self.mode = mode

        def parse(self, s):
            return s.strip() + {"-Owakati": " W", "-Oyomi": " Y"}[self.mode]

    for name, mod in (("jieba", fake_jieba), ("pinyin", fake_pinyin),
                      ("MeCab", types.SimpleNamespace(Tagger=FakeTagger)),
                      ("romkan", types.SimpleNamespace(
                          to_roma=lambda s: f"r[{s}]"))):
        monkeypatch.setitem(sys.modules, name, mod)
    for line in ("ni hao\n", "zai jian  ma\n"):
        assert romanize.to_pinyin(line) == jax_rom.to_pinyin(line)
    assert romanize.to_pinyin("ni hao\n") == "p(ni) p(hao)"
    assert romanize.to_romaji("konnichiwa") == jax_rom.to_romaji(
        "konnichiwa") == "r[konnichiwa W Y]"
    outs = []
    for module in (romanize, jax_rom):
        for lang in ("zh", "ja"):
            monkeypatch.setattr(sys, "stdin", iter(["ni hao\n", "a b\n"]))
            module.main(["--lang", lang])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].startswith("p(ni) p(hao)\np(a) p(b)\n")
