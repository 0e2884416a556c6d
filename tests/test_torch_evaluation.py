"""The port's ``evaluation/`` against the JAX package's, on the CPU.

Mirrors ``tests/test_evaluation.py`` with both packages on the same
inputs: Levenshtein counts, CER, cleaning and confidence intervals equal;
the MCD of two spectrograms, the per-language MCD and CER pipelines and
their written reports equal (the MCD within rtol 1e-6: the port's DTW and
DCT are its own copies, float32 sums in the same order); the ASR plumbing
with an injected local recognizer writes the same JSON files.  No test
calls a network service.
"""

import json
import os
import sys

import numpy as np
import pytest

from multilingual_text_to_speech_tpu.evaluation import asr as jax_asr
from multilingual_text_to_speech_tpu.evaluation import cer as jax_cer
from multilingual_text_to_speech_tpu.evaluation import mcd as jax_mcd
from multilingual_text_to_speech_tpu_torch.evaluation import asr, cer, mcd
from multilingual_text_to_speech_tpu_torch.ops.io import save_wav

PAIRS = [("kitten", "sitting"), ("abc", "abc"), ("", "abc"), ("abc", ""),
         ("hallo welt", "hallo wellt"), ("guten tag", "guten takk"),
         ("ab", "abcd"), ("über straße", "uber strasse")]


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_levenshtein_and_cer_match_jax(ref, hyp):
    assert cer.levenshtein(ref, hyp) == jax_cer.levenshtein(ref, hyp)
    if ref:
        assert cer.sample_cer(ref, hyp) == jax_cer.sample_cer(ref, hyp)


def test_levenshtein_counts():
    dist, (s, d, i) = cer.levenshtein("kitten", "sitting")
    assert (dist, s, d, i) == (3, 2, 0, 1)
    assert cer.sample_cer("abcd", "abce") == 0.25


@pytest.mark.parametrize("case_sensitive", [False, True])
@pytest.mark.parametrize("remove_punctuation", [False, True])
def test_clean_matches_jax(case_sensitive, remove_punctuation):
    for text in ("  Hello,   World! ", "Guten Tag. Wie geht's?",
                 "«Bonjour» — ça va ?"):
        assert cer.clean(text, case_sensitive, remove_punctuation) == \
            jax_cer.clean(text, case_sensitive, remove_punctuation)


@pytest.mark.parametrize("data", [[0.1, 0.2, 0.15, 0.12, 0.18], [1.0, 3.0],
                                  list(np.linspace(0, 1, 17))])
def test_confidence_interval_matches_jax(data):
    assert cer.confidence_interval(data) == jax_cer.confidence_interval(data)
    lo, hi = cer.confidence_interval(data)
    assert lo < np.mean(data) < hi


@pytest.mark.parametrize("frames", [(40, 40), (30, 37)])
def test_mcd_specs_match_jax(frames):
    rng = np.random.RandomState(frames[1])
    s1 = rng.randn(80, frames[0]).astype(np.float32) * 10
    s2 = rng.randn(80, frames[1]).astype(np.float32) * 10
    got = mcd.mel_cepstral_distortion_specs(s1, s2)
    assert got == pytest.approx(jax_mcd.mel_cepstral_distortion_specs(s1, s2),
                                rel=1e-6)
    assert mcd.mel_cepstral_distortion_specs(s1, s1) == pytest.approx(
        0.0, abs=1e-4)


def _make_eval_tree(root, language="german", model="mymodel"):
    os.makedirs(os.path.join(root, "all_meta_files"), exist_ok=True)
    with open(os.path.join(root, "all_meta_files", f"{language}.txt"), "w",
              encoding="utf-8") as f:
        print("000001|hallo welt|", file=f)
        print("000002|guten tag|", file=f)
        print("000003|wie geht es|", file=f)
    return root


def _asr_json(root, idx, text):
    d = os.path.join(root, "mymodel", "asr", "german")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{idx}.json"), "w", encoding="utf-8") as f:
        json.dump([{"alternatives": [{"transcript": text}]}], f)


def test_cer_pipeline_matches_jax(tmp_path):
    """``evaluate_language`` (a missing transcript skipped) and
    ``write_report``: the same list and the same report, byte for byte."""
    root = _make_eval_tree(str(tmp_path))
    _asr_json(root, "000001", "hallo welt")
    _asr_json(root, "000002", "guten takk")
    got = cer.evaluate_language("german", "mymodel", root)
    assert got == jax_cer.evaluate_language("german", "mymodel", root)
    assert [i for i, _ in got] == ["000001", "000002"]
    assert got[0][1] == 0.0 < got[1][1]
    cer.write_report(got, str(tmp_path / "port.txt"), "CER")
    jax_cer.write_report(got, str(tmp_path / "jax.txt"), "CER")
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text()
    assert "Total mean CER" in text and "Conf. interval" in text


def test_mcd_pipeline_and_main_match_jax(tmp_path):
    """``evaluate_language`` over a model's spectrograms against the
    ground truth, then ``main`` writing ``<model>/mcd/<language>.txt``:
    the same values (rtol 1e-6) and reports of the same lines."""
    root = _make_eval_tree(str(tmp_path))
    rng = np.random.RandomState(0)
    gt_dir = os.path.join(root, "ground-truth", "spectrograms")
    gen_dir = os.path.join(root, "mymodel", "spectrograms", "german")
    os.makedirs(gt_dir)
    os.makedirs(gen_dir)
    for idx, n in (("000001", 30), ("000002", 41)):
        ref = rng.randn(80, n).astype(np.float32)
        np.save(os.path.join(gt_dir, f"{idx}.npy"), ref)
        np.save(os.path.join(gen_dir, f"{idx}.npy"),
                ref[:, :n - 3] + rng.randn(80, n - 3).astype(np.float32) * 0.1)
    got = mcd.evaluate_language("german", "mymodel", root)
    ref = jax_mcd.evaluate_language("german", "mymodel", root)
    assert [i for i, _ in got] == [i for i, _ in ref] == ["000001", "000002"]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-6)
    assert all(0 < v < 5 for _, v in got)
    report = os.path.join(root, "mymodel", "mcd", "german.txt")
    jax_mcd.main(["--language", "german", "--model", "mymodel",
                  "--where", root])
    ref_lines = open(report, encoding="utf-8").read().splitlines()
    mcd.main(["--language", "german", "--model", "mymodel", "--where", root])
    got_lines = open(report, encoding="utf-8").read().splitlines()
    assert len(got_lines) == len(ref_lines)
    for g, r in zip(got_lines, ref_lines):
        gs, rs = g.split(), r.split()
        assert len(gs) == len(rs)
        for a, b in zip(gs, rs):
            try:
                assert float(a) == pytest.approx(float(b), rel=1e-5)
            except ValueError:
                assert a == b


def test_asr_plumbing_with_local_recognizer(tmp_path):
    """``transcribe_language`` with an injected recognizer: the same
    count and JSON files as the JAX package's, a missing wav skipped, a
    ``None`` result not written, and the CER scorer reads them."""
    outs = {}
    for name, module, cer_module in (("port", asr, cer),
                                     ("jax", jax_asr, jax_cer)):
        root = _make_eval_tree(str(tmp_path / name))
        wav_dir = os.path.join(root, "mymodel", "audios", "german")
        os.makedirs(wav_dir)
        for idx in ("000001", "000002"):
            save_wav(np.zeros(1000, np.float32),
                     os.path.join(wav_dir, f"{idx}.wav"), 22050)
        seen = []

        def recognize(path, code, sr, seen=seen):
            seen.append((os.path.basename(path), code, sr))
            if path.endswith("000002.wav"):
                return None
            return [{"alternatives": [{"transcript": "hallo welt"}]}]

        n = module.transcribe_language("german", "mymodel", root,
                                       recognize_fn=recognize)
        asr_dir = os.path.join(root, "mymodel", "asr", "german")
        files = {f: open(os.path.join(asr_dir, f), encoding="utf-8").read()
                 for f in sorted(os.listdir(asr_dir))}
        outs[name] = (n, seen, files, cer_module.evaluate_language(
            "german", "mymodel", root))
    assert outs["port"] == outs["jax"]
    n, seen, files, cers = outs["port"]
    assert n == 1 and list(files) == ["000001.json"]
    assert seen == [("000001.wav", "de-DE", 22050),
                    ("000002.wav", "de-DE", 22050)]
    assert cers == [("000001", 0.0)]


def test_google_client_stays_optional():
    """Importing the module loads no Google client: it is imported only
    inside ``google_cloud_recognize``, the default recognizer; the
    language codes are the JAX package's."""
    assert asr.LANGUAGE_CODES == jax_asr.LANGUAGE_CODES
    assert "google.cloud.speech_v1" not in sys.modules
    assert asr.transcribe_language.__defaults__[-1] is \
        asr.google_cloud_recognize
