"""Character error rate against ASR transcripts, with 95% CIs.

Port of the JAX package's ``evaluation/cer.py`` (the reference model's
``evaluation/cer_computer.py``): full Levenshtein
with per-operation counts, CER = (S+I+D)/len(ref), cleaning, and a
t-distribution confidence interval.  For Chinese/Japanese the romanized
(pinyin/romaji) field of the eval metafile is scored instead of the raw text
(cer_computer.py:96-99).

Usage:
    python -m multilingual_text_to_speech_tpu_torch.evaluation.cer \
        --language german --model generated --where eval_data
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import List, Tuple

import numpy as np
import scipy.stats

PUNCTUATIONS_OUT = '—「」、。，"(),.:;¿？：！《》“”?⑸¡!\\'
PUNCTUATIONS_IN = "'-"


def levenshtein(u: str, v: str) -> Tuple[int, Tuple[int, int, int]]:
    """Edit distance with (substitutions, deletions, insertions) counts.

    Numpy DP: each row of the [len(u)+1, len(v)+1] distance matrix is filled
    vectorized — deletion/substitution candidates come straight from the
    previous row, and the sequential insertion recurrence
    ``d[i,j] = min(base[j], d[i,j-1]+1)`` collapses into a prefix minimum of
    ``base - j`` (insertions add +1 per column, so shifting by the column
    index turns the running minimum into an ``accumulate``).  The op split
    is recovered by backtracking with the same preference order the
    reference uses (substitution, deletion, insertion;
    cer_computer.py:21-43), so counts match it exactly.
    """
    n, m = len(u), len(v)
    cols = np.arange(m + 1)
    mismatch = np.not_equal(
        np.frombuffer(u.encode("utf-32-le"), np.uint32)[:, None],
        np.frombuffer(v.encode("utf-32-le"), np.uint32)[None, :],
    ).astype(np.int64) if n and m else np.zeros((n, m), np.int64)

    dist = np.empty((n + 1, m + 1), np.int64)
    dist[0] = cols
    for i in range(1, n + 1):
        base = np.empty(m + 1, np.int64)
        base[0] = i
        base[1:] = np.minimum(dist[i - 1, 1:] + 1,          # deletion
                              dist[i - 1, :-1] + mismatch[i - 1])  # subst.
        dist[i] = np.minimum.accumulate(base - cols) + cols  # insertions

    subs = dels = ins = 0
    i, j = n, m
    while i > 0 or j > 0:
        here = dist[i, j]
        if i > 0 and j > 0 and here == dist[i - 1, j - 1] + mismatch[i - 1, j - 1]:
            subs += int(mismatch[i - 1, j - 1])
            i, j = i - 1, j - 1
        elif i > 0 and here == dist[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dist[n, m]), (subs, dels, ins)


def sample_cer(reference: str, hypothesis: str) -> float:
    """(S + I + D) / len(reference) (reference: cer_computer.py:46-48)."""
    _, (s, d, i) = levenshtein(reference, hypothesis)
    return (s + i + d) / len(reference)


def clean(text: str, case_sensitive: bool, punctuation: bool) -> str:
    """Normalization before scoring (reference: cer_computer.py:51-65)."""
    if not case_sensitive:
        text = text.lower()
    if not punctuation:
        pattern = "[" + re.escape(PUNCTUATIONS_OUT + PUNCTUATIONS_IN) + "]"
        text = re.sub(pattern, "", text)
    return " ".join(text.split())


def confidence_interval(data, confidence: float = 0.95) -> Tuple[float, float]:
    """t-distribution CI (reference: cer_computer.py:68-73)."""
    a = 1.0 * np.asarray(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return m - h, m + h


def read_asr_transcript(path: str):
    """Read an ASR result file (JSON list of results with alternatives)."""
    with open(path, "r", encoding="utf-8") as f:
        content = f.read()
    try:
        return json.loads(content)
    except json.JSONDecodeError:
        # reference writes python-repr dicts (asr_request.py)
        return ast.literal_eval(content)


def evaluate_language(language: str, model: str, where: str,
                      case_sensitive: bool = False,
                      punctuation: bool = False) -> List[Tuple[str, float]]:
    """Score one language's ASR outputs against the eval metafile
    (reference: cer_computer.py:88-121)."""
    cers: List[Tuple[str, float]] = []
    meta_file = os.path.join(where, "all_meta_files", f"{language}.txt")
    with open(meta_file, "r", encoding="utf-8") as f:
        for line in f:
            tokens = line.rstrip().split("|")
            idx = tokens[0]
            truth = tokens[2] if language in ("japanese", "chinese") else tokens[1]

            asr_path = os.path.join(where, model, "asr", language, f"{idx}.json")
            if not os.path.exists(asr_path):
                print(f"Missing ASR results of {idx}!")
                continue
            asr = read_asr_transcript(asr_path)
            transcript = asr[0]["alternatives"][0]["transcript"]

            cer = sample_cer(
                clean(truth, case_sensitive, punctuation),
                clean(transcript, case_sensitive, punctuation),
            )
            if len(asr) > 1:
                joined = "".join(
                    h["alternatives"][0]["transcript"] for h in asr
                )
                cer = min(cer, sample_cer(
                    clean(truth, case_sensitive, punctuation),
                    clean(joined, case_sensitive, punctuation),
                ))
            cers.append((idx, cer))
    return cers


def write_report(cers, output_file: str, metric: str = "CER") -> None:
    values = [c for _, c in cers]
    lower, upper = confidence_interval(values)
    os.makedirs(os.path.dirname(output_file), exist_ok=True)
    with open(output_file, "w", encoding="utf-8") as f:
        print(f"Total mean {metric}: {np.mean(values)}", file=f)
        print(f"Std. dev. of {metric}: {np.std(values)}", file=f)
        print(f"Conf. interval: ({lower}, {upper})", file=f)
        for idx, c in cers:
            print(f"{idx}|{c}", file=f)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--language", type=str, required=True)
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--where", type=str, required=True)
    parser.add_argument("--case_sensitive", action="store_true")
    parser.add_argument("--punctuation", action="store_true")
    args = parser.parse_args(argv)

    cers = evaluate_language(
        args.language, args.model, args.where,
        args.case_sensitive, args.punctuation,
    )
    out = os.path.join(args.where, args.model, "cer", f"{args.language}.txt")
    write_report(cers, out, "CER")
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
