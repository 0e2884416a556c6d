"""Corpus preparation utilities (Python rebuilds of the reference's
``dataset_prepare/*.sh`` shell pipelines): transcript normalization,
CommonVoice download/filtering, romanization, silence trimming."""
