"""Data layer: corpus loaders, metafiles, sampling, bucketed batching.

Port of the JAX package's ``data/``: plain-Python/numpy dataset objects,
language-balanced and "perfect" (language-interleaved) batch sampling, a
collate that pads to bucket boundaries, and a prefetching thread
(``data.prefetch``).
"""

from multilingual_text_to_speech_tpu_torch.data.batching import (
    Batch,
    Collate,
    batch_iterator,
)
from multilingual_text_to_speech_tpu_torch.data.dataset import (
    TextToSpeechDataset,
    TextToSpeechDatasetCollection,
    create_meta_file,
)
from multilingual_text_to_speech_tpu_torch.data.sampling import (
    BalancedBatchSampler,
    PerfectBatchSampler,
    SimpleBatchSampler,
)

__all__ = [
    "TextToSpeechDataset", "TextToSpeechDatasetCollection", "create_meta_file",
    "Batch", "Collate", "batch_iterator",
    "BalancedBatchSampler", "PerfectBatchSampler", "SimpleBatchSampler",
]
