"""Ragged token sequences to padded batches.

Counterpart of ``pad_sequences`` in ``synapseml_tpu/parallel/batching.py``;
the rest of that module (the training-side batcher and host-to-device
feeder) comes with the trainer slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.batching import round_up_to_multiple

__all__ = ["pad_sequences"]


def pad_sequences(seqs: Sequence[Sequence[int]], max_len: int | None = None,
                  pad_value: int = 0, multiple_of: int = 8,
                  dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Ragged token id lists -> (ids[B,L], attention_mask[B,L]) with L bucketed."""
    lengths = [min(len(s), max_len) if max_len else len(s) for s in seqs]
    L = round_up_to_multiple(max(lengths, default=1), multiple_of)
    if max_len:
        L = min(L, round_up_to_multiple(max_len, multiple_of))
    ids = np.full((len(seqs), L), pad_value, dtype=dtype)
    mask = np.zeros((len(seqs), L), dtype=dtype)
    for i, s in enumerate(seqs):
        t = list(s)[:L]
        ids[i, : len(t)] = t
        mask[i, : len(t)] = 1
    return ids, mask
