"""Batch iteration over an in-memory segment corpus
(``pctd_tpu/data/loaders.py``, numpy only).

A corpus is a :class:`~pctd_tpu_torch.data.corpus.SegmentCorpus`, or
anything with ``pr`` (N, 32, 128) uint8 onset/sustain/rest rolls,
``chord`` (N, 8, 14) raw chord rows and ``len()``; the index space is
N x (shift_high - shift_low + 1) (segment, transposition) pairs, and a batch
is a gather from the packed arrays plus the shift vector. Tensorization runs
on the device (:mod:`pctd_tpu_torch.data.tensorize`).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from pctd_tpu_torch.data.corpus import SegmentCorpus  # noqa: F401


class SegmentBatches:
    """Iterable over host batches ``{pr, chord, shift}``; fixed shapes
    (``drop_last``) and a seeded shuffle of the (segment, shift) index."""

    def __init__(self, corpus, batch_size: int, shift_low: int = -6,
                 shift_high: int = 5, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.corpus = corpus
        self.batch_size = batch_size
        self.shift_low = shift_low
        self.shift_high = shift_high
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        self.n_shift = shift_high - shift_low + 1
        self.num_index = len(corpus) * self.n_shift

    def __len__(self):
        if self.drop_last:
            return self.num_index // self.batch_size
        return -(-self.num_index // self.batch_size)

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.num_index)
        if self.shuffle:
            self._rng.shuffle(order)
        n_full = self.num_index - (self.num_index % self.batch_size
                                   if self.drop_last else 0)
        for s in range(0, n_full, self.batch_size):
            yield self.gather(order[s:s + self.batch_size])

    def gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        seg = idx // self.n_shift
        shift = (idx % self.n_shift + self.shift_low).astype(np.int32)
        return {"pr": self.corpus.pr[seg], "chord": self.corpus.chord[seg],
                "shift": shift}


def make_loaders(train, val, batch_size: int, shift_low: int = -6,
                 shift_high: int = 5, seed: int = 0,
                 val_batch_size: Optional[int] = None):
    """(train batches with augmentation and shuffle, val batches at shift 0
    without shuffle). The val batch is clamped to the val size, so a small
    split still yields a batch."""
    vbs = min(val_batch_size or batch_size, max(len(val), 1))
    return (SegmentBatches(train, batch_size, shift_low, shift_high,
                           shuffle=True, seed=seed),
            SegmentBatches(val, vbs, 0, 0, shuffle=False, seed=seed))
