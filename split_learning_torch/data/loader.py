"""Label-count-driven dataset subsetting + batching.

Parity surface: the reference's ``data_loader(data_name, batch_size,
distribution, train)`` (``src/dataset/dataloader.py:124-133``)
where ``distribution`` is a per-label sample-count vector and each loader
samples exactly that many examples per class (``:61-92``).

TPU-first differences:

* batches are numpy arrays with **static shapes** (``drop_last`` semantics:
  a trailing partial batch would retrigger XLA compilation, so it is folded
  by wrapping around the shuffled epoch instead of being emitted ragged);
* augmentation (random crop + horizontal flip for CIFAR) is pure numpy on
  host, overlapping with device compute;
* everything is seeded and deterministic.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Iterator

import numpy as np


def subset_seed(base_seed: int, client_key: str, round_idx: int = 0,
                refresh: bool = False) -> int:
    """Loader seed for one client's label-count subset draw.

    crc32, not ``hash()`` (salted per process): two clients with
    identical label counts must still draw DISTINCT subsets, and the
    same deployment must draw the same ones on every run.  With
    ``refresh`` (the reference's ``data-distribution.refresh`` —
    clients rebuild their loader every round, ``src/RpcClient.py:108``)
    the seed also varies per round, re-sampling the subset."""
    s = (zlib.crc32(client_key.encode()) ^ base_seed) % (2 ** 31)
    if refresh:
        s = (s ^ (0x9E3779B1 * (round_idx + 1))) % (2 ** 31)
    return s


def label_count_subset(labels: np.ndarray, counts: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """Indices selecting exactly ``counts[c]`` examples of each class c.

    If a class has fewer examples than requested, sampling wraps with
    replacement (the reference errors out instead; wrapping keeps synthetic
    smoke datasets usable at any requested scale).
    """
    idx: list[np.ndarray] = []
    for c, n in enumerate(np.asarray(counts, dtype=int)):
        if n <= 0:
            continue
        pool = np.nonzero(labels == c)[0]
        if len(pool) == 0:
            continue
        replace = len(pool) < n
        idx.append(rng.choice(pool, size=n, replace=replace))
    if not idx:
        return np.empty((0,), dtype=int)
    out = np.concatenate(idx)
    rng.shuffle(out)
    return out


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: ``inputs`` is one array or a dict of arrays
    (e.g. BERT's input_ids/attention_mask), ``labels`` is int."""
    inputs: np.ndarray | dict
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)

    def take(self, idx: np.ndarray) -> "ArrayDataset":
        if isinstance(self.inputs, dict):
            ins = {k: v[idx] for k, v in self.inputs.items()}
        else:
            ins = self.inputs[idx]
        return ArrayDataset(ins, self.labels[idx])


class DataLoader:
    """Seeded shuffling batcher with static batch shapes.

    ``augment`` maps a stacked input batch -> augmented batch (numpy).
    Iterating yields ``(inputs, labels)``; ``len()`` is batches/epoch.
    """

    def __init__(self, dataset: ArrayDataset, batch_size: int,
                 shuffle: bool = True,
                 augment: Callable[[np.ndarray, np.random.Generator],
                                   np.ndarray] | None = None,
                 seed: int = 0):
        if len(dataset) == 0:
            raise ValueError("empty dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        self.num_batches = max(1, len(dataset) // batch_size)

    @property
    def samples_per_epoch(self) -> int:
        return self.num_batches * self.batch_size

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[tuple]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        need = self.num_batches * self.batch_size
        if n < need:
            # wrap (with repetition for tiny datasets) to fill the static
            # batch shape
            reps = -(-need // n)
            order = np.tile(order, reps)[:need]
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = self.dataset.take(idx)
            ins = batch.inputs
            if self.augment is not None:
                ins = self.augment(ins, self._rng)
            yield ins, batch.labels


def cifar_augment(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random crop (pad 4) + horizontal flip, NHWC — the reference's
    torchvision transform pipeline (``src/dataset/dataloader.py:63-70``)
    in numpy."""
    b, h, w, _ = x.shape
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(x)
    ys = rng.integers(0, 9, size=b)
    xs = rng.integers(0, 9, size=b)
    flip = rng.random(b) < 0.5
    for i in range(b):
        crop = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w]
        out[i] = crop[:, ::-1] if flip[i] else crop
    return out
