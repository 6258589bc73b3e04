"""Dataset providers with on-disk loading + deterministic synthetic fallback.

Framework-free copy of the JAX package's ``data/datasets.py`` registry,
dispatcher and the TINYSTORIES provider (the token stream of the
TinyLlama slice).  The other providers (CIFAR, MNIST, AG-News, Emotion,
SpeechCommands) wait for the slices that port their models.  For the
same seeds the batches are byte-equal to the reference's.
"""

from __future__ import annotations

import os
import pathlib
from typing import Callable

import numpy as np

from split_learning_torch.data.loader import (
    ArrayDataset, DataLoader, cifar_augment, label_count_subset,
)

_PROVIDERS: dict[str, Callable] = {}


def data_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("SLT_DATA_DIR", "data"))


def register_dataset(name: str):
    def deco(fn):
        _PROVIDERS[name] = fn
        return fn
    return deco


def dataset_registry() -> dict[str, Callable]:
    return dict(_PROVIDERS)


def get_dataset(name: str, train: bool = True,
                synthetic_size: int | None = None,
                **dataset_kwargs) -> ArrayDataset:
    """``dataset_kwargs`` forward to the provider (e.g. ``vocab`` for
    token datasets, so a model with an overridden ``vocab_size`` draws
    in-range ids)."""
    if name not in _PROVIDERS:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(_PROVIDERS)}")
    return _PROVIDERS[name](train=train, synthetic_size=synthetic_size,
                            **dataset_kwargs)


@register_dataset("TINYSTORIES")
def tinystories(train: bool = True, synthetic_size: int | None = None,
                seq_len: int = 257, vocab: int = 32000):
    """Causal-LM token streams (north-star TinyLlama config).

    On-disk: ``data/TinyStories/{train,valid}.npy`` of shape (N, seq_len)
    int32 token ids; otherwise synthetic Markov-ish token sequences.
    Inputs are ids[:, :-1]; labels the next-token shift ids[:, 1:]."""
    path = (data_dir() / "TinyStories"
            / ("train.npy" if train else "valid.npy"))
    if path.exists():
        ids = np.load(path).astype(np.int32)
    else:
        n = synthetic_size or (4000 if train else 400)
        rng = np.random.default_rng(500 + (0 if train else 1))
        # band-structured transitions so a real LM can reduce loss; the
        # band width scales down for tiny test vocabs
        band = max(1, min(32, vocab // 4))
        starts = rng.integers(0, max(1, vocab - 2 * band), size=(n, 1))
        steps = rng.integers(-band, band + 1,
                             size=(n, seq_len - 1)).cumsum(axis=1)
        ids = np.clip(starts + np.concatenate(
            [np.zeros((n, 1), np.int64), steps], axis=1), 0, vocab - 1)
        ids = ids.astype(np.int32)
    return ArrayDataset(ids[:, :-1], ids[:, 1:].astype(np.int32))


def make_data_loader(name: str, batch_size: int,
                     distribution: np.ndarray | None = None,
                     train: bool = True, seed: int = 0,
                     synthetic_size: int | None = None,
                     dataset_kwargs: dict | None = None) -> DataLoader:
    """``distribution`` is the per-label sample-count vector a client was
    assigned; None = the full set."""
    ds = get_dataset(name, train=train, synthetic_size=synthetic_size,
                     **(dataset_kwargs or {}))
    if distribution is not None:
        rng = np.random.default_rng(seed)
        if np.ndim(ds.labels) > 1:
            # sequence labels (causal LM): class counts are meaningless —
            # take a random subset of the requested total size instead,
            # wrapping with replacement like label_count_subset does
            total = max(1, int(np.sum(distribution)))
            idx = rng.choice(len(ds), size=total,
                             replace=total > len(ds))
        else:
            idx = label_count_subset(ds.labels, distribution, rng)
        ds = ds.take(idx)
    augment = cifar_augment if (train and name in ("CIFAR10", "CIFAR100")) \
        else None
    return DataLoader(ds, batch_size, shuffle=train, augment=augment,
                      seed=seed)
