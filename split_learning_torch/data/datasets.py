"""Dataset providers with on-disk loading + deterministic synthetic fallback.

Framework-free copy of the JAX package's ``data/datasets.py`` registry,
dispatcher, the TINYSTORIES provider (the token stream of the TinyLlama
slice) and the CIFAR-10/100 providers (VGG16).  The other providers
(MNIST, AG-News, Emotion, SpeechCommands) wait for the slices that port
their models and raise ``NotImplementedError``.  No file is downloaded:
a provider reads its on-disk copy under :func:`data_dir` when it is
there, else it generates its deterministic synthetic set.  For the same
seeds the batches are byte-equal to the reference's.
"""

from __future__ import annotations

import os
import pathlib
import pickle
from typing import Callable

import numpy as np

from split_learning_torch.data.loader import (
    ArrayDataset, DataLoader, cifar_augment, label_count_subset,
)

_PROVIDERS: dict[str, Callable] = {}

_CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
_CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
_CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)

#: providers of the JAX package not ported yet -> the model they serve
_LATER = {"MNIST": "VGG16_MNIST", "AGNEWS": "BERT", "EMOTION": "BERT",
          "SPEECHCOMMANDS": "KWT"}


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
    if name in _LATER:
        raise NotImplementedError(
            f"dataset {name} is not ported yet; it comes with the "
            f"{_LATER[name]} slice (see ROADMAP.md)")
    if name not in _PROVIDERS:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(_PROVIDERS)}")
    return _PROVIDERS[name](train=train, synthetic_size=synthetic_size,
                            **dataset_kwargs)


# --------------------------------------------------------------------------
# synthetic generators: class-separable so accuracy is a meaningful signal
# --------------------------------------------------------------------------

def _synthetic_images(n: int, shape: tuple, n_classes: int,
                      seed: int, train: bool = True) -> ArrayDataset:
    """Gaussian blobs: each class has a fixed random template + noise, so
    even small models can learn and validation accuracy moves off
    chance.

    The class templates depend ONLY on ``seed``: train and validation
    draw different noise around the SAME templates.  Templates are
    spatially smooth (a coarse grid of 8x8 blocks), so they survive the
    CIFAR loader's random crop and flip (``cifar_augment``) — a shifted
    iid-noise template would be nearly orthogonal to the original."""
    rng_templates = np.random.default_rng(seed)
    if len(shape) < 2:
        # the block construction needs >= 2 leading spatial dims
        templates = rng_templates.normal(0, 1,
                                         size=(n_classes,) + tuple(shape))
    else:
        block = 8
        coarse_sp = tuple(-(-s // block) for s in shape[:2])
        coarse = rng_templates.normal(
            0, 1, size=(n_classes,) + coarse_sp + shape[2:])
        ones = np.ones((1,) + (block, block) + (1,) * len(shape[2:]))
        templates = np.kron(coarse, ones)[
            (slice(None),) + tuple(slice(0, s) for s in shape[:2])]
    rng = np.random.default_rng(seed * 7919 + (1 if train else 2))
    labels = rng.integers(0, n_classes, size=n)
    x = (templates[labels] * 0.5
         + rng.normal(0, 1, size=(n,) + shape) * 0.5)
    return ArrayDataset(x.astype(np.float32), labels.astype(np.int32))


# --------------------------------------------------------------------------
# CIFAR
# --------------------------------------------------------------------------

def _load_cifar_batches(root: pathlib.Path, files: list[str],
                        label_key: bytes) -> tuple | None:
    xs, ys = [], []
    for fname in files:
        p = root / fname
        if not p.exists():
            return None
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[label_key], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.concatenate(ys)


def _cifar(train: bool, synthetic_size, n_classes: int):
    """NHWC float32 images normalised per channel, from the python
    pickles under ``data_dir()``; else the synthetic set."""
    if n_classes == 10:
        root = data_dir() / "cifar-10-batches-py"
        files = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        raw = _load_cifar_batches(root, files, b"labels")
        mean, std = _CIFAR10_MEAN, _CIFAR10_STD
    else:
        root = data_dir() / "cifar-100-python"
        raw = _load_cifar_batches(root, ["train" if train else "test"],
                                  b"fine_labels")
        mean, std = _CIFAR100_MEAN, _CIFAR100_STD
    if raw is not None:
        x, y = raw
        x = (x.astype(np.float32) / 255.0 - mean) / std
        return ArrayDataset(x, y)
    n = synthetic_size or (10000 if train else 2000)
    return _synthetic_images(n, (32, 32, 3), n_classes,
                             seed=100 + n_classes, train=train)


@register_dataset("CIFAR10")
def cifar10(train: bool = True, synthetic_size: int | None = None):
    return _cifar(train, synthetic_size, 10)


@register_dataset("CIFAR100")
def cifar100(train: bool = True, synthetic_size: int | None = None):
    return _cifar(train, synthetic_size, 100)


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
