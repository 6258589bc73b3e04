"""Dataset providers with on-disk loading + deterministic synthetic fallback.

Framework-free copy of the JAX package's ``data/datasets.py`` registry,
dispatcher and providers: TINYSTORIES (the token stream of the TinyLlama
slice), CIFAR-10/100 (VGG16, ResNet-50, ViT), AG-News and Emotion (BERT:
the CSV and ``text;label`` readers, WordPiece when a ``vocab.txt`` is
under :func:`data_dir`, the hash tokenizer otherwise) and SpeechCommands
(KWT: WAV files through the numpy MFCC pipeline).  MNIST waits for the
slice that ports its model and raises ``NotImplementedError``.  No file
is downloaded: a provider reads its on-disk copy under :func:`data_dir`
when it is there, else it generates its deterministic synthetic set.
For the same seeds the sets are byte-equal to the JAX package's.
"""

from __future__ import annotations

import csv
import os
import pathlib
import pickle
import zlib
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
_LATER = {"MNIST": "VGG16_MNIST"}


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


def _synthetic_tokens(n: int, seq_len: int, vocab: int, n_classes: int,
                      seed: int) -> ArrayDataset:
    """Each class owns a band of "topic" tokens mixed with common ones."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    band = vocab // (n_classes + 1)
    common = rng.integers(1, band, size=(n, seq_len))
    topic = (band * (labels[:, None] + 1)
             + rng.integers(0, band, size=(n, seq_len)))
    use_topic = rng.random((n, seq_len)) < 0.3
    ids = np.where(use_topic, topic, common).astype(np.int32)
    # [CLS]-like position: id 101 (the BERT [CLS] id), NOT 0 — id 0 is
    # [PAD] and would be masked out of attention (models/bert.py)
    ids[:, 0] = min(101, vocab - 1)
    return ArrayDataset(ids, labels.astype(np.int32))


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


# --------------------------------------------------------------------------
# AG-News / Emotion (token classification)
# --------------------------------------------------------------------------

_AGNEWS_SEQ_LEN = 128  # reference fixed length
_BERT_VOCAB = 28996


def _hash_tokenize(texts: list[str], seq_len: int, vocab: int) -> np.ndarray:
    """Deterministic offline tokenizer: whitespace split + stable hash into
    the BERT vocab range (``[CLS]`` 101 first, ``[SEP]`` 102 last, then
    ``[PAD]`` 0).  Used when no WordPiece vocab is on disk."""
    out = np.zeros((len(texts), seq_len), np.int32)
    for i, t in enumerate(texts):
        ids = [101]  # [CLS]
        for w in t.lower().split()[:seq_len - 2]:
            ids.append(1000 + zlib.crc32(w.encode()) % (vocab - 1100))
        ids.append(102)  # [SEP]
        out[i, :len(ids)] = ids[:seq_len]
    return out


def _agnews_csv(path: pathlib.Path) -> tuple | None:
    """AG-News ``label,title,description`` rows (labels 1-4 on disk,
    0-3 here)."""
    if not path.exists():
        return None
    texts, labels = [], []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f):
            if len(row) < 3:
                continue
            labels.append(int(row[0]) - 1)
            texts.append(row[1] + " " + row[2])
    return texts, np.asarray(labels, np.int32)


def _tokenize(texts: list[str], seq_len: int, vocab: int) -> np.ndarray:
    """WordPiece when a ``vocab.txt`` is under :func:`data_dir` (token ids
    then match a pretrained BertTokenizer's); the hash tokenizer
    otherwise."""
    from split_learning_torch.data.wordpiece import (
        WordPieceTokenizer, find_vocab,
    )
    vocab_path = find_vocab(data_dir())
    if vocab_path is not None:
        tok = WordPieceTokenizer.from_file(vocab_path)
        if max(tok.vocab.values(), default=0) >= vocab:
            # e.g. an uncased 30522-entry vocab.txt against the 28996
            # cased embedding table
            raise ValueError(
                f"{vocab_path} holds token ids up to "
                f"{max(tok.vocab.values())} but the model's embedding "
                f"table holds {vocab}; use the matching (cased) vocab")
        return tok.encode_batch(texts, seq_len)
    return _hash_tokenize(texts, seq_len, vocab)


@register_dataset("AGNEWS")
def agnews(train: bool = True, synthetic_size: int | None = None,
           vocab: int = _BERT_VOCAB):
    """AG-News (4 classes), ``data/ag_news/{train,test}.csv`` on disk,
    (N, 128) int32 token ids."""
    raw = _agnews_csv(data_dir() / "ag_news"
                      / ("train.csv" if train else "test.csv"))
    if raw is not None:
        texts, labels = raw
        ids = _tokenize(texts, _AGNEWS_SEQ_LEN, vocab)
        return ArrayDataset(ids, labels)
    n = synthetic_size or (8000 if train else 1600)
    return _synthetic_tokens(n, _AGNEWS_SEQ_LEN, vocab, 4,
                             seed=300 + (0 if train else 1))


_EMOTION_LABELS = {"sadness": 0, "joy": 1, "love": 2, "anger": 3,
                   "fear": 4, "surprise": 5}


def _emotion_file(path: pathlib.Path) -> tuple | None:
    """dair-ai emotion distribution format: one ``text;label`` per line
    (label a name or an int).  Also accepts 2-column CSV."""
    if not path.exists():
        return None

    def parse_label(lab: str):
        lab = lab.strip().lower()
        idx = _EMOTION_LABELS.get(lab) if not lab.isdigit() else int(lab)
        return idx if idx is not None and 0 <= idx < 6 else None

    texts, labels = [], []
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        text = idx = None
        if ";" in line:
            cand, _, lab = line.rpartition(";")
            idx = parse_label(lab)
            text = cand
        if idx is None:
            # quoted CSV whose text itself contains ';' lands here
            row = next(csv.reader([line]))
            if len(row) >= 2:
                idx = parse_label(row[-1])
                text = ",".join(row[:-1])
        if idx is None:
            continue
        texts.append(text)
        labels.append(idx)
    return (texts, np.asarray(labels, np.int32)) if texts else None


@register_dataset("EMOTION")
def emotion(train: bool = True, synthetic_size: int | None = None,
            vocab: int = _BERT_VOCAB):
    """6-label emotion set (the BERT_EMOTION model):
    ``data/emotion/{train,test}.{txt,csv}`` on disk, tokenized as
    AG-News."""
    stem = "train" if train else "test"
    for ext in ("txt", "csv"):
        raw = _emotion_file(data_dir() / "emotion" / f"{stem}.{ext}")
        if raw is not None:
            texts, labels = raw
            ids = _tokenize(texts, _AGNEWS_SEQ_LEN, vocab)
            return ArrayDataset(ids, labels)
    n = synthetic_size or (8000 if train else 1600)
    return _synthetic_tokens(n, _AGNEWS_SEQ_LEN, vocab, 6,
                             seed=400 + (0 if train else 1))


# --------------------------------------------------------------------------
# SpeechCommands (MFCC)
# --------------------------------------------------------------------------

_SC_CLASSES = ["yes", "no", "up", "down", "left", "right", "on", "off",
               "stop", "go"]  # the reference's 10-class subset


@register_dataset("SPEECHCOMMANDS")
def speechcommands(train: bool = True, synthetic_size: int | None = None):
    """SpeechCommands v0.02 (10 classes) as (N, 40, 98) float32 MFCCs of
    1 s 16 kHz clips; ``validation_list.txt`` / ``testing_list.txt``
    name the held-out files."""
    root = data_dir() / "SpeechCommands" / "speech_commands_v0.02"
    if root.exists():
        from split_learning_torch.data.mfcc import mfcc_batch
        split_files: set[str] = set()
        for listing in ("validation_list.txt", "testing_list.txt"):
            p = root / listing
            if p.exists():
                split_files |= set(p.read_text().split())
        signals, labels = [], []
        for ci, cls in enumerate(_SC_CLASSES):
            for wav in sorted((root / cls).glob("*.wav")):
                rel = f"{cls}/{wav.name}"
                if train == (rel in split_files):
                    continue
                sig = _read_wav_mono(wav)
                signals.append(
                    np.pad(sig, (0, max(0, 16000 - len(sig))))[:16000])
                labels.append(ci)
        if signals:
            return ArrayDataset(mfcc_batch(np.stack(signals)),
                                np.asarray(labels, np.int32))
    # synthetic MFCC-shaped blobs: (40, 98) like a 1 s 16 kHz clip
    n = synthetic_size or (4000 if train else 800)
    return _synthetic_images(n, (40, 98), 10, seed=500,
                             train=train)


def _read_wav_mono(path: pathlib.Path) -> np.ndarray:
    """16-bit PCM WAV -> float32 in [-1, 1), channels averaged."""
    import wave
    with wave.open(str(path), "rb") as w:
        raw = w.readframes(w.getnframes())
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(axis=1)
    return x


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
