"""Greedy longest-match WordPiece tokenization (BERT-style), offline.

Copy of the JAX package's ``data/wordpiece.py``.  The reference
tokenizes AG-News with a pretrained ``BertTokenizer`` (28996-entry cased
vocab).  This module reproduces that pipeline offline:
drop the tokenizer's ``vocab.txt`` under ``data_dir()`` (see
:func:`find_vocab` for the searched locations) and AG-News token ids
match the pretrained tokenizer; with no vocab on disk the caller falls
back to hash tokenization (``datasets._hash_tokenize``).

Algorithm (classic BERT):

1. basic tokenization — whitespace split, punctuation split off as
   single-char tokens, CJK chars isolated, control chars dropped
   (cased: no lower-casing, no accent stripping);
2. per word, greedy longest-match against the vocab with ``##``
   continuation prefixes; words with no match become ``[UNK]``;
3. ``[CLS] tokens [SEP]``, truncated/padded to ``seq_len`` with
   ``[PAD]`` (id 0); attention_mask marks real tokens.
"""

from __future__ import annotations

import pathlib
import unicodedata

import numpy as np

_MAX_WORD_CHARS = 100  # HF parity: longer words become [UNK] outright


def load_vocab(path: str | pathlib.Path) -> dict[str, int]:
    """vocab.txt (one token per line, line number = id) -> token->id."""
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def find_vocab(data_root: pathlib.Path) -> pathlib.Path | None:
    """First vocab.txt found under the conventional locations."""
    for rel in ("vocab.txt", "bert/vocab.txt", "tokenizer/vocab.txt",
                "bert-base-cased/vocab.txt"):
        p = data_root / rel
        if p.exists():
            return p
    return None


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges HF treats as punctuation even when unicodedata doesn't
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0xF900 <= cp <= 0xFAFF)


def basic_tokenize(text: str, lower_case: bool = False) -> list[str]:
    """Whitespace + punctuation + CJK splitting (HF BasicTokenizer)."""
    if lower_case:
        text = text.lower()
    out: list[str] = []
    word: list[str] = []

    def flush():
        if word:
            out.append("".join(word))
            word.clear()

    for ch in text:
        cat = unicodedata.category(ch)
        if ch in ("\t", "\n", "\r") or ch == " " or cat == "Zs":
            flush()
        elif cat.startswith("C"):  # control chars dropped
            continue
        elif _is_punctuation(ch) or _is_cjk(ch):
            flush()
            out.append(ch)
        else:
            word.append(ch)
    flush()
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a loaded vocab."""

    def __init__(self, vocab: dict[str, int], lower_case: bool = False,
                 unk_token: str = "[UNK]"):
        self.vocab = vocab
        self.lower_case = lower_case
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.pad_id = vocab.get("[PAD]", 0)

    @classmethod
    def from_file(cls, path: str | pathlib.Path, **kw):
        return cls(load_vocab(path), **kw)

    def wordpiece(self, word: str) -> list[int]:
        if len(word) > _MAX_WORD_CHARS:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]  # whole word -> [UNK] (HF parity)
            ids.append(cur)
            start = end
        return ids

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in basic_tokenize(text, self.lower_case):
            ids.extend(self.wordpiece(word))
        return ids

    def encode(self, text: str, seq_len: int) -> np.ndarray:
        """[CLS] ids [SEP] padded/truncated to seq_len (HF
        ``max_length``/``truncation=True``/``padding='max_length'``)."""
        ids = self.tokenize(text)[:seq_len - 2]
        row = [self.cls_id] + ids + [self.sep_id]
        out = np.full((seq_len,), self.pad_id, np.int32)
        out[:len(row)] = row
        return out

    def encode_batch(self, texts: list[str], seq_len: int) -> np.ndarray:
        return np.stack([self.encode(t, seq_len) for t in texts])
