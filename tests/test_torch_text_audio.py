"""The port's text and audio data path against the JAX package's, on the
CPU: the AG-News, Emotion and SpeechCommands providers, the hash
tokenizer, WordPiece, the CSV and ``text;label`` readers, the MFCC
pipeline and the WAV reader.  Every file read is one the test writes
under its own data directory (``SLT_DATA_DIR``).

* The three synthetic sets (train and test, the default and a model's
  own vocab) are equal bit for bit, and so are the on-disk sets built
  from the test's CSV, text and WAV files.
* ``compute_mfcc`` (the numpy pipeline) is equal bit for bit to the JAX
  package's; the port's ``mfcc_batch`` is within 1e-4 of the JAX
  package's, which may take its native C++ extractor (measured 0 where
  the native library loads).
"""

import wave

import numpy as np
import pytest

from split_learning_tpu.data import datasets as jds
from split_learning_tpu.data import mfcc as jmfcc
from split_learning_tpu.data import wordpiece as jwp
from split_learning_torch.data import datasets as tds
from split_learning_torch.data import mfcc as tmfcc
from split_learning_torch.data import wordpiece as twp

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "market", "##s",
         "rally", "team", "win", "##ning", ",", "!", "stock", "joy"]


def _assert_same(a, b):
    assert a.inputs.dtype == b.inputs.dtype and a.labels.dtype == \
        b.labels.dtype
    assert a.inputs.shape == b.inputs.shape
    assert a.inputs.tobytes() == b.inputs.tobytes()
    assert a.labels.tobytes() == b.labels.tobytes()


@pytest.mark.parametrize("name,kw", [
    ("AGNEWS", {}), ("AGNEWS", {"vocab": 128}), ("EMOTION", {}),
    ("SPEECHCOMMANDS", {})])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_sets_are_bit_equal(tmp_path, monkeypatch, name, kw,
                                      train):
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    a = jds.get_dataset(name, train=train, synthetic_size=48, **kw)
    b = tds.get_dataset(name, train=train, synthetic_size=48, **kw)
    _assert_same(a, b)
    if name == "SPEECHCOMMANDS":
        assert b.inputs.shape == (48, 40, 98)
    else:
        assert b.inputs.shape == (48, 128) and (b.inputs[:, 0] ==
                                                min(101, kw.get(
                                                    "vocab", 28996) - 1)).all()


def test_mnist_still_waits():
    with pytest.raises(NotImplementedError, match="VGG16_MNIST"):
        tds.get_dataset("MNIST")


def test_hash_tokenizer_is_equal():
    texts = ["Stocks rally on Wall Street", "", "a " * 300,
             "Émigré café, naïve!"]
    for seq_len, vocab in ((128, 28996), (16, 2048)):
        a = jds._hash_tokenize(texts, seq_len, vocab)
        b = tds._hash_tokenize(texts, seq_len, vocab)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_wordpiece_on_a_written_vocab(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    texts = ["the markets rally, team winning!", "stock joy", "xyz the",
             "the " * 200]
    a = jwp.WordPieceTokenizer.from_file(path)
    b = twp.WordPieceTokenizer.from_file(path)
    for t in texts:
        assert a.tokenize(t) == b.tokenize(t)
    ea, eb = a.encode_batch(texts, 16), b.encode_batch(texts, 16)
    assert ea.tobytes() == eb.tobytes()
    assert eb[0].tolist()[:10] == [2, 4, 5, 6, 7, 11, 8, 9, 10, 12]
    assert eb[2].tolist()[:4] == [2, 1, 4, 3]
    assert twp.find_vocab(tmp_path) == path


def _write_text_sets(root):
    (root / "ag_news").mkdir()
    for stem in ("train", "test"):
        (root / "ag_news" / f"{stem}.csv").write_text(
            '3,"Stocks rally","the market wins, again"\n'
            '2,Team wins,"winning streak!"\n'
            'bad row\n'
            '1,"World","news of the day"\n', encoding="utf-8")
    (root / "emotion").mkdir()
    (root / "emotion" / "train.txt").write_text(
        "i feel great joy;joy\nso sad today;0\n\n"
        '"a; quoted, text",surprise\nno label here\n', encoding="utf-8")


@pytest.mark.parametrize("with_vocab", [False, True])
def test_text_sets_from_disk_are_bit_equal(tmp_path, monkeypatch,
                                           with_vocab):
    _write_text_sets(tmp_path)
    if with_vocab:
        (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n",
                                            encoding="utf-8")
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    for name, train in (("AGNEWS", True), ("AGNEWS", False),
                        ("EMOTION", True)):
        a = jds.get_dataset(name, train=train)
        b = tds.get_dataset(name, train=train)
        _assert_same(a, b)
    ag = tds.get_dataset("AGNEWS")
    assert ag.labels.tolist() == [2, 1, 0] and ag.inputs.shape == (3, 128)
    assert tds.get_dataset("EMOTION").labels.tolist() == [1, 0, 5]
    # the emotion test split is not on disk: the synthetic set
    assert len(tds.get_dataset("EMOTION", train=False,
                               synthetic_size=8)) == 8


def test_vocab_larger_than_the_table_is_refused(tmp_path, monkeypatch):
    _write_text_sets(tmp_path)
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n",
                                        encoding="utf-8")
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="embedding"):
        tds.get_dataset("AGNEWS", vocab=8)


def _signals(n=3, length=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    return np.stack([0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t)
                     + 0.05 * rng.standard_normal(length)
                     for i in range(n)]).astype(np.float32)


def test_mfcc_is_equal():
    x = _signals()
    for kw in ({}, {"n_mfcc": 13, "n_mels": 40}):
        for s in x:
            a, b = jmfcc.compute_mfcc(s, **kw), tmfcc.compute_mfcc(s, **kw)
            assert a.dtype == b.dtype == np.float32
            assert a.tobytes() == b.tobytes()
    assert tmfcc.compute_mfcc(x[0]).shape == (40, 98)
    fb_a, fb_b = jmfcc.mel_filterbank(64, 512, 16000), \
        tmfcc.mel_filterbank(64, 512, 16000)
    assert fb_a.tobytes() == fb_b.tobytes()
    got = tmfcc.mfcc_batch(x)
    assert got.shape == (3, 40, 98)
    np.testing.assert_allclose(got, jmfcc.mfcc_batch(x), rtol=0, atol=1e-4)


def _write_wav(path, x, channels=1):
    pcm = np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)
    if channels == 2:
        pcm = np.stack([pcm, pcm // 2], axis=1).reshape(-1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def test_wav_reader_and_speechcommands_from_disk(tmp_path, monkeypatch):
    x = _signals(4, 12000)
    _write_wav(tmp_path / "mono.wav", x[0])
    _write_wav(tmp_path / "stereo.wav", x[1], channels=2)
    for f in ("mono.wav", "stereo.wav"):
        a = jds._read_wav_mono(tmp_path / f)
        b = tds._read_wav_mono(tmp_path / f)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == \
            b.tobytes()
    assert tds._read_wav_mono(tmp_path / "mono.wav").shape == (12000,)

    root = tmp_path / "SpeechCommands" / "speech_commands_v0.02"
    for i, cls in enumerate(("yes", "no", "go")):
        (root / cls).mkdir(parents=True)
        _write_wav(root / cls / "a.wav", x[i])
        _write_wav(root / cls / "b.wav", x[3 - i][:16000])
    (root / "testing_list.txt").write_text("no/b.wav\n")
    monkeypatch.setenv("SLT_DATA_DIR", str(tmp_path))
    for train in (True, False):
        a = jds.get_dataset("SPEECHCOMMANDS", train=train)
        b = tds.get_dataset("SPEECHCOMMANDS", train=train)
        assert a.labels.tobytes() == b.labels.tobytes()
        np.testing.assert_allclose(b.inputs, a.inputs, rtol=0, atol=1e-4)
    train = tds.get_dataset("SPEECHCOMMANDS")
    assert train.inputs.shape == (5, 40, 98)
    assert train.labels.tolist() == [0, 0, 1, 9, 9]
