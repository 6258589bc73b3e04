"""MFCC feature extraction in numpy.

Copy of the JAX package's ``data/mfcc.py`` numpy pipeline: pre-emphasis,
25 ms / 10 ms framing, Hamming window, power spectrum, mel filterbank,
log, DCT-II with ortho norm — (n_mfcc, n_frames) = (40, 98) for a
1-second 16 kHz clip, vectorized over frames.  The JAX package's native
C++ extractor is host code that is not ported yet; :func:`mfcc_batch`
is the numpy pipeline only.
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(n_filters: int, n_fft: int, sample_rate: int,
                   f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """(n_filters, n_fft//2 + 1) triangular mel filterbank."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    mels = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_filters + 2)
    hz = _mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sample_rate).astype(int)
    fb = np.zeros((n_filters, n_fft // 2 + 1))
    for m in range(1, n_filters + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ctr):
            if ctr > lo:
                fb[m - 1, k] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            if hi > ctr:
                fb[m - 1, k] = (hi - k) / (hi - ctr)
    return fb


def _dct_ortho(x: np.ndarray, n_out: int) -> np.ndarray:
    """DCT-II along the last axis with ortho normalization."""
    n = x.shape[-1]
    k = np.arange(n_out)[:, None]
    i = np.arange(n)[None, :]
    basis = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    scale = np.full((n_out, 1), np.sqrt(2.0 / n))
    scale[0, 0] = np.sqrt(1.0 / n)
    return x @ (basis * scale).T


def compute_mfcc(signal: np.ndarray, sample_rate: int = 16000,
                 n_mfcc: int = 40, frame_ms: float = 25.0,
                 hop_ms: float = 10.0, n_fft: int = 512,
                 n_mels: int = 64, pre_emphasis: float = 0.97,
                 eps: float = 1e-10) -> np.ndarray:
    """(n_mfcc, n_frames) MFCCs of a mono signal."""
    sig = np.asarray(signal, dtype=np.float64)
    sig = np.append(sig[0], sig[1:] - pre_emphasis * sig[:-1])

    frame_len = int(round(sample_rate * frame_ms / 1000.0))
    hop = int(round(sample_rate * hop_ms / 1000.0))
    n_frames = max(1, 1 + (len(sig) - frame_len) // hop)
    pad = (n_frames - 1) * hop + frame_len - len(sig)
    if pad > 0:
        sig = np.pad(sig, (0, pad))
    idx = (np.arange(frame_len)[None, :]
           + hop * np.arange(n_frames)[:, None])
    frames = sig[idx] * np.hamming(frame_len)[None, :]

    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2 / n_fft
    fb = mel_filterbank(n_mels, n_fft, sample_rate)
    mel_energy = np.log(spec @ fb.T + eps)
    mfcc = _dct_ortho(mel_energy, n_mfcc)
    return mfcc.T.astype(np.float32)  # (n_mfcc, n_frames)


def mfcc_batch(signals: np.ndarray, **kw) -> np.ndarray:
    """(B, n_mfcc, n_frames) over a batch of equal-length signals."""
    return np.stack([compute_mfcc(s, **kw) for s in signals])
