"""Mono WAV I/O through ``scipy.io.wavfile``.

The JAX package reads and writes audio through its native C++ codecs
(goofer_tpu/utils/audio_io.py); those are not ported yet, so this module
handles PCM and float WAV only, with libsndfile's float conventions
(int16 / 32768 in, 16-bit PCM out).
"""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a WAV file as float64 in [-1, 1); channels are kept."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float64) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    else:
        data = data.astype(np.float64)
    return data, int(sr)


def read_wav_mono(path) -> tuple[np.ndarray, int]:
    """Read and average channels down to mono (ref: SillySampler.py:421-429)."""
    y, sr = read_wav(path)
    if y.ndim > 1:
        y = y.mean(axis=1)
    return y, sr


def write_wav(path, data: np.ndarray, sr: int) -> None:
    """Write audio as 16-bit PCM WAV (soundfile's default subtype)."""
    clipped = np.clip(np.asarray(data, dtype=np.float64), -1.0,
                      32767.0 / 32768.0)
    pcm = np.round(clipped * 32768.0).astype(np.int16)
    wavfile.write(str(path), int(sr), pcm)
