"""Audio file I/O (port of goofer_tpu/utils/audio_io.py).

The reference reads and writes audio through libsndfile (soundfile).
Here WAV goes through the native C++ RIFF codec (goofer_tpu_torch.native;
scipy for a WAV subformat the codec rejects, and for int16 PCM out),
FLAC and AIFF through the native sndcodec and MP3 through the system
libmpg123, all with libsndfile's float conventions (int16 / 32768 in,
16-bit PCM out, ties rounded away from zero).  A failed build of a codec
raises; only a decoder's rejection of a file is caught.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import wavfile

from goofer_tpu_torch import native
from goofer_tpu_torch.utils.profiling import traced

AUDIO_EXTS = [".wav", ".flac", ".aiff", ".aif", ".mp3"]


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read an audio file as float64 in [-1, 1); channels are kept."""
    low = str(path).lower()
    if low.endswith(".wav"):
        try:
            data, sr = native.read_wav(path)
            return data.astype(np.float64), int(sr)
        except OSError:
            pass  # unusual subformat: scipy below
    elif low.endswith((".flac", ".aiff", ".aif", ".mp3")):
        try:
            if low.endswith(".flac"):
                data, sr = native.read_flac(path)
            elif low.endswith(".mp3"):
                data, sr = native.read_mp3(path)
            else:
                data, sr = native.read_aiff(path)
            return data.astype(np.float64), int(sr)
        except OSError:
            # goofer_tpu's curated error; this port takes no soundfile
            # branch
            raise RuntimeError(
                f"cannot decode {path}: the native flac/aiff/mp3 decoders "
                f"rejected it and the optional 'soundfile' (libsndfile) "
                f"package is not importable in this environment") from None
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


@traced("io.write")
def write_wav(path, data: np.ndarray, sr: int) -> None:
    """Write audio as 16-bit PCM WAV (soundfile's default subtype): the
    span ``io.write``.

    Float input is quantized by the native codec, as goofer_tpu does;
    int16 input (the PCM of ``render_phrase(..., pcm16=True)``) is written
    as it is."""
    data = np.asarray(data)
    if data.dtype == np.int16:
        wavfile.write(str(path), int(sr), data)
        return
    native.write_wav(path, data, sr)


def is_audio_file(path) -> bool:
    return Path(path).suffix.lower() in AUDIO_EXTS
