"""The host audio codecs, through ctypes: a JAX-free copy of
goofer_tpu/native/__init__.py.

``csrc/wavcodec.cpp`` (RIFF WAV read and 16-bit PCM write) and
``csrc/sndcodec.cpp`` (FLAC and AIFF/AIFC decode) are byte-for-byte
copies of goofer_tpu/native's sources.  Each is compiled by ``g++`` at
first use into ``build/goofer_tpu_torch/lib<name>-<hash>.so``
(ops/cuda/_build.py: the name carries a hash of the source and flags,
the library is written through a temporary file and ``os.replace``),
never into the package.  A failed build raises with the compiler's
output.  MP3 decodes through the system ``libmpg123.so.0``, the decoder
libsndfile wraps (ref: SillySampler.py:211-212).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from goofer_tpu_torch.ops.cuda import _build

WAV_SRC = _build.CSRC / "wavcodec.cpp"
SND_SRC = _build.CSRC / "sndcodec.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

# the server's handler threads and batch_extract's reader pool load the
# libraries at once
_lock = threading.Lock()
_lib = None
_snd_lib = None


def build(source: Path) -> Path:
    """Compile ``source`` unless its build exists; returns the library's
    path."""
    return _build.build_library(source, GXX_FLAGS, lambda: "g++")


def load():
    """Build (if needed) and load the WAV codec; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build(WAV_SRC)))
        lib.wav_read_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
        lib.wav_read_info.restype = ctypes.c_int
        lib.wav_read_f32.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong]
        lib.wav_read_f32.restype = ctypes.c_int
        lib.wav_write_pcm16.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.wav_write_pcm16.restype = ctypes.c_int
        _lib = lib
        return _lib


def load_snd():
    """Build (if needed) and load the FLAC/AIFF decoder; raises on
    failure."""
    global _snd_lib
    with _lock:
        if _snd_lib is not None:
            return _snd_lib
        lib = ctypes.CDLL(str(build(SND_SRC)))
        for name in ("flac_read_info", "aiff_read_info"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        for name in ("flac_read_f32", "aiff_read_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(dtype=np.float32,
                                       flags="C_CONTIGUOUS"),
                ctypes.c_longlong]
            # number of float values written (>= 0) or a negative error
            fn.restype = ctypes.c_longlong
        _snd_lib = lib
        return _snd_lib


def _read_snd(path, kind: str):
    lib = load_snd()
    info_fn = getattr(lib, f"{kind}_read_info")
    data_fn = getattr(lib, f"{kind}_read_f32")
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    frames = ctypes.c_longlong()
    bits = ctypes.c_int()
    rc = info_fn(str(path).encode(), ctypes.byref(sr), ctypes.byref(ch),
                 ctypes.byref(frames), ctypes.byref(bits))
    if rc != 0:
        raise OSError(f"{kind}_read_info({path}) failed: {rc}")
    n = frames.value * ch.value
    if not 0 <= n < (1 << 31):
        # corrupt header (e.g. a flipped STREAMINFO byte) must not drive
        # an absurd host allocation
        raise OSError(f"{kind}_read_info({path}): implausible sample "
                      f"count {n}")
    out = np.zeros(n, dtype=np.float32)   # never expose heap garbage
    written = data_fn(str(path).encode(), out, n)
    if written < 0:
        raise OSError(f"{kind}_read_f32({path}) failed: {written}")
    if written < n:
        # e.g. a stream truncated at a frame boundary: STREAMINFO
        # promised more samples than the frames actually carry
        out = out[: written - written % ch.value]
    if ch.value > 1:
        out = out.reshape(-1, ch.value)
    return out, sr.value


def read_flac(path):
    """Decode a FLAC file to float32 [-1, 1); returns (data, sr).
    Multichannel data comes back as (frames, channels)."""
    return _read_snd(path, "flac")


def read_aiff(path):
    """Decode an AIFF/AIFC (PCM) file to float32 [-1, 1)."""
    return _read_snd(path, "aiff")


_mpg123 = None

# mpg123.h constants (stable C ABI)
_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_MPG123_ENC_SIGNED_16 = 0xD0


def _load_mpg123():
    """Bind the system libmpg123 (the same decoder libsndfile uses for
    mp3 in the reference's stack, ref: SillySampler.py:211-212)."""
    global _mpg123
    with _lock:
        if _mpg123 is not None:
            return _mpg123
        lib = ctypes.CDLL("libmpg123.so.0")
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _mpg123 = lib
        return _mpg123


def read_mp3(path):
    """Decode an MP3 to float32 [-1, 1) via the system libmpg123;
    returns (data, sr).  Multichannel comes back as (frames, channels).

    Note: API-encoded streams without a LAME/Xing gapless tag decode
    with the codec's delay/padding samples included (same behavior as
    libsndfile on such files)."""
    lib = _load_mpg123()
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise OSError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(h, str(path).encode()) != _MPG123_OK:
            raise OSError(f"mpg123_open({path}) failed")
        rate = ctypes.c_long()
        ch = ctypes.c_int()
        enc = ctypes.c_int()
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise OSError(f"mpg123_getformat({path}) failed")
        if enc.value != _MPG123_ENC_SIGNED_16:
            lib.mpg123_format_none(h)
            if lib.mpg123_format(h, rate.value, ch.value,
                                 _MPG123_ENC_SIGNED_16) != _MPG123_OK:
                raise OSError(f"mpg123_format({path}) failed")

        chunks = []
        buf = (ctypes.c_ubyte * 65536)()
        got = ctypes.c_size_t()
        total = 0
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(got))
            if got.value:
                chunks.append(bytes(buf[: got.value]))
                total += got.value
                if total > (1 << 32):
                    raise OSError(f"mp3 stream too large: {path}")
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(ch), ctypes.byref(enc))
                continue
            if rc not in (_MPG123_OK, _MPG123_NEED_MORE):
                raise OSError(f"mpg123_read({path}) failed: {rc}")
        if not chunks:
            raise OSError(f"no audio decoded from {path}")
        pcm = np.frombuffer(b"".join(chunks), dtype=np.int16)
        out = pcm.astype(np.float32) / 32768.0
        if ch.value > 1:
            out = out[: len(out) - len(out) % ch.value]
            out = out.reshape(-1, ch.value)
        return out, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def read_wav(path):
    """Read a WAV as float32 [-1, 1); returns (data, sr).  Multichannel
    data comes back as (frames, channels)."""
    lib = load()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    frames = ctypes.c_longlong()
    rc = lib.wav_read_info(str(path).encode(), ctypes.byref(sr),
                           ctypes.byref(ch), ctypes.byref(frames))
    if rc != 0:
        raise OSError(f"wav_read_info({path}) failed: {rc}")
    n = frames.value * ch.value
    out = np.empty(n, dtype=np.float32)
    rc = lib.wav_read_f32(str(path).encode(), out, n)
    if rc != 0:
        raise OSError(f"wav_read_f32({path}) failed: {rc}")
    if ch.value > 1:
        out = out.reshape(frames.value, ch.value)
    return out, sr.value


def write_wav(path, data, sr: int) -> None:
    """Write float audio as 16-bit PCM WAV."""
    lib = load()
    data = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
    if data.ndim == 1:
        frames, channels = len(data), 1
    else:
        frames, channels = data.shape
    rc = lib.wav_write_pcm16(str(path).encode(), data.reshape(-1),
                             frames, channels, int(sr))
    if rc != 0:
        raise OSError(f"wav_write_pcm16({path}) failed: {rc}")
