"""UTAU pitch-string decoding, table-driven and vectorized.

A copy of goofer_tpu/sampler/pitchstring.py (NumPy only).

Wire format (the contract is fixed by UTAU/OpenUtau; behavioral reference:
SillySampler.py:56-84): characters ``A-Z a-z 0-9 + /`` carry 6-bit values
(the UST flavor of base64); each 2-character pair is a 12-bit
two's-complement pitch-bend delta in cents; ``#<n>#`` repeats the last
decoded delta ``n`` more times (run-length encoding).

Implementation: a 128-entry ASCII lookup table decodes the whole segment in
one NumPy gather, pairs collapse via a strided reshape, and runs expand
with ``np.repeat`` — no per-character Python loop.
"""
from __future__ import annotations

import numpy as np

_B64 = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        "abcdefghijklmnopqrstuvwxyz"
        "0123456789+/")
_LUT = np.full(128, -1, dtype=np.int32)
_LUT[[ord(c) for c in _B64]] = np.arange(64, dtype=np.int32)


def to_uint6(c: str) -> int:
    """6-bit value of one wire character."""
    o = ord(c)
    v = _LUT[o] if o < 128 else -1
    if v < 0:
        raise ValueError(f"Bad b64 '{c}'")
    return int(v)


def to_int12(pair: str) -> int:
    """Signed 12-bit value of a 2-character pair."""
    v = (to_uint6(pair[0]) << 6) | to_uint6(pair[1])
    return v - 4096 if (v & 0x800) else v


def to_int12_stream(s: str) -> np.ndarray:
    """Vectorized decode of a b64 segment into int12 deltas."""
    if not s:
        return np.empty(0, dtype=np.int32)
    codes = np.frombuffer(s.encode("ascii"), dtype=np.uint8).astype(np.int64)
    vals = np.where(codes < 128, _LUT[codes & 0x7F], -1)
    if (vals < 0).any():
        bad = s[int(np.argmax(vals < 0))]
        raise ValueError(f"Bad b64 '{bad}'")
    if len(vals) % 2:
        raise IndexError("odd-length pitch string segment")
    pairs = vals.reshape(-1, 2)
    v = (pairs[:, 0] << 6) | pairs[:, 1]
    return np.where(v & 0x800, v - 4096, v).astype(np.int32)


def pitch_string_to_cents(x: str) -> np.ndarray:
    """Full decode: alternating b64 segments and ``#<n>#`` run lengths."""
    parts = x.split("#")
    segs: list = []
    last = None
    for i in range(0, len(parts), 2):
        seg = to_int12_stream(parts[i])
        if seg.size:
            segs.append(seg)
            last = int(seg[-1])
        if i + 1 < len(parts):
            run = int(parts[i + 1])
            if run > 0:
                if last is None:
                    raise IndexError("run with no preceding delta")
                segs.append(np.full(run, last, dtype=np.int32))
    if not segs:
        return np.array([0.0], dtype=np.float32)
    return np.concatenate(segs).astype(np.float32)
