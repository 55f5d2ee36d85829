"""UTAU pitch-bend strings: the curve a note's traffic carries, encoded in
the wire format UTAU and OpenUtau send (the decoder is
goofer_tpu_torch/sampler/pitchstring.py, frozen in reference/).

One value per tick (96 ticks a beat), each the bend in cents from the
note's pitch as a 12-bit two's-complement pair of base64 characters;
``#n#`` repeats the previous value n more times.
"""
from __future__ import annotations

import math

import numpy as np

B64 = ("ABCDEFGHIJKLMNOPQRSTUVWXYZ"
       "abcdefghijklmnopqrstuvwxyz"
       "0123456789+/")
TICKS_PER_BEAT = 96


def tick_ms(tempo: float) -> float:
    return 60000.0 / (tempo * TICKS_PER_BEAT)


def encode(cents) -> str:
    """The wire string of integer bends in cents, runs of one value
    run-length coded."""
    vals = [int(v) for v in cents]
    for v in vals:
        if not -2048 <= v <= 2047:
            raise ValueError(f"bend {v} cents is outside 12 bits")
    out = []
    i = 0
    while i < len(vals):
        v = vals[i] & 0xFFF
        out.append(B64[v >> 6] + B64[v & 63])
        run = 1
        while i + run < len(vals) and vals[i + run] == vals[i]:
            run += 1
        if run > 2:
            out.append(f"#{run - 1}#")
            i += run
        else:
            i += 1
    return "".join(out)


def curve(duration_ms: float, tempo: float, from_cents: float,
          portamento: tuple, vibrato=None) -> np.ndarray:
    """Integer cents per tick over ``duration_ms``: ``from_cents`` until
    the portamento's start, a half-cosine (OpenUtau's default "io" shape)
    to 0 over its length, given as ``portamento`` = (start ms, length
    ms); then, if ``vibrato`` = (start ms, end ms, period ms, depth cents,
    fade-in ms, fade-out ms) is given, a sine of that period and depth
    between its start and end, faded in and out linearly."""
    dt = tick_ms(tempo)
    t = np.arange(int(math.ceil(duration_ms / dt)) + 1) * dt
    p0, plen = portamento
    c = np.where(t < p0, from_cents, 0.0)
    ramp = (t >= p0) & (t < p0 + plen)
    c[ramp] = from_cents * 0.5 * (1.0 + np.cos(np.pi * (t[ramp] - p0)
                                               / plen))
    if vibrato is not None:
        start, end, period, depth, fade_in, fade_out = vibrato
        on = (t >= start) & (t <= end)
        tv = t[on] - start
        fade = np.clip(np.minimum(tv / fade_in, (end - t[on]) / fade_out),
                       0.0, 1.0)
        c[on] += depth * fade * np.sin(2.0 * np.pi * tv / period)
    return np.rint(c).astype(np.int64)
