""".goofy feature-bundle reading, byte-compatible with the reference format.

A JAX-free copy of the reading half of goofer_tpu/io/goofy.py.

A `.goofy` file is a compressed NPZ next to each source WAV
(ref: GOOFER.py:287-339).  Two modes:

* ``knots``: keys mode, knot_vals_log (fp16), hz_knots (fp32), n_bins,
  n_fft, env_sr, f0_interp (fp16, per-sample), voicing_mask (fp16,
  per-sample), formants (pickled dict {1..4: array}), sr, y_len.
* ``full``: keys mode, env_spec (fp16) and the same track keys plus an
  n_fft derived from the bin count.

Files written by the reference or by goofer_tpu load here unchanged.
Writing them (feature extraction) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from goofer_tpu_torch.config import COMPUTE_DTYPE


def formants_to_int_keys(d) -> dict:
    """Canonicalize a formant dict to integer keys 1..4, zero-filling missing
    tracks (ref: GOOFER.py:48-62)."""
    out = {}
    if isinstance(d, dict):
        for k, v in d.items():
            key = k
            if isinstance(key, str) and key.upper().startswith("F"):
                try:
                    key = int(key[1:])
                except Exception:
                    continue
            if isinstance(key, (int, np.integer)) and 1 <= int(key) <= 4:
                out[int(key)] = np.asarray(v)
    for i in (1, 2, 3, 4):
        if i not in out:
            out[i] = np.zeros(1, dtype=np.float64)
    return out


def load_features(path):
    """Load a .goofy bundle (ref: GOOFER.py:319-339).

    Returns (env_spec_or_knotpack, f0_interp, voicing_mask, formants, sr,
    y_len); knots mode returns the pack dict for later device decode.
    """
    data = np.load(path, allow_pickle=True)
    mode = str(data["mode"][0])
    if mode == "knots":
        env = {
            "mode": "knots",
            "knot_vals_log": data["knot_vals_log"],
            "hz_knots": data["hz_knots"],
            "n_bins": int(data["n_bins"][0]),
            "n_fft": int(data["n_fft"][0]),
            "sr": int(data["env_sr"][0]),
        }
    else:
        env = np.asarray(data["env_spec"], dtype=COMPUTE_DTYPE)
    f0_interp = np.asarray(data["f0_interp"], dtype=COMPUTE_DTYPE)
    voicing_mask = np.asarray(data["voicing_mask"], dtype=COMPUTE_DTYPE)
    formants = formants_to_int_keys(data["formants"].item())
    sr = int(data["sr"][0])
    y_len = int(data["y_len"][0])
    return env, f0_interp, voicing_mask, formants, sr, y_len
