"""Headless voicing-editor logic.

The reference's SillyEditor is a tkinter canvas
(ref: SillyEditor.py:11-490); its GUI lives in goofer_tpu_torch.editor.gui.
Everything with observable on-disk or render semantics — mask painting,
the F0 brush, the atomic `.goofy` write-back with reverse-aware index
flipping, and preview-synthesis F0 filling — is implemented here so it is
testable without a display.  A copy of goofer_tpu/editor/core.py on the
port's io/goofy.py.
"""
from __future__ import annotations

import numpy as np

from goofer_tpu_torch.io.goofy import load_features, save_features_atomic


def write_back_voicing(feat_path: str, edited_mask: np.ndarray,
                       start_sample: int, end_sample: int,
                       snippet_was_reversed: bool) -> None:
    """Splice an edited mask span back into the stored voicing mask,
    flipping indices if the snippet came from a reversed render; atomic
    tmp + os.replace (ref: SillyEditor.py:506-542).  The total length is
    the stored file's own ``ylen`` — the file is authoritative (a stale
    caller-supplied length could mis-flip reversed spans)."""
    env0, f0i0, vmask0, forms0, sr0, ylen0 = load_features(feat_path)
    total_len = int(ylen0)

    a = max(0, min(int(start_sample), total_len))
    b = max(a, min(int(end_sample), total_len))

    if snippet_was_reversed:
        a_orig = total_len - b
        b_orig = total_len - a
        edited_local = np.asarray(edited_mask[::-1], dtype=np.float32)
    else:
        a_orig, b_orig = a, b
        edited_local = np.asarray(edited_mask, dtype=np.float32)

    span = b_orig - a_orig
    if span <= 0:
        return
    if edited_local.shape[0] != span:
        if edited_local.shape[0] > span:
            edited_local = edited_local[:span]
        else:
            edited_local = np.pad(edited_local,
                                  (0, span - edited_local.shape[0]),
                                  mode="edge")

    vmask_new = np.array(vmask0, dtype=np.float32, copy=True)
    vmask_new[a_orig:b_orig] = edited_local

    save_features_atomic(feat_path, env0, f0i0, vmask_new, forms0, sr0,
                         total_len)


def paint_mask_span(mask: np.ndarray, a: int, b: int,
                    voiced: bool) -> np.ndarray:
    """Paint samples [a, b) voiced/unvoiced (ref: SillyEditor.py:339-352)."""
    out = np.asarray(mask, dtype=np.float32).copy()
    out[max(0, a):max(0, b)] = 1.0 if voiced else 0.0
    return out


def apply_f0_brush(f0: np.ndarray, mask: np.ndarray,
                   brush_hz: float) -> np.ndarray:
    """Write a constant F0 into voiced spans, zero elsewhere — the F0 brush
    slider (ref: SillyEditor.py:149-164), brush clamped to [50, 500] Hz."""
    brush_hz = float(np.clip(brush_hz, 50.0, 500.0))
    out = np.asarray(f0, dtype=np.float32).copy()
    voiced = np.asarray(mask) > 0.5
    out[voiced] = brush_hz
    out[~voiced] = 0.0
    return out


def fill_f0_for_painted_voicing(f0_seg: np.ndarray, mask_seg: np.ndarray,
                                f0_global: np.ndarray | None = None,
                                seg_mid: int = 0,
                                default_hz: float = 120.0) -> np.ndarray:
    """Where the user painted voicing but no F0 exists, fill from nearby
    voiced values (interpolated), from the nearest globally voiced sample,
    or from 120 Hz (ref: SillyEditor.py:186-210)."""
    f0_seg = np.asarray(f0_seg, dtype=np.float32).copy()
    need = (np.asarray(mask_seg) > 0.5) & (f0_seg <= 0.0)
    if not np.any(need):
        return f0_seg
    idx = np.arange(len(f0_seg))
    known = f0_seg > 0.0
    if np.any(known):
        interp = np.interp(idx, idx[known], f0_seg[known],
                           left=float(f0_seg[known][0]),
                           right=float(f0_seg[known][-1])).astype(np.float32)
    else:
        base = default_hz
        if f0_global is not None:
            gk = np.asarray(f0_global) > 0.0
            if np.any(gk):
                voiced_idx = np.where(gk)[0]
                nearest = voiced_idx[np.argmin(np.abs(voiced_idx - seg_mid))]
                base = float(np.asarray(f0_global)[nearest])
        interp = np.full(len(f0_seg), base, dtype=np.float32)
    f0_seg[need] = interp[need]
    return f0_seg
