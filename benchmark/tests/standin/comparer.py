"""The stand-in's comparer: each kept cut's frame RMS against a plain
float64 one of the WAV it read; ``rms_frame_gap`` is the widest gap over
the cut's loudest frame.  Its control takes the frame RMS in bfloat16,
one precision below the configuration's float32."""
from __future__ import annotations

import numpy as np

UNREADABLE = 1e9


def reference(x: np.ndarray, frame: int) -> np.ndarray:
    n = len(x) // frame
    f = x[:n * frame].astype(np.float64) / 32768.0
    return np.sqrt((f.reshape(n, frame) ** 2).mean(axis=1))


def worst(records: list, pool, config: dict, entry, device) -> dict:
    from scipy.io import wavfile

    gap = 0.0
    for r in records:
        want = reference(wavfile.read(r["input"])[1], config["frame"])
        got = np.load(r["path"])
        if got.shape != want.shape:
            gap = max(gap, UNREADABLE)
            continue
        gap = max(gap, float(np.abs(got - want).max() / want.max()))
    return {"rms_frame_gap": gap}


def control(records: list, pool, config: dict, entry, device) -> dict:
    import torch
    from scipy.io import wavfile

    frame = config["frame"]
    for r in records:
        x = torch.from_numpy(wavfile.read(r["input"])[1]).to(device)
        x = (x.float() / 32768.0).to(torch.bfloat16)
        n = len(x) // frame
        low = x[:n * frame].view(n, frame).square().mean(1).sqrt()
        np.save(r["path"], low.float().cpu().numpy())
    return worst(records, pool, config, entry, device)
