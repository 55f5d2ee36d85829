"""Engine self-test / demo harness of the PyTorch/CUDA port.

The port's counterpart of examples/engine_selftest.py, which is the
reference engine's __main__ block (ref: GOOFER.py:1222-1330): analyse a
WAV, resynthesize it at n_fft 2048 / hop 512 through
goofer_tpu_torch.compat, print wall-clock timings after one warm pass
(kernel builds and first calls excluded, like the reference's Numba
warmup), and write the four stems next to the input.

Usage:  python examples/engine_selftest_torch.py [input.wav] [--dump-features]

Runs on the CUDA card; ``GOOFER_TPU_TORCH_DEVICE=cpu`` runs the kernels'
plain PyTorch versions on the CPU instead.  Without an argument it reads
``_input.wav``, and a synthetic test tone is generated first where that
file is missing.  ``--dump-features`` additionally writes the fp16
compressed feature NPZ with the reference's keys (ref:
GOOFER.py:1306-1321, the ``save_feature`` toggle, disabled by default
upstream too).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import goofer_tpu_torch.compat as gf  # noqa: E402
from goofer_tpu_torch import config  # noqa: E402
from goofer_tpu_torch.utils.audio_io import (  # noqa: E402
    read_wav_mono,
    write_wav,
)


def _ensure_input(path: str) -> str:
    if os.path.exists(path):
        return path
    sr = 44100
    n = int(2.0 * sr)
    t = np.arange(n) / sr
    f0 = 200.0 * 2 ** (0.25 * np.sin(2 * np.pi * 0.8 * t))
    phase = np.cumsum(f0 / sr)
    y = 0.4 * (2 * (phase % 1.0) - 1.0)
    y = np.convolve(y, np.ones(6) / 6.0, mode="same")
    write_wav(path, y.astype(np.float32), sr)
    print(f"(generated synthetic input: {path})")
    return path


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dump_features = "--dump-features" in argv
    argv = [a for a in argv if a != "--dump-features"]
    input_file = _ensure_input(argv[0] if argv else "_input.wav")
    name = os.path.splitext(input_file)[0]

    y, sr = read_wav_mono(input_file)
    n_fft = config.ENGINE_N_FFT
    hop = config.ENGINE_HOP
    print(f"device: {config.get_device()}")

    # warm pass (kernel builds, first calls), mirroring the reference's
    # Numba warmup
    env, f0i, vmask, forms, knots = gf.extract_features(
        y, sr, n_fft=n_fft, hop_length=hop)
    gf.synthesize(env, f0i, vmask, y, sr, n_fft=n_fft, hop_length=hop,
                  formants=forms)

    # both calls return host NumPy arrays, so each timing ends after the
    # device has finished
    t0 = time.perf_counter()
    env, f0i, vmask, forms, knots = gf.extract_features(
        y, sr, n_fft=n_fft, hop_length=hop)
    t1 = time.perf_counter()
    print(f"Feature extraction: {t1 - t0:.3f} s")

    reconstruct, harmonic, aper_uv, aper_bre = gf.synthesize(
        env, f0i, vmask, y, sr, n_fft=n_fft, hop_length=hop,
        formants=forms)
    t2 = time.perf_counter()
    print(f"Synthesis: {t2 - t1:.3f} s")
    print(f"Time taken: {t2 - t0:.3f} s "
          f"({len(y) / sr / (t2 - t0):.1f}x realtime)")

    for tag, stem in (("reconstruct", reconstruct), ("harmonic", harmonic),
                      ("unvoiced", aper_uv), ("breathiness", aper_bre)):
        write_wav(f"{name}_{tag}.wav", stem, sr)
    print(f"Reconstructed audio saved: {name}_reconstruct.wav")

    if dump_features:
        # fp16 compressed feature dump, key-for-key with the reference's
        # save_feature block (ref: GOOFER.py:1306-1321)
        np.savez_compressed(
            f"{name}_features.npz",
            env_spec=np.asarray(env, dtype=np.float16),
            f0_interp=np.asarray(f0i, dtype=np.float16),
            voicing_mask=np.asarray(vmask, dtype=np.float16),
            formants=forms,
            sr=np.array([sr]),
            y_len=np.array([len(y)]),
        )
        print(f"Saved feature set: {name}_features.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
