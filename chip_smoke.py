#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (goofer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernel (csrc/pulse_accumulate.cu) with
   nvcc into build/goofer_tpu_torch/ and print the build time;
3. check the kernel against its plain PyTorch version on the card at the
   note render's shapes (B=1, n=40000 and B=8), max |diff| <= 1e-4, and
   time both (CUDA events, median of 20 warm calls);
4. render the 8 golden configs through goofer_tpu_torch.cli.main on
   CUDA from the vendored .goofy caches: each output must be finite, of
   the golden's length and within its golden's LSD budget; the pulse
   kernel's launch counter must rise; print the warm per-note time;
5. print the kernel summary as one JSON line, then the device line.

Imports nothing of JAX or goofer_tpu.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from goofer_tpu_torch import cli, config
from goofer_tpu_torch.ops import pulse
from goofer_tpu_torch.ops.cuda import pulse_kernel
from goofer_tpu_torch.utils.audio_io import read_wav
from goofer_tpu_torch.utils.metrics import lsd_db

REPO = Path(__file__).resolve().parent

# LSD budgets (dB) per golden config, copied from tests/test_golden.py
# (REF_LSD_BUDGET_DB and VOICE_LSD_BUDGET_DB: each config's measured
# upstream seed-to-seed LSD floor + 0.5 dB); that module imports JAX.
LSD_BUDGET_DB = {
    "neutral": 0.76 + 0.5,
    "loops_l0": 0.72 + 0.5,
    "loops_l1": 0.85 + 0.5,
    "loops_l2_rev": 0.76 + 0.5,
    "formant_chain": 1.04 + 0.5,
    "voice_neutral": 0.70 + 0.5,
    "voice_shift_loop": 0.65 + 0.5,
    "voice_formants": 0.71 + 0.5,
}
# both sides float32, at most K terms of size <= 1: room for CUDA vs ATen
# transcendental rounding only
PULSE_TOL = 1e-4
SR = 44100
N_CHECK = 40000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` warm calls, timed with CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _pulse_cases():
    """(name, f0 (B, n), mask or None) at the note render's shapes; the
    constant and glide cases follow tests/test_pallas_pulse.py."""
    n = N_CHECK
    t = np.arange(n) / SR
    cases = []
    for hz in (220.3, 97.1):
        f0 = np.full(n, hz, dtype=np.float32)
        f0[: n // 8] = 0.0
        cases.append((f"const_{hz}", f0[None], None))
    glide = (200.0 * 2 ** (0.4 * np.sin(2 * np.pi * 2.0 * t))).astype(
        np.float32)
    glide[int(0.3 * n): int(0.45 * n)] = 0.0
    cases.append(("glide_gap", glide[None], None))
    cases.append(("silence", np.zeros((1, n), np.float32), None))
    mask = (glide > 0).astype(np.float32)
    cases.append(("subharm", (2.0 * glide)[None], mask[None]))
    rng = np.random.default_rng(0)
    base = rng.uniform(90.0, 600.0, size=(8, 1))
    batch = (base * 2 ** (0.2 * np.sin(2 * np.pi * rng.uniform(1, 6, (8, 1))
                                       * t[None]))).astype(np.float32)
    batch[:, : n // 10] = 0.0
    cases.append(("batch8", batch, None))
    return cases


def check_pulse_kernel():
    """Kernel vs plain version on the card, every case; returns (worst
    max |diff|, kernel ms, plain ms), the times of the B=1 glide case."""
    pulse_accumulate = pulse_kernel.pulse_accumulate
    dev = torch.device("cuda")
    worst = 0.0
    timed = None
    for name, f0_np, mask_np in _pulse_cases():
        f0 = torch.as_tensor(f0_np, device=dev)
        if mask_np is None:
            # main layer: guard=True, bounds derived as the resampler does
            hi = max(float(f0_np.max()), config.PULSE_FALLBACK_F0)
            lo = min(float(f0_np[f0_np > 0].min()) if (f0_np > 0).any()
                     else hi, config.PULSE_FALLBACK_F0)
            k = config.bucket_overlap(int(min(32, max(
                3, np.ceil(0.804 * hi / lo) + 2))))
            spacing = config.bucket_min_spacing(int(SR / hi))
            onset = pulse._onsets_from_phase(
                torch.cumsum(f0.double() / SR, dim=-1))
            tables = pulse._compact_onset_tables(
                onset, f0, f0 > 1e-6, config.PULSE_FALLBACK_F0, SR,
                0.02, 1.7, 0.8, True, spacing)
            shape = (0.02, 1.7, 0.8, True, k)
        else:
            # subharmonic layer: guard=False, Rk 1.0, K 8, spacing 8
            acc = torch.as_tensor(mask_np, device=dev).bool() & (f0 >= 1e-2)
            phase = torch.cumsum(torch.where(acc, f0.double() / SR, 0.0),
                                 dim=-1)
            onset = pulse._onsets_from_phase(phase) & acc
            tables = pulse._compact_onset_tables(
                onset, f0, acc, config.PULSE_FALLBACK_F0 * 2.0, SR,
                0.02, 1.7, 1.0, False, 8)
            shape = (0.02, 1.7, 1.0, False, 8)
        got = pulse_accumulate(*tables, *shape)
        want = pulse.accumulate_pulses_plain(*tables, *shape)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"pulse kernel {name}: non-finite output")
        err = float((got - want).abs().max())
        if name == "silence" and float(got.abs().max()) != 0.0:
            raise AssertionError("pulse kernel silence: nonzero output")
        ms = cuda_ms(lambda: pulse_accumulate(*tables, *shape))
        plain_ms = cuda_ms(
            lambda: pulse.accumulate_pulses_plain(*tables, *shape))
        print(f"pulse_accumulate {name}: B={tuple(f0.shape)[0]} "
              f"n={f0.shape[-1]} M={tables[1].shape[-1]} K={shape[-1]} "
              f"max|diff|={err:.3e} kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms")
        if not err <= PULSE_TOL:
            raise AssertionError(f"pulse kernel {name}: max |diff| {err} "
                                 f"> {PULSE_TOL}")
        worst = max(worst, err)
        if name == "glide_gap":
            timed = (ms, plain_ms)
    return worst, timed[0], timed[1]


def _golden_configs():
    spec = importlib.util.spec_from_file_location(
        "make_goldens", REPO / "tools" / "make_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = [("ref", c) for c in mod.CONFIGS if c[0] in LSD_BUDGET_DB]
    voice = [("voice", c) for c in mod.VOICE_CONFIGS if c[0] in LSD_BUDGET_DB]
    return ref + voice


def render_slice(tmp: Path):
    """Render every golden config twice through the CLI on CUDA; checks
    the second pass's outputs and returns warm per-note seconds."""
    os.environ["GOOFER_TPU_TORCH_DEVICE"] = "cuda"
    for kind in ("ref", "voice"):
        src = REPO / "tests" / "golden" / kind
        shutil.copy(src / "src.wav", tmp / f"{kind}.wav")
        shutil.copy(src / "src_features.goofy", tmp / f"{kind}_features.goofy")
    configs = _golden_configs()
    if sorted(c[0] for _, c in configs) != sorted(LSD_BUDGET_DB):
        raise AssertionError("golden configs missing from tools/make_goldens")

    warm = {}
    for rep in range(2):
        for kind, (name, *args) in configs:
            out = tmp / f"out_{name}.wav"
            argv = [str(tmp / f"{kind}.wav"), str(out)] + [str(a) for a in args]
            t0 = time.perf_counter()
            rc = cli.main(argv)
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"render {name}: cli rc {rc}")
            if rep == 0:
                continue
            warm[name] = dt
            ours, sr = read_wav(out)
            golden, sr_g = read_wav(REPO / "tests" / "golden" / kind
                                    / f"out_{name}.wav")
            if sr != sr_g or len(ours) != len(golden):
                raise AssertionError(f"render {name}: {len(ours)} samples "
                                     f"at {sr} Hz, golden {len(golden)}")
            if not np.isfinite(ours).all():
                raise AssertionError(f"render {name}: non-finite output")
            lsd = lsd_db(np.asarray(ours, np.float32),
                         np.asarray(golden, np.float32), sr)
            print(f"render {name}: {len(ours)} samples, LSD {lsd:.3f} dB "
                  f"(budget {LSD_BUDGET_DB[name]:.2f}), warm "
                  f"{dt * 1e3:.1f} ms")
            if not lsd <= LSD_BUDGET_DB[name]:
                raise AssertionError(f"render {name}: LSD {lsd} dB over "
                                     f"budget {LSD_BUDGET_DB[name]}")
    return warm


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = pulse_kernel.build()
    print(f"build {lib.name}: {time.perf_counter() - t0:.2f} s")

    err, ms, plain_ms = check_pulse_kernel()

    pulse_kernel.pulse_accumulate.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        warm = render_slice(Path(tmp))
    launches = pulse_kernel.pulse_accumulate.launches
    if launches <= 0:
        raise AssertionError("the render never launched the pulse kernel")
    print(f"render: {len(warm)} configs, warm per-note median "
          f"{statistics.median(warm.values()) * 1e3:.1f} ms, max "
          f"{max(warm.values()) * 1e3:.1f} ms; pulse kernel launches "
          f"{launches}")

    print(json.dumps({"kernels": [{
        "name": "pulse_accumulate",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/pulse_accumulate.cu",
        "replaces": "goofer_tpu/ops/pallas/pulse_kernel.py:61",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
