#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (goofer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels (csrc/pulse_accumulate.cu and
   csrc/one_pole_cascade.cu), one nvcc each, started together, into
   build/goofer_tpu_torch/ and print the build time;
3. check the pulse kernel (the whole pulse pass: f0 in, pulse train out)
   against its plain PyTorch version on the card at the note render's
   shapes (B=1 and B=8 at n=40000, the longest note's n=48510, onsets at
   the kernel's run, warp, CTA and tile edges over two tiles; main and
   gated passes; a silent row must give exact zeros), max |diff| <= 1e-4,
   print each case's onset-phase margin and bound, and time both;
4. check the cascade kernel the same way (B=1 and the B=2 fry pair at
   n=40000; HP orders 1, 6 and 12, LP orders 4 and 6; the order-12 layer
   at n=48510, the longest note, and 262144; a silent row must give exact
   zeros), max |diff| <= 1e-4 x max|x|, and cross-check one kernel time
   against torch.profiler's device time;
5. render the 12 golden configs and the heavy 11-flag stack through
   goofer_tpu_torch.cli.main on CUDA from the vendored .goofy caches:
   each golden must be finite, of the golden's length and within its
   golden's LSD budget; both kernels' launch counters must rise, 4 pulse
   and 5 cascade launches per heavy note; print each config's warm
   per-note time and launches per note;
6. hold the heavy stack against the port's own CPU render of the same
   note (it is stochastic: LSD <= max(1 dB, CPU seed-to-seed + 0.5 dB));
7. profile 5 warm heavy-stack renders under torch.profiler: device busy
   ms, idle share, device kernels per note, each kernel's device ms per
   note and its share of device busy; no scan or searchsorted kernel of
   the old pulse-table build may appear;
8. print the kernel summary as one JSON line, then the device line.

Kernel times are device time per launch: a run of ``TIMED_REPS``
launches between one pair of CUDA events, enqueued behind a spin kernel
(torch.cuda._sleep) so that the device never waits on the Python
wrapper.  Each kernel's bound is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM's published peaks.

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
from goofer_tpu_torch.ops import pulse, scan_iir
from goofer_tpu_torch.ops.cuda import _build, cascade_kernel, pulse_kernel
from goofer_tpu_torch.sampler.resampler import GooferResampler
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
    "texture": 2.20 + 0.5,
    "fry_full": 0.85 + 0.5,
    "voice_texture": 1.38 + 0.5,
    "voice_fry": 0.79 + 0.5,
}
# both sides float32, at most K terms of size <= 1: room for CUDA vs ATen
# transcendental rounding only
PULSE_TOL = 1e-4
# relative to max|x|: two float32 scans of the same recurrences in other
# association orders (the kernel's cluster scan of run maps, the plain
# version's doubling steps); HP cascades near alpha = 1 amplify rounding
CASCADE_TOL = 1e-4
# the phrase bench's heavy 11-flag stack (tests/test_phrase.py), on the
# voice source at voice_texture's geometry
HEAVY = ("heavy_stack", "C4", 100,
         "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50", 100, 900, 200,
         0, 100, 0, "!120", "AA")
HEAVY_CASCADE_LAUNCHES = 5
HEAVY_PULSE_LAUNCHES = 4
SR = 44100
N_CHECK = 40000
# the voice source's notes, the longest on the main path
N_LONG = 48510
# launches per kernel timing; the plain versions run tens to thousands of
# small ops per call and get fewer
TIMED_REPS = 100
PLAIN_REPS = 10
# ~10 ms of device spin ahead of each timed run, longer than the host
# takes to enqueue it (checked)
SPIN_CYCLES = 20_000_000
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# operations of the pulse kernel: per live (sample, onset row) pair the
# phase division and tests, one sinf or expf + cosf (about 20 each with
# range reduction), the normalising division and the add; per sample the
# scan work (scale, tests, the float64 phase division and add, floor,
# the scans' shares); per onset its table row (reciprocal, rint, the grid
# peak's two LF evaluations)
PULSE_OPS_PER_PAIR = 30
PULSE_OPS_PER_SAMPLE = 20
PULSE_OPS_PER_ONSET = 60
# device kernels of the old eager pulse-table build in ops/pulse.py:
# torch.cumsum (CUB's DeviceScan), cummax (ATen's scan with indices) and
# searchsorted; no other op of the render runs them
TABLE_BUILD_KERNELS = ("DeviceScan", "scan_innermost_dim", "scan_outer_dim",
                       "searchsorted")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = TIMED_REPS, gap_free: bool = True) -> float:
    """Device ms per call of ``fn``: ``reps`` warm calls between one pair
    of CUDA events, enqueued behind a spin kernel.  With ``gap_free`` it
    raises if the host took longer to enqueue them than the spin lasted,
    since the device would then have waited on the host."""
    fn()
    torch.cuda.synchronize()
    spin, start, stop = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    spin_ms = spin.elapsed_time(start)
    if gap_free and not host_ms < spin_ms:
        raise AssertionError(f"enqueueing {reps} calls took {host_ms:.2f} "
                             f"ms, longer than the {spin_ms:.2f} ms spin: "
                             "the device waited on the host")
    return start.elapsed_time(stop) / reps


def device_events(prof):
    """The profile's device-side events (kernels, copies, memsets)."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return events


def profiler_ms(fn, kernel: str, reps: int = TIMED_REPS) -> float:
    """Mean device time of ``kernel`` per call of ``fn`` from
    torch.profiler, the cross-check of cuda_ms."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in device_events(prof)
             if kernel in e.name]
    if len(times) != reps:
        raise AssertionError(f"torch.profiler saw {len(times)} launches of "
                             f"{kernel}, expected {reps}")
    return sum(times) / reps / 1e3


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time for the work on an H100 SXM, and what bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def f0_with_onsets(positions, n: int, sr: float = SR) -> np.ndarray:
    """An f0 track whose float64 phase crosses an integer exactly at the
    given samples, and at no other: between onsets at p_a < p_b the phase
    runs k + (i - p_a + 0.5) / (p_b - p_a), so each crossing clears its
    integer by 0.5 / (p_b - p_a) of a cycle, far from any tie."""
    phase = np.zeros(n)
    ends = list(positions) + [n + max(1, n - positions[-1])]
    i = np.arange(n)
    first = i < positions[0]
    phase[first] = (i[first] + 0.5) / (positions[0] + 1)
    for k, (a, b) in enumerate(zip(ends[:-1], ends[1:]), start=1):
        span = (i >= a) & (i < b)
        phase[span] = k + (i[span] - a + 0.5) / (b - a)
    return (np.diff(phase, prepend=0.0) * sr).astype(np.float32)


def kernel_edges(n: int) -> list[int]:
    """Onset samples at the pulse kernel's run, warp, CTA and tile edges
    for an n-sample row (one before and at each), among fillers every 173
    samples."""
    run = pulse_kernel.RUN
    tile, seg = pulse_kernel.tile_geometry(n)
    edges = set(range(150, n - 1, 173))
    for e in (run, 32 * run, seg, 3 * seg + 32 * run, tile, tile + 5 * seg,
              2 * tile):
        edges.update((e - 1, e))
    return sorted(x for x in edges if 0 <= x < n)


def pulse_pass_args(f0_np: np.ndarray, gated: bool) -> tuple:
    """The pass's scalars after f0 and gate: (sr, scale, fallback_f0, Ra,
    Rg, Rk, guard, K, min_spacing).  Main pass as the resampler derives
    them for the main layer (K and spacing from the pitch range);
    gated pass as the sg layer's semitone +12 (ratio 2, K 8, spacing 8)."""
    if gated:
        return (SR, 2.0, config.PULSE_FALLBACK_F0 * 2.0, 0.02, 1.7, 1.0,
                False, 8, 8)
    voiced = f0_np[f0_np > 0]
    hi = max(float(voiced.max()) if voiced.size else 0.0,
             config.PULSE_FALLBACK_F0)
    lo = min(float(voiced.min()) if voiced.size else hi,
             config.PULSE_FALLBACK_F0)
    k = config.bucket_overlap(int(min(32, max(3, np.ceil(0.804 * hi / lo)
                                              + 2))))
    spacing = config.bucket_min_spacing(int(SR / hi))
    return (SR, 1.0, config.PULSE_FALLBACK_F0, 0.02, 1.7, 0.8, True, k,
            spacing)


def phase_margin(f0: torch.Tensor, gate, sr: float, scale: float) -> float:
    """The least distance of the plain version's float64 phase to an
    integer over samples where the phase is not 0 (inf if none): an onset
    decision can flip between the kernel's and torch.cumsum's association
    orders only within ~1e-12 of an integer."""
    phase = pulse.pass_phase(f0, gate, sr, scale)[2]
    phase = phase[phase != 0]
    if phase.numel() == 0:
        return float("inf")
    return float((phase - torch.round(phase)).abs().min())


def exact_onsets(f0_row: np.ndarray, sr: float) -> np.ndarray:
    """Main-pass onsets of one row from the exact sum of its float64 phase
    steps, each an int with 64 fraction bits as the kernel adds them: the
    kernel's onsets where the float64 cumsum of the plain version lies
    within rounding of an integer."""
    d = np.asarray(f0_row, np.float32).astype(np.float64) / sr
    phase = np.cumsum(np.array([int(x * 2.0 ** 64) for x in d], object))
    cyc = np.array([int(x) >> 64 for x in phase])
    return cyc > np.concatenate([[0], cyc[:-1]])


def exact_phase_plain(f0: torch.Tensor, args) -> torch.Tensor:
    """The plain main pass on exact-phase onsets (exact_onsets)."""
    sr, scale, fallback, ra, rg, rk, guard, k, spacing = args
    onset = torch.as_tensor(np.stack([exact_onsets(r, sr) for r in
                                      (f0 * scale).cpu().numpy()]),
                            device=f0.device)
    sub = f0 * scale
    tables = pulse._compact_onset_tables(onset, sub, sub > 1e-6, fallback,
                                         sr, ra, rg, rk, guard, spacing)
    return pulse.accumulate_pulses_plain(*tables, ra, rg, rk, guard, k)


def _pulse_cases():
    """(name, f0 (B, n), gate or None) at the note render's shapes; the
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
    cases.append(("subharm", glide[None], mask[None]))
    rng = np.random.default_rng(0)
    base = rng.uniform(90.0, 600.0, size=(8, 1))
    batch = (base * 2 ** (0.2 * np.sin(2 * np.pi * rng.uniform(1, 6, (8, 1))
                                       * t[None]))).astype(np.float32)
    batch[:, : n // 10] = 0.0
    cases.append(("batch8", batch, None))
    t_long = np.arange(N_LONG) / SR
    long = (180.0 * 2 ** (0.3 * np.sin(2 * np.pi * 3.0 * t_long))).astype(
        np.float32)
    long[: N_LONG // 9] = 0.0
    cases.append((f"glide_{N_LONG}", long[None], None))
    n_edges = 2 * pulse_kernel.TILE + 777
    cases.append(("edges", f0_with_onsets(kernel_edges(n_edges),
                                          n_edges)[None], None))
    # the voice goldens' constant pitches: the phase comes within 1e-13 of
    # an integer every 11 periods at 220 Hz, at every period at 441 Hz
    ties = np.stack([np.full(N_LONG, hz, np.float32)
                     for hz in (220.0, 441.0, 110.25)])
    cases.append(("ties", ties, None))
    return cases


def _pulse_work(tables, max_overlap) -> tuple[int, int]:
    """(live (sample, onset row) pairs, table rows) of a pass on this
    data: pairs j = row - k for k < K inside the table, with 0 <= i -
    pos[j] < T0[j]; rows, the onsets that get one (at most M per row)."""
    row, pos_tab, t0_tab = tables[:3]
    n = row.shape[-1]
    t = torch.arange(n, device=row.device, dtype=torch.float32)
    live = 0
    for k in range(max_overlap):
        j = row.long() - k
        ok = (j >= 0) & (j < pos_tab.shape[-1])
        j = j.clamp(0, pos_tab.shape[-1] - 1)
        offs = t - torch.gather(pos_tab, 1, j)
        ok &= (offs >= 0) & (offs < torch.gather(t0_tab, 1, j))
        live += int(ok.sum())
    return live, int(torch.clamp(row[:, -1] + 1, max=pos_tab.shape[-1]).sum())


def check_pulse_kernel():
    """Kernel vs plain version on the card, every case; returns the worst
    max |diff| and each case's (B, n, gated, K, kernel ms, plain ms,
    bound ms, what bounds it)."""
    pulse_accumulate = pulse_kernel.pulse_accumulate
    dev = torch.device("cuda")
    worst = 0.0
    rows = {}
    for name, f0_np, gate_np in _pulse_cases():
        f0 = torch.as_tensor(f0_np, device=dev)
        gate = None if gate_np is None else torch.as_tensor(gate_np,
                                                            device=dev)
        args = pulse_pass_args(f0_np, gate is not None)
        got = pulse_accumulate(f0, gate, *args)
        # at phase ties the kernel's exact phase decides
        want = (exact_phase_plain(f0, args) if name == "ties"
                else pulse.pulse_pass_plain(f0, gate, *args))
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"pulse kernel {name}: non-finite output")
        err = float((got - want).abs().max())
        if name == "silence" and float(got.abs().max()) != 0.0:
            raise AssertionError("pulse kernel silence: nonzero output")
        ms = cuda_ms(lambda: pulse_accumulate(f0, gate, *args))
        # the plain versions may wait on the host
        p_ms = cuda_ms(lambda: pulse.pulse_pass_plain(f0, gate, *args),
                       PLAIN_REPS, gap_free=False)
        batch, n = f0.shape
        k, spacing = args[-2:]
        tables = pulse.pulse_pass_tables(f0, gate, *args[:-2], spacing)
        pairs, onsets = _pulse_work(tables, k)
        margin = phase_margin(f0, gate, args[0], args[1])
        # f0 (and gate) read once, out written once
        bound, bound_by = bound_ms(
            4 * (2 + (gate is not None)) * batch * n,
            PULSE_OPS_PER_PAIR * pairs + PULSE_OPS_PER_SAMPLE * batch * n
            + PULSE_OPS_PER_ONSET * onsets)
        print(f"pulse_accumulate {name}: B={batch} n={n} "
              f"{'gated' if gate is not None else 'main'} K={k} "
              f"spacing={spacing} M={pulse_kernel.table_rows(n, spacing)} "
              f"onsets {onsets} live pairs {pairs} phase margin "
              f"{margin:.3e} max|diff|={err:.3e} kernel {ms:.5f} ms plain "
              f"{p_ms:.4f} ms bound {bound:.6f} ms ({bound_by})")
        if not err <= PULSE_TOL:
            raise AssertionError(f"pulse kernel {name}: max |diff| {err} "
                                 f"> {PULSE_TOL}")
        worst = max(worst, err)
        rows[name] = (batch, n, gate is not None, k, ms, p_ms, bound,
                      bound_by)
        if name == "glide_gap":
            prof = profiler_ms(lambda: pulse_accumulate(f0, gate, *args),
                               "pulse_accumulate_kernel")
            print(f"pulse_accumulate {name}: torch.profiler device time "
                  f"{prof:.5f} ms per launch (CUDA events {ms:.5f} ms)")
    return worst, rows


def _voiced_signal(n: int, rng):
    """A gliding f0 track with an unvoiced gap and a pulse-like voiced
    signal with a noise floor, peak ~1, at n samples."""
    t = np.arange(n) / SR
    f0 = (200.0 * 2 ** (0.4 * np.sin(2 * np.pi * 2.0 * t))).astype(
        np.float32)
    f0[int(0.3 * n): int(0.45 * n)] = 0.0
    phase = np.cumsum(f0 / SR)
    x = (np.sin(2 * np.pi * phase) ** 15 * 0.8
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    return x, torch.as_tensor(f0)


def _layer_alpha(f0: torch.Tensor) -> np.ndarray:
    """The su/sj layer highpass coefficients: cutoff max(f0, 120) Hz."""
    return scan_iir.butter_alpha(torch.clamp(f0, min=120.0), f0.shape[0],
                                 SR, 1.0, "highpass").numpy()


def cascade_cases():
    """(name, x (B, n), alpha (n,), order, btype) at the note render's
    shapes and coefficient rules: the su/sj layer highpass (cutoff
    max(f0, 120) Hz, order 6 and its doubled order-12 form, also at the
    longest note's n and at 262144 samples, four tiles of the kernel),
    st tension lowpasses, one_pole_highpass's constant coefficient, the
    B=2 fry pair at 200 Hz and a silent row."""
    n = N_CHECK
    rng = np.random.default_rng(1)
    x, f0_t = _voiced_signal(n, rng)

    def alpha(f0_track, factor, btype):
        return scan_iir.butter_alpha(f0_track, n, SR, factor,
                                     btype).numpy()

    hp_layer = _layer_alpha(f0_t)
    rc = 1.0 / (2.0 * np.pi * 320.0)
    const = np.full(n, rc / (rc + 1.0 / SR), dtype=np.float32)
    pair = np.stack([x, rng.standard_normal(n).astype(np.float32) * 0.1])
    cases = [
        ("hp6_layer", x[None], hp_layer, 6, "highpass"),
        ("hp12_layer", x[None], hp_layer, 12, "highpass"),
        ("lp4_tension", x[None], alpha(f0_t, 2.0 - 0.3 * 0.75, "lowpass"),
         4, "lowpass"),
        ("lp6_tension", x[None], alpha(f0_t, (2.0 - 0.3) / 0.5, "lowpass"),
         6, "lowpass"),
        ("hp1_const", x[None], const, 1, "highpass"),
        ("hp6_fry_pair", pair, alpha(torch.ones(n), 200.0, "highpass"), 6,
         "highpass"),
        ("silence", np.zeros((1, n), np.float32), hp_layer, 12, "highpass"),
    ]
    for n_long in (N_LONG, 262144):
        x_long, f0_long = _voiced_signal(n_long, rng)
        cases.append((f"hp12_layer_{n_long}", x_long[None],
                      _layer_alpha(f0_long), 12, "highpass"))
    return cases


def check_cascade_kernel():
    """Kernel vs plain version on the card, every case; returns the worst
    max |diff|, the worst max |diff| / max|x| and each case's (B, n,
    order, btype, kernel ms, plain ms, bound ms, what bounds it)."""
    cascade = cascade_kernel.one_pole_cascade
    dev = torch.device("cuda")
    worst = worst_rel = 0.0
    rows = {}
    for name, x_np, alpha_np, order, btype in cascade_cases():
        x = torch.as_tensor(x_np, device=dev)
        alpha = torch.as_tensor(alpha_np, device=dev)
        got = cascade(x, alpha, order, btype)
        want = scan_iir.one_pole_cascade_plain(x, alpha, order, btype)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"cascade kernel {name}: non-finite output")
        if name == "silence" and float(got.abs().max()) != 0.0:
            raise AssertionError("cascade kernel silence: nonzero output")
        err = float((got - want).abs().max())
        rel = err / max(float(x.abs().max()), 1e-30)
        ms = cuda_ms(lambda: cascade(x, alpha, order, btype))
        p_ms = cuda_ms(
            lambda: scan_iir.one_pole_cascade_plain(x, alpha, order, btype),
            PLAIN_REPS, gap_free=False)
        # x read and out written once per row, alpha once (shared or per
        # row); 3 flops per sample and stage
        batch, n = x.shape
        alpha_rows = batch if alpha.ndim == 2 else 1
        bound, bound_by = bound_ms(4 * (2 * batch * n + alpha_rows * n),
                                   3 * order * batch * n)
        print(f"one_pole_cascade {name}: B={batch} n={n} order={order} "
              f"{btype} max|diff|={err:.3e} max|diff|/max|x|={rel:.3e} "
              f"kernel {ms:.5f} ms plain {p_ms:.4f} ms bound {bound:.5f} ms "
              f"({bound_by})")
        if not rel <= CASCADE_TOL:
            raise AssertionError(f"cascade kernel {name}: max |diff| / "
                                 f"max|x| {rel} > {CASCADE_TOL}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, rel)
        rows[name] = (batch, n, order, btype, ms, p_ms, bound, bound_by)
        if name == "hp12_layer":
            prof = profiler_ms(lambda: cascade(x, alpha, order, btype),
                               "one_pole_cascade_kernel")
            print(f"one_pole_cascade {name}: torch.profiler device time "
                  f"{prof:.5f} ms per launch (CUDA events {ms:.5f} ms)")
    return worst, worst_rel, rows


def _golden_configs():
    spec = importlib.util.spec_from_file_location(
        "make_goldens", REPO / "tools" / "make_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = [("ref", c) for c in mod.CONFIGS if c[0] in LSD_BUDGET_DB]
    voice = [("voice", c) for c in mod.VOICE_CONFIGS if c[0] in LSD_BUDGET_DB]
    return ref + voice


# configs whose flags (su, sj, vf, st) run the cascade kernel
CASCADE_CONFIGS = ("texture", "fry_full", "voice_texture", "voice_fry",
                   HEAVY[0])


def _launches():
    return (pulse_kernel.pulse_accumulate.launches,
            cascade_kernel.one_pole_cascade.launches)


def render_slice(tmp: Path):
    """Render every golden config and the heavy stack twice through the
    CLI on CUDA; checks the second pass's outputs and returns the warm
    per-note seconds and (pulse, cascade) launches per note."""
    os.environ["GOOFER_TPU_TORCH_DEVICE"] = "cuda"
    for kind in ("ref", "voice"):
        src = REPO / "tests" / "golden" / kind
        shutil.copy(src / "src.wav", tmp / f"{kind}.wav")
        shutil.copy(src / "src_features.goofy", tmp / f"{kind}_features.goofy")
    configs = _golden_configs()
    if sorted(c[0] for _, c in configs) != sorted(LSD_BUDGET_DB):
        raise AssertionError("golden configs missing from tools/make_goldens")
    configs.append(("voice", HEAVY))

    warm = {}
    per_note = {}
    for rep in range(2):
        for kind, (name, *args) in configs:
            out = tmp / f"out_{name}.wav"
            argv = [str(tmp / f"{kind}.wav"), str(out)] + [str(a) for a in args]
            before = _launches()
            t0 = time.perf_counter()
            rc = cli.main(argv)
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"render {name}: cli rc {rc}")
            if rep == 0:
                continue
            warm[name] = dt
            per_note[name] = tuple(b - a for a, b in zip(before, _launches()))
            if name in CASCADE_CONFIGS and per_note[name][1] == 0:
                raise AssertionError(f"render {name}: no cascade launch")
            ours, sr = read_wav(out)
            if not np.isfinite(ours).all():
                raise AssertionError(f"render {name}: non-finite output")
            note = (f"warm {dt * 1e3:.1f} ms, launches per note: pulse "
                    f"{per_note[name][0]} cascade {per_note[name][1]}")
            if name == HEAVY[0]:
                print(f"render {name}: {len(ours)} samples, {note}")
                continue
            golden, sr_g = read_wav(REPO / "tests" / "golden" / kind
                                    / f"out_{name}.wav")
            if sr != sr_g or len(ours) != len(golden):
                raise AssertionError(f"render {name}: {len(ours)} samples "
                                     f"at {sr} Hz, golden {len(golden)}")
            lsd = lsd_db(np.asarray(ours, np.float32),
                         np.asarray(golden, np.float32), sr)
            print(f"render {name}: {len(ours)} samples, LSD {lsd:.3f} dB "
                  f"(budget {LSD_BUDGET_DB[name]:.2f}), {note}")
            if not lsd <= LSD_BUDGET_DB[name]:
                raise AssertionError(f"render {name}: LSD {lsd} dB over "
                                     f"budget {LSD_BUDGET_DB[name]}")
    return warm, per_note


def check_heavy(tmp: Path):
    """The card's heavy-stack render (render_slice) against the port's
    CPU renders of the same note at seeds 0 and 1: same length, and LSD
    <= max(1 dB, the CPU seed-to-seed LSD + 0.5 dB), since sh, sr and sj
    draw noise from generators that differ between devices."""
    name, *args = HEAVY
    card, sr = read_wav(tmp / f"out_{name}.wav")
    cpu = []
    for seed in (0, 1):
        out = tmp / f"cpu_{name}_{seed}.wav"
        GooferResampler(tmp / "voice.wav", out, *args, seed=seed,
                        device="cpu")
        cpu.append(np.asarray(read_wav(out)[0], np.float32))
    if len(card) != len(cpu[0]):
        raise AssertionError(f"render {name}: {len(card)} samples on the "
                             f"card, {len(cpu[0])} on the CPU")
    floor = lsd_db(cpu[1], cpu[0], sr)
    lsd = lsd_db(np.asarray(card, np.float32), cpu[0], sr)
    budget = max(1.0, floor + 0.5)
    print(f"render {name}: LSD card vs CPU {lsd:.3f} dB (CPU seed-to-seed "
          f"{floor:.3f} dB, budget {budget:.2f})")
    if not lsd <= budget:
        raise AssertionError(f"render {name}: LSD {lsd} dB over budget "
                             f"{budget}")


def profile_heavy(tmp: Path, reps: int = 5) -> dict:
    """torch.profiler (device activity only) over ``reps`` warm
    heavy-stack renders through the CLI on CUDA.  Device busy is the
    union of the device events' spans, idle share 1 - busy / wall of the
    profiled renders."""
    name, *args = HEAVY
    argv = [str(tmp / "voice.wav"), str(tmp / f"prof_{name}.wav")] + [
        str(a) for a in args]
    if cli.main(argv) != 0:
        raise AssertionError(f"profile {name}: cli rc != 0")
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            if cli.main(argv) != 0:
                raise AssertionError(f"profile {name}: cli rc != 0")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    busy_us = 0.0
    end = float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]

    def kernel_us(name):
        return sum(e.time_range.elapsed_us() for e in kernels
                   if name in e.name)

    cascade_us = kernel_us("one_pole_cascade_kernel")
    pulse_us = kernel_us("pulse_accumulate_kernel")
    out = {
        "render_ms": wall_ms / reps,
        "device_busy_ms": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_kernels": len(kernels) / reps,
        "cascade_ms": cascade_us / 1e3 / reps,
        "cascade_share": cascade_us / busy_us,
        "pulse_ms": pulse_us / 1e3 / reps,
        "pulse_share": pulse_us / busy_us,
        "pulse_launches": sum("pulse_accumulate_kernel" in e.name
                              for e in kernels) / reps,
        "table_build_kernels": sorted({e.name[:80] for e in kernels if any(
            k in e.name for k in TABLE_BUILD_KERNELS)}),
    }
    if out["cascade_ms"] <= 0.0 or out["pulse_ms"] <= 0.0:
        raise AssertionError(f"profile {name}: no cascade or pulse kernel "
                             "on the device")
    print(f"profile {name} ({reps} warm renders): render "
          f"{out['render_ms']:.3f} ms per note, device busy "
          f"{out['device_busy_ms']:.3f} ms per note, idle share "
          f"{out['idle_share']:.3f}, device kernels per note "
          f"{out['device_kernels']:.1f}, cascade kernel "
          f"{out['cascade_ms']:.4f} ms per note = "
          f"{out['cascade_share']:.3f} of device busy, pulse kernel "
          f"{out['pulse_ms']:.4f} ms per note = {out['pulse_share']:.3f} "
          f"of device busy in {out['pulse_launches']:.1f} launches; "
          f"table-build kernels: {out['table_build_kernels'] or 'none'}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all([pulse_kernel.KERNEL, cascade_kernel.KERNEL])
    print(f"build {', '.join(p.name for p in libs)}: "
          f"{time.perf_counter() - t0:.2f} s")

    err, p_rows = check_pulse_kernel()
    c_err, c_rel, c_rows = check_cascade_kernel()

    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        warm, per_note = render_slice(Path(tmp))
        launches, c_launches = _launches()
        check_heavy(Path(tmp))
        prof = profile_heavy(Path(tmp))
    if launches <= 0:
        raise AssertionError("the render never launched the pulse kernel")
    if c_launches <= 0:
        raise AssertionError("the render never launched the cascade kernel")
    heavy = per_note[HEAVY[0]]
    if heavy != (HEAVY_PULSE_LAUNCHES, HEAVY_CASCADE_LAUNCHES):
        raise AssertionError(f"heavy note: {heavy[0]} pulse and {heavy[1]} "
                             f"cascade launches, expected "
                             f"{HEAVY_PULSE_LAUNCHES} and "
                             f"{HEAVY_CASCADE_LAUNCHES}")
    if prof["table_build_kernels"]:
        raise AssertionError("heavy note: the pulse-table build still runs: "
                             f"{prof['table_build_kernels']}")
    print(f"render: {len(warm)} configs, warm per-note median "
          f"{statistics.median(warm.values()) * 1e3:.1f} ms, max "
          f"{max(warm.values()) * 1e3:.1f} ms; kernel launches: pulse "
          f"{launches}, cascade {c_launches}")

    no_library = ("no single PyTorch call computes this function: the "
                  "nearest are loops of elementwise ops, which the plain "
                  "version is")
    *_, c_ms, c_p_ms, c_bound, c_bound_by = c_rows["hp12_layer"]
    *_, ms, p_ms, bound, bound_by = p_rows["glide_gap"]
    print(json.dumps({"kernels": [{
        "name": "pulse_accumulate",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/pulse_accumulate.cu",
        "replaces": "goofer_tpu/ops/pallas/pulse_kernel.py:61",
        "note": "the whole pulse pass in one cluster launch, f0 in and "
                "pulse train out: phase scan, onsets and onset tables "
                "(goofer_tpu/ops/pulse.py:109, :84, :170) and the "
                "K-bounded LF accumulation of the Pallas kernel",
        "launches": launches,
        "launches_per_heavy_note": heavy[0],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": no_library,
        "timed_case": "glide_gap, B=1, n=40000, main pass",
        "ms_by_case": {k: v[4] for k, v in p_rows.items()},
        "plain_ms_by_case": {k: v[5] for k, v in p_rows.items()},
        "bound_ms_by_case": {k: v[6] for k, v in p_rows.items()},
        "heavy_note_device_ms": prof["pulse_ms"],
        "heavy_note_device_share": prof["pulse_share"],
    }, {
        "name": "one_pole_cascade",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/one_pole_cascade.cu",
        "replaces": "goofer_tpu/ops/scan_iir.py:41",
        "note": "replaces non-Pallas JAX code: first_order_recurrence_pos, "
                "the stage solver of dynamic_one_pole_cascade",
        "launches": c_launches,
        "launches_per_heavy_note": heavy[1],
        "max_abs_err": c_err,
        "max_rel_err": c_rel,
        "ms": c_ms,
        "plain_ms": c_p_ms,
        "bound_ms": c_bound,
        "bound_by": c_bound_by,
        "library_ms": None,
        "library_note": no_library,
        "timed_case": "hp12_layer, B=1, n=40000, order 12",
        "ms_by_case": {k: v[4] for k, v in c_rows.items()},
        "heavy_note_device_ms": prof["cascade_ms"],
        "heavy_note_device_share": prof["cascade_share"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
