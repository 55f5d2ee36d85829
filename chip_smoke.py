#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (goofer_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels (csrc/pulse_accumulate.cu,
   csrc/one_pole_cascade.cu, csrc/gaussian_blur.cu, csrc/pitch_viterbi.cu,
   csrc/lpc_roots.cu and csrc/burg_lpc.cu), one nvcc each, started
   together, into build/goofer_tpu_torch/ and print the build time;
   beside them g++
   builds the host audio codecs (csrc/wavcodec.cpp, csrc/sndcodec.cpp,
   goofer_tpu_torch.native), whose build time is printed too;
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
   against torch.profiler's device time; then the blur kernel at the
   heavy note's and phrase (b)'s shapes (sample axis: sigma 441 and 20
   over 48510 samples, 16 and 80 x 33074, the jitters' coarse grids, a
   track shorter than the window; bin axis of (80, 513, T) and of the
   heavy note's (1, 513, T): sigma 0.5-2, the complex spectra as one
   (B, 513, T, 2) float view), max |diff| <= 1e-5 x max|x|, each batch's
   first, middle and last row equal bit for bit to the row launched
   alone, a complex view equal bit for bit to its two parts launched
   apart, timed beside cuDNN's conv1d of the padded rows;
5. render the 12 golden configs and the heavy 11-flag stack through
   goofer_tpu_torch.cli.main on CUDA from the vendored .goofy caches:
   each golden must be finite, of the golden's length, within its
   golden's LSD budget and within 15 cents of F0 RMSE over the frames
   voiced in both, as tests/test_golden.py holds goofer_tpu's (texture
   and voice_texture exempt, their readings printed: F0_UNSTABLE); the
   kernels' launch counters must rise, 4 pulse and 5
   cascade launches per heavy note; print each config's readings, warm
   per-note time and launches per note;
6. hold the heavy stack against the port's own CPU render of the same
   note (it is stochastic: LSD <= max(1 dB, CPU seed-to-seed + 0.5 dB));
7. profile 5 warm heavy-stack renders under torch.profiler: device busy
   ms, idle share, device kernels per note, each kernel's device ms per
   note and its share of device busy; no scan or searchsorted kernel of
   the old pulse-table build may appear;
8. check both kernels at the phrase renderer's shapes (pulse main pass
   at B=50, n=24696 and B=80, n=33075 with K=32, the gated sg pass at
   B=80; cascade HP12 and LP4 at B=80 with per-row coefficients and the
   fry pair's 160 rows), same limits, and time them;
9. render three phrases through goofer_tpu_torch.sampler.phrase
   .render_phrase on CUDA at full width (44.1 kHz, n_fft 1024, hop 256,
   the voice source): (a) 97 plain notes, 60 s; (b) 80 notes of the heavy
   11-flag stack, 60 s; (c) 40 notes of random length.  Each group of a
   phrase must launch each kernel once per pass (as many launches as one
   note of the group alone), (a) must be 2 groups, (c) must bucket into
   fewer groups than notes, pcm16 output must be int16, every note finite
   and non-silent; rows of (a) and (b) are held to the same note rendered
   alone with the same (seed, index) key, (c) bucketed to unbucketed
   (5e-3 x peak on all but 0.1% of samples and 0.1 dB LSD with the noise
   stems zeroed; LSD <= max(1 dB, seed-to-seed + 0.5 dB) with noise on,
   but (b)'s rows with the noise on are held to the noise-zeroed budget,
   and printed beside it are the same rows with cuDNN's conv1d put back
   for the blur and with cuFFT's C2R left to read the DC and Nyquist
   bins' imaginary parts, and irfft_rows, that C2R on random spectra);
   print warm wall time with and without the copy to the host, x
   realtime, device busy, idle share and device kernels per phrase, and
   the 97 notes rendered one by one;
10. check the three analysis kernels against their plain versions on the
   card, and time them (steps 10-12 run right after step 4): the pitch
   Viterbi must give the plain version's path and f0 exactly, on the
   candidates of a whole 2 s recording (B=1, F=338), of 16 ragged cuts (nf
   from 1 to F), of the folder's largest chunk, and on seeded ones at
   B=64, F=700, all unvoiced, F=10300 (backpointers in the global scratch)
   and K=4; printed with its count of dependent steps;
11. the Burg kernel (one warp per frame, each lane's stretch of the
   errors in registers, no CTA barrier) on the windowed frames of the
   same recordings (an all-zero frame among them), rtol 1e-3 / atol 1e-4,
   with the plain version's time and device kernels;
12. the root-finder kernel (floor(32 / order) polynomials per warp, 3 at
   order 10, a root per lane) on those frames' polynomials and on 64 x
   700 seeded ones with known roots: matched roots within 1e-4 on rows
   that converged, the same NaN pattern, known roots found; timed beside
   torch.linalg.eigvals of the companion matrices (a yardstick only);
13. one note each with positive st, with fc fd FV P and with velocity 150
   on the card, held to the port's CPU render within 1 dB LSD (after the
   heavy stack);
14. the analysis path: write a 64-file voicebank folder (cuts of the
   vendored recordings, 0.4-2.0 s), extract it through cli.main (one
   launch of each analysis kernel per chunk; a second run skips all 64),
   hold 6 rows to the same files extracted alone (f0 and mask at float16,
   the same K, knots to one float16 step above the FFT's float32 floor,
   formants within 1 Hz on >= 99%), compare the voice source with the
   vendored .goofy (f0 within 1% and voicing on >= 98% of samples), check
   the recorded vowel's extraction for sanity, render all 12 goldens from
   fresh directories that hold the source WAV alone (the first render
   extracts and saves) within their LSD budgets and F0 gate, and print
   the warm extraction time with and without reads and writes, device
   busy, idle
   share, device kernels and each analysis kernel's device ms per folder;
15. the server (sampler/server.py) in-process on 127.0.0.1 at an
   ephemeral port: warm-up (kernel builds, one note, one burst), one POST
   PCM-equal to the CLI render of its arguments and its warm latency
   (median of 7), then 3 bursts of 16 POSTs from 16 threads (plain and
   heavy flags in turns, voice source): every reply 200, at most 2
   dispatches per burst, no per-note fallback, each WAV equal at int16
   to render_phrase of its batch in the batcher's order and within the
   row-vs-note-alone budget of the CLI's render at its row's noise key;
   a malformed body gets 500 with a traceback; prints the server: line
   (single-POST ms, burst wall ms from the first send to the last reply,
   dispatches, x realtime, launches);
16. the facade: models/hnm.synthesize on the voice source's 2 s with
   every option the note render never sets (subharmonic semitones -12
   and +12 under vibrato and f0 jitter, f0 and volume jitter with volume
   vibrato, roughness, brightness off): 3 pulse launches and 1 cascade
   launch per call, held to the port's CPU render (harmonic stem 5e-3 x
   peak on all but 0.1% of samples and 0.1 dB LSD; noisy stems within
   max(1 dB, CPU seed-to-seed + 0.5 dB)), then compat.f0_estimate and
   extract_formants on the card against the CPU (one launch of each
   analysis kernel); prints the facade: line (warm ms per call, launches);
   the pulse and cascade checks of steps 3-4 include the facade's densest
   passes (f0 x 2 under the default jitter, +12 semitones with vibrato,
   its derived table bounds) and its roughness high-pass;
17. the voicing editor: Play's preview synthesis of the voice source's
   first 2 s (editor/gui.py:_preview_synthesis; launches per preview, warm
   ms as the median of 7 after 2, card vs CPU within 0.1 dB LSD); SE1
   through cli.main on the heavy note with the editor hook replaced by a
   scripted one that paints the snippet's first half unvoiced (the hook
   runs once, the .goofy's mask changes there and nowhere else, the
   source's cached renders are deleted, the output equals at int16 the
   plain render of the edited .goofy at the same seed); the .goofy batch
   mode (edit_goofy_files) on the knot-mode .goofy with tkinter replaced
   by tests/fake_tk.py: decoded and previewed on the card, edit written;
   prints the editor: line;
18. the native codecs: the voice source written as 16-bit FLAC and AIFF
   (and MP3 where libmpg123 and libmp3lame load; the line says which), the
   heavy note rendered on the card from each in a directory without a
   cache (decode, extraction, render), FLAC and AIFF equal at int16 to the
   note from the WAV; a folder of wav + flac + aiff copies extracted
   through cli.main (three .goofy files with equal features, one launch of
   each analysis kernel); host ms to decode each format; prints the
   codec: line;
19. the mesh path (goofer_tpu_torch/parallel): meshes V (dp 2 x tp 2,
   four slots of the one card), M1 (every visible card) and, where the
   machine shows two or more cards, M2 over them (a mesh not built is
   printed with the reason); phrases (b) and (a) through
   render_phrase(mesh=) on each, every row within the row-vs-note-alone
   budget (noise on) of render_phrase on one device, pcm16 int16, each
   kernel launched once per pass per non-empty shard; the 64-file folder
   through extract_features_recursive(mesh=V), every .goofy within the
   folder-row budget of the single-device run, each analysis kernel once
   per non-empty shard of each chunk; dryrun_multichip(4) on V's four
   slots (and over the real cards where there are two or more);
   render_batch_sharded on V at the production frames, K 64 and 63: the
   tp-reduced log-envelope bit-equal to decode_log_env_from_knots, the
   stems within the row-vs-alone budgets of render_batch on one device,
   B = 3 raising; prints warm wall ms single vs each mesh (median of 7
   after 2), V's device busy and idle share for (b), the folder's warm
   ms, launches and the sharded-vs-single differences;
20. the public surface (surface_slice): launchers/goofer-sampler-torch.sh
   on the heavy note against python -m goofer_tpu_torch.cli (equal at
   int16, launches from each one's log); examples/engine_selftest_torch.py
   on _input.wav on the card and on the CPU (four finite stems, the
   analysis and pulse kernels launched, the reconstruct stems within
   max(1 dB, seed-to-seed + 0.5 dB)); a plain note through a read-only
   copy of the package as pyproject.toml ships it, its kernels and codec
   built under XDG_CACHE_HOME, equal at int16 to the in-tree render;
   every path from step 5 on must have launched the blur kernel;
21. the note render's own profile (profile_slice, utils/profiling.py):
   the heavy note through cli.main, plain, then with GOOFER_TPU_PROFILE=1
   (three torch.cuda.synchronize calls, one per stage; none in the plain
   render), then with GOOFER_TPU_TRACE_DIR set too: the features /
   resample / write report with n=1 each, its total within the call's
   wall time, the WAV byte-equal to the plain render's, the trace holding
   device events of the pulse, cascade and blur kernels; then the same
   note in a fresh ``python -m goofer_tpu_torch.cli`` process with
   GOOFER_TPU_PROFILE=1; prints the warm and cold stage splits beside the
   card's name and power limit;
22. print the phrases, analysis, server, facade, editor, codec, parallel,
   surface, profile and kernels summaries as one JSON line each, then the
   device line.

Kernel times are device time per launch: a run of ``TIMED_REPS``
launches between one pair of CUDA events, enqueued behind a spin kernel
(torch.cuda._sleep) so that the device never waits on the Python
wrapper.  Each kernel's bound is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, the H100 SXM's published peaks.

Imports nothing of JAX or goofer_tpu.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from goofer_tpu_torch import cli, compat, config, native
from goofer_tpu_torch.analysis import features, formants, pitch
from goofer_tpu_torch.editor import gui
from goofer_tpu_torch.engine import synth
from goofer_tpu_torch.io.goofy import formants_to_int_keys, load_features
from goofer_tpu_torch.models import hnm
from goofer_tpu_torch.ops import (
    envelope,
    filters,
    jitter,
    noise,
    pulse,
    scan_iir,
    stft,
)
from goofer_tpu_torch.ops.cuda import (
    _build,
    blur_kernel,
    burg_kernel,
    cascade_kernel,
    lpc_roots_kernel,
    pulse_kernel,
    viterbi_kernel,
)
from goofer_tpu_torch.parallel import batch as par_batch, dryrun
from goofer_tpu_torch.parallel.mesh import make_mesh
from goofer_tpu_torch.sampler import batch_extract, phrase, server
from goofer_tpu_torch.sampler.render_core import render_note
from goofer_tpu_torch.sampler.resampler import (
    GooferResampler,
    acquire_features,
)
from goofer_tpu_torch.utils.audio_io import read_wav, read_wav_mono, write_wav
from goofer_tpu_torch.utils.metrics import f0_rmse_cents, lsd_db
from goofer_tpu_torch.utils.profiling import profiled

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
# tests/test_golden.py's pitch gate: F0 RMSE of a render against its golden,
# both tracked at dt = 256 / sr, over the frames voiced in both where there
# are at least F0_MIN_FRAMES.  Exempt, their readings printed: the two
# heavy-texture configs, whose jitter and subharmonic layers make the
# tracker octave-unstable on any render of the class (test_golden.py
# exempts voice_texture; its "texture" passes there only with fewer than 8
# frames voiced in both: 0, 5 and 1 for goofer_tpu's renders at seeds 0-2,
# at 1261 and 2047 cents where any; the port's seed-0 render leaves 9, at
# 369 cents, and its golden's own track wanders 386-520 Hz on an E4)
F0_BUDGET_CENTS = 15.0
F0_MIN_FRAMES = 8
F0_UNSTABLE = ("texture", "voice_texture")
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
# 3 of 3529 taps (pd's gain, voicing mask and scale), 1 of 161, 201 and
# 75, 2 of 99 along the samples; 1 of 17 and 15 along the bins, 4 complex
# spectra of 5 taps in one launch each
HEAVY_BLUR_LAUNCHES = 14
# relative to max|x|: the kernel's in-order fmaf sum and cuDNN's conv1d of
# the same reflect-padded rows (float32 on both sides, TF32 off), up to
# 3529 normalized taps
BLUR_TOL = 1e-5
# the blur kernel's rows at phrase (b)'s batch size, held bit for bit to
# the same row launched alone
BLUR_BATCH = 80
SR = 44100
HOP = 256
N_FFT = 1024
N_CHECK = 40000
# the extraction bank: 64 cuts of these recorded voices
BANK_FILES = 64
VOICEBANK_SOURCES = (
    "tests/golden/voice/src.wav", "_input.wav", "_input_harmonic.wav",
    "_input_breathiness.wav", "_input_unvoiced.wav",
    "_input_reconstruct.wav", "tests/golden/ref/src.wav")
# the formant tracker's LPC order (2 x 5 formants)
LPC_ORDER = 10
# matched roots of the kernel and the plain version on rows that
# converged: both iterate to the same roots, float32 rounding apart
ROOTS_TOL = 1e-4
# Burg coefficients: the kernel's and torch.sum's orders of the 551-term
# dot products differ, and the recursion carries their rounding along
BURG_RTOL = 1e-3
BURG_ATOL = 1e-4
# four float32 roundings of a frame's largest bin: what one bin of the
# float32 FFT of that frame can differ by between two batch sizes
KNOT_F32_FLOOR = 5e-7
# operations of one Viterbi transition, one each: the two floors, the
# division, log2, abs, the product, the subtraction and the compare
VITERBI_OPS_PER_TRANSITION = 8
# torch.linalg.eigvals solves the companion matrices one by one: timed
# only on cases up to this many rows
EIGVALS_MAX_ROWS = 10000
# the phrases' notes: 60 + 500 ms (50 of them), 60 + 690 or 750 ms (80)
N_PHRASE_SHORT = 24696
N_PHRASE_LONG = 33075
PHRASE_SCALE = ("C4", "D4", "E4", "F4", "G4", "A4", "B4", "C5", "A3", "G3")
PHRASE_SCALE_HZ = (261.63, 293.66, 329.63, 349.23, 392.0, 440.0, 493.88,
                   523.25, 220.0, 196.0)
# the voice source's notes, the longest on the main path
N_LONG = 48510
# the server's burst: 16 POSTs, one per note, from 16 threads
SERVER_BURST = 16
SERVER_BURST_REPS = 3
# the facade call: models/hnm.synthesize on the voice source's features
# with every option that the note render never sets
FACADE_OPTIONS = dict(
    add_subharm=True, subharm_semitones=(-12, 12), subharm_vibrato=True,
    subharm_f0_jitter=0.3, f0_jitter=True, volume_jitter=True,
    volume_vibrato=True, roughness_on=True, apply_brightness=False)
# one launch of the pulse kernel for the main pass and one per semitone;
# one of the cascade kernel for the roughness high-pass
FACADE_PULSE_LAUNCHES = 3
# the editor's Play: a span of the voice source, held card vs CPU (the
# noise is counter-based, the same draws on both devices)
EDITOR_SPAN_S = 2.0
PREVIEW_LSD_DB = 0.1
FACADE_CASCADE_LAUNCHES = 1
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
    of CUDA events, enqueued behind a spin kernel.  With ``gap_free`` a
    run whose enqueueing outlasted the spin (the device then waited on
    the host, which a one-card machine shares) is repeated behind a spin
    twice as long; after three such runs it raises."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(3):
        spin, start, stop = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        spin_ms = spin.elapsed_time(start)
        if not gap_free or host_ms < spin_ms:
            return start.elapsed_time(stop) / reps
        cycles *= 2
    raise AssertionError(f"enqueueing {reps} calls took {host_ms:.2f} ms, "
                         f"longer than the {spin_ms:.2f} ms spin: the "
                         "device waited on the host")


def device_events(prof):
    """The profile's device-side events (kernels, copies, memsets)."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise AssertionError("torch.profiler recorded no device activity")
    return events


@contextlib.contextmanager
def device_profile():
    """torch.profiler over the device activity of the block, its tracing
    started one discarded step ahead (utils/profiling.py:profiled)."""
    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield prof


def profiler_ms(fn, kernel: str, reps: int = TIMED_REPS) -> float:
    """Mean device time of ``kernel`` per call of ``fn`` from
    torch.profiler, the cross-check of cuda_ms."""
    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
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


def pulse_pass_args(f0_np: np.ndarray, gated: bool,
                    max_overlap: int | None = None,
                    min_spacing: int | None = None) -> tuple:
    """The pass's scalars after f0 and gate: (sr, scale, fallback_f0, Ra,
    Rg, Rk, guard, K, min_spacing).  Main pass as the resampler derives
    them for the main layer (K and spacing from the pitch range, or the
    ``max_overlap`` a group was harmonized to); gated pass as the sg
    layer's semitone +12 (ratio 2, K 8, spacing 8).  ``min_spacing``
    gives the pass the spacing a caller derived (the facade's)."""
    if gated:
        return (SR, 2.0, config.PULSE_FALLBACK_F0 * 2.0, 0.02, 1.7, 1.0,
                False, 8, min_spacing or 8)
    voiced = f0_np[f0_np > 0]
    hi = max(float(voiced.max()) if voiced.size else 0.0,
             config.PULSE_FALLBACK_F0)
    lo = min(float(voiced.min()) if voiced.size else hi,
             config.PULSE_FALLBACK_F0)
    k = max_overlap or config.bucket_overlap(
        int(min(32, max(3, np.ceil(0.804 * hi / lo) + 2))))
    spacing = min_spacing or config.bucket_min_spacing(int(SR / hi))
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


def phrase_f0(batch: int, n: int) -> np.ndarray:
    """(B, n) f0 rows as a phrase group's: row b sings scale note b
    (G3-C5) detuned by the phrases' t flags, with a 5.3 Hz, 1% vibrato
    behind an unvoiced head.  (At 5 Hz the vibrato's period is 8820
    samples exactly, its phase cancels over each and the rows run into
    phase ties, where only exact_phase_plain holds the kernel.)"""
    t = np.arange(n) / SR
    hz = np.array([PHRASE_SCALE_HZ[b % 10] * 2 ** ((b % 7 - 3) / 120)
                   for b in range(batch)])[:, None]
    f0 = hz * (1.0 + 0.01 * np.sin(2 * np.pi * 5.3 * t + np.arange(
        batch)[:, None]))
    f0[:, : n // 12] = 0.0
    return f0.astype(np.float32)


def phrase_pulse_cases():
    """(name, f0 (B, n), gate or None, K) at the phrase renderer's shapes:
    the main pass of the 50 short and of the 80 long notes at the K = 32
    a heavy group is harmonized to, and the sg layer's gated pass; then
    the same passes at the largest shard each group gives on the parallel
    phase's four-slot mesh V (13 and 20 rows)."""
    short = phrase_f0(50, N_PHRASE_SHORT)
    long = phrase_f0(80, N_PHRASE_LONG)
    gate = (long > 0).astype(np.float32)
    return [("phrase_b50", short, None, 32),
            ("phrase_b80", long, None, 32),
            ("phrase_sg_b80", long, gate, None),
            ("phrase_b13_shard", short[:13], None, 32),
            ("phrase_b20_shard", long[:20], None, 32),
            ("phrase_sg_b20_shard", long[:20], gate[:20], None)]


def facade_inputs():
    """The voice source's features as models/hnm.synthesize takes them:
    the knot pack, f0, voicing mask and formant dict (2 s)."""
    pack, f0, mask, forms, _, _ = load_features(
        REPO / "tests" / "golden" / "voice" / "src_features.goofy")
    return pack, f0, mask, forms


def facade_pulse_cases():
    """(name, f0 (1, n), gate or None, K, spacing) at the facade's
    densest setting on the voice source: f0 doubled (pitch_shift 2) under
    the default f0 jitter (strength 1.5, speed 100), and the +12
    semitone's gated pass on that track under the default 0.1-depth
    vibrato, with the table bounds models/hnm.pulse_bounds derives."""
    _, f0_np, mask_np, _ = facade_inputs()
    n = len(f0_np)
    f0 = torch.as_tensor(f0_np * 2.0, dtype=torch.float32)[None]
    mask = torch.as_tensor(mask_np, dtype=torch.float32)[None]
    keys = torch.as_tensor(noise.stream_keys([0], synth.SYNTH_STREAMS))
    jit = jitter.f0_jitter(keys[:, synth.STREAM_F0_JITTER], n, SR, 100.0,
                           1.5)
    f0 = f0 * (1.0 + (jit - 1.0) * mask)
    sub = jitter.subharm_vibrato(f0, SR, 6.0, 0.1, 0.1)
    k, spacing, sub_spacing = hnm.pulse_bounds(
        f0_np, 2.0, SR, True, 1.5, True, (12.0,), True, 0.1, 0.3)
    return [("facade_main", f0.numpy(), None, k, spacing),
            ("facade_sub_p12", sub.numpy(), mask.numpy(), None,
             sub_spacing)]


def _pulse_cases():
    """(name, f0 (B, n), gate or None, K or None for the derived one) at
    the note render's shapes; the constant and glide cases follow
    tests/test_pallas_pulse.py."""
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
    return [c + (None,) for c in cases]


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


def check_pulse_kernel(cases):
    """Kernel vs plain version on the card, every case; returns the worst
    max |diff| and each case's (B, n, gated, K, kernel ms, plain ms,
    bound ms, what bounds it)."""
    pulse_accumulate = pulse_kernel.pulse_accumulate
    dev = torch.device("cuda")
    worst = 0.0
    rows = {}
    for name, f0_np, gate_np, k_over, *spacing in cases:
        f0 = torch.as_tensor(f0_np, device=dev)
        gate = None if gate_np is None else torch.as_tensor(gate_np,
                                                            device=dev)
        args = pulse_pass_args(f0_np, gate is not None, k_over, *spacing)
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
        if name != "ties" and not margin > 1e-9:
            raise AssertionError(
                f"pulse kernel {name}: the case's phase comes within "
                f"{margin:.1e} of an integer, where the plain version's "
                "float64 cumsum does not decide the onset")
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


def facade_cascade_cases():
    """(name, x, alpha, order, btype): the roughness high-pass of the
    facade call, order 1 at 320 Hz over the voice source's 2 s."""
    x, _ = _voiced_signal(2 * SR, np.random.default_rng(3))
    rc = 1.0 / (2.0 * np.pi * 320.0)
    alpha = np.full(2 * SR, rc / (rc + 1.0 / SR), dtype=np.float32)
    return [("facade_rough_hp1", x[None], alpha, 1, "highpass")]


def phrase_cascade_cases(batch: int = 80):
    """(name, x (B, n), alpha, order, btype) at the phrase renderer's
    shapes: the ``batch`` long notes' su/sj layer highpass (order 12) and
    st tension lowpass (order 4), each row with its own (B, n)
    coefficients from its own f0, and their fry pair, 2 x ``batch`` rows
    sharing the 200 Hz highpass's one (n,) coefficient row.  80 is phrase
    (b)'s group, 20 its shard on the parallel phase's mesh V."""
    n = N_PHRASE_LONG
    rng = np.random.default_rng(2)
    f0 = phrase_f0(batch, n)
    phase = np.cumsum(f0 / SR, axis=1)
    x = (np.sin(2 * np.pi * phase) ** 15 * 0.8
         + 0.05 * rng.standard_normal(f0.shape)).astype(np.float32)
    f0_t = torch.as_tensor(f0)
    hp = scan_iir.butter_alpha(torch.clamp(f0_t, min=120.0), n, SR, 1.0,
                               "highpass").numpy()
    lp = scan_iir.butter_alpha(f0_t, n, SR, 2.0 - 0.3 * 0.75,
                               "lowpass").numpy()
    fry = scan_iir.butter_alpha(torch.ones(n), n, SR, 200.0,
                                "highpass").numpy()
    pair = np.concatenate(
        [x, 0.1 * rng.standard_normal(x.shape).astype(np.float32)])
    return [(f"phrase_hp12_b{batch}", x, hp, 12, "highpass"),
            (f"phrase_lp4_b{batch}", x, lp, 4, "lowpass"),
            (f"phrase_hp6_fry_b{2 * batch}", pair, fry, 6, "highpass")]


def check_cascade_kernel(cases):
    """Kernel vs plain version on the card, every case; returns the worst
    max |diff|, the worst max |diff| / max|x| and each case's (B, n,
    order, btype, kernel ms, plain ms, bound ms, what bounds it)."""
    cascade = cascade_kernel.one_pole_cascade
    dev = torch.device("cuda")
    worst = worst_rel = 0.0
    rows = {}
    for name, x_np, alpha_np, order, btype in cases:
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


def blur_cases():
    """(name, x, sigma, axis): the main path's blurs at the heavy note's
    and phrase (b)'s shapes.  Along the samples: pd's bend and voicing
    mask (sigma 441, 3529 taps) and vj's mask (sigma 20) over the note's
    48510 samples and (b)'s 80 x 33074; the jitters' coarse grids (sigma /
    ds 9.25 and 12.25) and the voicing crossfade's (sigma 25) at (b)'s 80
    rows; a track shorter than the window (repeated reflection); sigma 441
    at 16 rows, between the note and (b).  Along the bins of (B, 513, T):
    the complex spectrum blur (0.5), the breath envelope (1.75) and the
    envelope smoothing (2.0) at (b)'s B and at the heavy note's own B = 1
    and frame counts; a complex spectrum as one (B, 513, T, 2) float view
    at axis -3 and, as the port launches an STFT's, stored frames by bins,
    (B, T, 513, 2) at axis -2."""
    rng = np.random.default_rng(11)

    def rows(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    b = BLUR_BATCH
    return [
        ("note_s441", rows(1, N_LONG), 441.0, -1),
        ("note_s20", rows(1, N_LONG), 20.0, -1),
        ("phrase_s441", rows(b, N_PHRASE_LONG - 1), 441.0, -1),
        ("phrase_s20", rows(b, N_PHRASE_LONG - 1), 20.0, -1),
        ("phrase_jitter_s12.25", rows(b, 8270), 12.25, -1),
        ("phrase_jitter_s9.25", rows(b, 4136), 9.25, -1),
        ("phrase_mask_s25", rows(b, 8269), 25.0, -1),
        ("short_track_s441", rows(3, 700), 441.0, -1),
        ("phrase_bins_s0.5", rows(b, 513, 130), 0.5, -2),
        ("phrase_bins_s1.75", rows(b, 513, 129), 1.75, -2),
        ("phrase_bins_s2", rows(b, 513, 344), 2.0, -2),
        ("note_bins_complex_s0.5", rows(1, 190, 513, 2), 0.5, -2),
        ("note_bins_s1.75", rows(1, 513, 190), 1.75, -2),
        ("note_bins_s2", rows(1, 513, 327), 2.0, -2),
        ("phrase_bins_complex_s0.5", rows(b, 513, 130, 2), 0.5, -3),
        ("phrase_s441_b16", rows(16, N_PHRASE_LONG - 1), 441.0, -1),
        ("phrase_bins_complex_stored_s0.5", rows(b, 130, 513, 2), 0.5, -2),
    ]


def check_blur_kernel(cases):
    """Kernel vs plain version on the card, every case, and each batch's
    first, middle and last row launched alone against the same row in the
    batch, bit for bit, and a complex spectrum's float view against its
    real and imaginary parts launched one by one, bit for bit; returns
    the worst max |diff|, the worst max |diff| / max|x| and each case's
    (shape, taps, kernel ms, plain ms, F.conv1d ms, bound ms, what bounds
    it).  The library column is one cuDNN conv1d of the rows already
    reflect-padded: the plain version's last step."""
    blur = blur_kernel.gaussian_blur
    dev = torch.device("cuda")
    worst = worst_rel = 0.0
    rows = {}
    for name, x_np, sigma, axis in cases:
        x = torch.as_tensor(x_np, device=dev)
        taps = filters.gaussian_kernel1d(sigma)
        got = blur(x, taps, axis)
        want = filters.blur_plain(x, taps, axis)
        torch.cuda.synchronize()
        if got.shape != x.shape or not torch.isfinite(got).all():
            raise AssertionError(f"gaussian_blur {name}: shape "
                                 f"{tuple(got.shape)} or non-finite")
        err = float((got - want).abs().max())
        rel = err / float(x.abs().max())
        batch = x.shape[0]
        alone_equal = 0
        if batch > 1:
            for i in sorted({0, batch // 2, batch - 1}):
                alone = blur(x[i:i + 1], taps, axis)
                if not torch.equal(alone[0], got[i]):
                    d = float((alone[0] - got[i]).abs().max())
                    raise AssertionError(f"gaussian_blur {name}: row {i} "
                                         f"alone differs from the batch's "
                                         f"by {d:.3e}")
                alone_equal += 1
        parts_equal = ""
        if x.ndim == 4 and axis in (-3, -2):
            apart = torch.stack([blur(x[..., j].contiguous(), taps, axis + 1)
                                 for j in (0, 1)], dim=-1)
            if not torch.equal(apart, got):
                d = float((apart - got).abs().max())
                raise AssertionError(f"gaussian_blur {name}: the one-launch "
                                     f"complex blur differs from its parts "
                                     f"launched one by one by {d:.3e}")
            parts_equal = " = its two parts launched apart, bit for bit"
        ms = cuda_ms(lambda: blur(x, taps, axis))
        p_ms = cuda_ms(lambda: filters.blur_plain(x, taps, axis),
                       PLAIN_REPS, gap_free=False)
        radius = (len(taps) - 1) // 2
        moved = torch.movedim(x, axis, -1)
        padded = filters.reflect_pad(moved.reshape(-1, 1, moved.shape[-1]),
                                     radius, radius).contiguous()
        w = torch.as_tensor(taps, device=dev).reshape(1, 1, -1)
        lib_ms = cuda_ms(lambda: F.conv1d(padded, w), PLAIN_REPS)
        # x read and out written once; a multiply and an add per tap and
        # output
        outputs = x.numel()
        bound, bound_by = bound_ms(8 * outputs, 2 * len(taps) * outputs)
        print(f"gaussian_blur {name}: shape {tuple(x.shape)} axis {axis} "
              f"{len(taps)} taps max|diff|/max|x|={rel:.3e} rows alone "
              f"bit-equal {alone_equal}{parts_equal} kernel {ms:.5f} ms "
              f"plain "
              f"{p_ms:.4f} ms F.conv1d {lib_ms:.4f} ms bound {bound:.5f} ms "
              f"({bound_by})")
        if not rel <= BLUR_TOL:
            raise AssertionError(f"gaussian_blur {name}: max |diff| / "
                                 f"max|x| {rel} > {BLUR_TOL}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, rel)
        rows[name] = (tuple(x.shape), len(taps), ms, p_ms, lib_ms, bound,
                      bound_by)
    return worst, worst_rel, rows


@contextlib.contextmanager
def substituted(module, name: str, stand_in):
    """Within the block ``module.name`` is ``stand_in``."""
    real = getattr(module, name)
    setattr(module, name, stand_in)
    try:
        yield
    finally:
        setattr(module, name, real)


def irfft_rows(batch: int = BLUR_BATCH, bins: int = 513,
               frames: int = 130) -> dict:
    """cuFFT's C2R on (batch, bins, frames) random spectra whose DC and
    Nyquist bins have imaginary parts, as the noise stems' do: max |diff|
    / peak of row 0 in the batch against row 0 alone, raw and through
    stft.hermitian_edges (what istft hands the transform)."""
    rng = np.random.default_rng(13)
    S = torch.complex(*(torch.as_tensor(rng.standard_normal(
        (batch, bins, frames)).astype(np.float32), device="cuda")
        for _ in range(2)))
    n = 2 * (bins - 1)
    out = {}
    for name, prep in (("raw", lambda z: z),
                       ("hermitian_edges", stft.hermitian_edges)):
        together = torch.fft.irfft(prep(S), n=n, dim=-2)[0]
        alone = torch.fft.irfft(prep(S[:1]), n=n, dim=-2)[0]
        out[name] = float((together - alone).abs().max()
                          / alone.abs().max())
    print(f"irfft (cuFFT C2R) of {batch} x {bins} x {frames} spectra with "
          f"imaginary DC and Nyquist parts: row 0 in the batch vs alone, "
          f"max|diff|/peak raw {out['raw']:.3e}, through hermitian_edges "
          f"{out['hermitian_edges']:.3e}")
    return out


def golden_f0_cents(ours, golden, sr: int):
    """F0 RMSE in cents of a render against its golden, both tracked by
    the port's track_pitch at dt = 256 / sr, over the frames voiced in
    both; with the count of those frames."""
    f0_g = pitch.track_pitch(np.asarray(golden, np.float32), sr, 256 / sr)
    f0_o = pitch.track_pitch(np.asarray(ours, np.float32), sr, 256 / sr)
    voiced = (f0_g > 0) & (f0_o > 0)
    n = int(voiced.sum())
    return (f0_rmse_cents(f0_o[voiced], f0_g[voiced]) if n else None), n


def hold_f0(name: str, ours, golden, sr: int) -> str:
    """tests/test_golden.py's pitch gate for the port's render of golden
    config ``name``: raises over F0_BUDGET_CENTS; returns the reading."""
    cents, frames = golden_f0_cents(ours, golden, sr)
    if name in F0_UNSTABLE:
        return (f"F0 exempt ({cents:.1f} cents over {frames} frames)"
                if frames else "F0 exempt (no frame voiced in both)")
    if frames < F0_MIN_FRAMES:
        return f"F0 not held ({frames} frames voiced in both)"
    if not cents <= F0_BUDGET_CENTS:
        raise AssertionError(f"render {name}: F0 RMSE {cents:.2f} cents over "
                             f"the {F0_BUDGET_CENTS} cent budget")
    return (f"F0 RMSE {cents:.2f} cents over {frames} frames (budget "
            f"{F0_BUDGET_CENTS:.0f})")


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


def _blur_launches() -> int:
    return blur_kernel.gaussian_blur.launches


def render_slice(tmp: Path):
    """Render every golden config and the heavy stack twice through the
    CLI on CUDA; checks the second pass's outputs (LSD and F0 to the
    golden) and returns the warm per-note seconds and (pulse, cascade,
    blur) launches per note."""
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
            before = _launches() + (_blur_launches(),)
            t0 = time.perf_counter()
            rc = cli.main(argv)
            dt = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"render {name}: cli rc {rc}")
            if rep == 0:
                continue
            warm[name] = dt
            per_note[name] = tuple(b - a for a, b in zip(
                before, _launches() + (_blur_launches(),)))
            if name in CASCADE_CONFIGS and per_note[name][1] == 0:
                raise AssertionError(f"render {name}: no cascade launch")
            if per_note[name][2] == 0:
                raise AssertionError(f"render {name}: no blur launch")
            ours, sr = read_wav(out)
            if not np.isfinite(ours).all():
                raise AssertionError(f"render {name}: non-finite output")
            note = (f"warm {dt * 1e3:.1f} ms, launches per note: pulse "
                    f"{per_note[name][0]} cascade {per_note[name][1]} blur "
                    f"{per_note[name][2]}")
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
            f0_note = hold_f0(name, ours, golden, sr)
            print(f"render {name}: {len(ours)} samples, LSD {lsd:.3f} dB "
                  f"(budget {LSD_BUDGET_DB[name]:.2f}), {f0_note}, {note}")
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


def device_busy(prof):
    """(device busy us: the union of the profile's device events' spans;
    its kernel events, copies and memsets left out)."""
    events = device_events(prof)
    busy_us = 0.0
    end = float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us, [e for e in events
                     if not e.name.startswith(("Memcpy", "Memset"))]


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
    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            if cli.main(argv) != 0:
                raise AssertionError(f"profile {name}: cli rc != 0")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels = device_busy(prof)

    def kernel_us(name):
        return sum(e.time_range.elapsed_us() for e in kernels
                   if name in e.name)

    cascade_us = kernel_us("one_pole_cascade_kernel")
    pulse_us = kernel_us("pulse_accumulate_kernel")
    rows_us = kernel_us("blur_rows_kernel")
    cols_us = kernel_us("blur_cols_kernel")
    blur_us = rows_us + cols_us
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
        "blur_ms": blur_us / 1e3 / reps,
        "blur_share": blur_us / busy_us,
        "blur_ms_by_kernel": {"blur_rows_kernel": rows_us / 1e3 / reps,
                              "blur_cols_kernel": cols_us / 1e3 / reps},
        "blur_launches": sum(k in e.name for e in kernels for k in (
            "blur_rows_kernel", "blur_cols_kernel")) / reps,
        "table_build_kernels": sorted({e.name[:80] for e in kernels if any(
            k in e.name for k in TABLE_BUILD_KERNELS)}),
    }
    if min(out["cascade_ms"], out["pulse_ms"], out["blur_ms"]) <= 0.0:
        raise AssertionError(f"profile {name}: no cascade, pulse or blur "
                             "kernel on the device")
    print(f"profile {name} ({reps} warm renders): render "
          f"{out['render_ms']:.3f} ms per note, device busy "
          f"{out['device_busy_ms']:.3f} ms per note, idle share "
          f"{out['idle_share']:.3f}, device kernels per note "
          f"{out['device_kernels']:.1f}, cascade kernel "
          f"{out['cascade_ms']:.4f} ms per note = "
          f"{out['cascade_share']:.3f} of device busy, pulse kernel "
          f"{out['pulse_ms']:.4f} ms per note = {out['pulse_share']:.3f} "
          f"of device busy in {out['pulse_launches']:.1f} launches, blur "
          f"kernel {out['blur_ms']:.4f} ms per note = "
          f"{out['blur_share']:.3f} of device busy in "
          f"{out['blur_launches']:.1f} launches (rows "
          f"{out['blur_ms_by_kernel']['blur_rows_kernel']:.4f}, cols "
          f"{out['blur_ms_by_kernel']['blur_cols_kernel']:.4f} ms); "
          f"table-build kernels: {out['table_build_kernels'] or 'none'}")
    return out


def phrase_notes(src: str) -> dict:
    """The three phrases, shaped as the JAX package's bench.py sings them
    (there from a synthetic source): (a) 50 x (60 + 500) ms with t flags
    and 47 x (60 + 750) ms with B flags over a ten-note scale, 60 s;
    (b) 80 x (60 + 690) ms of the heavy 11-flag stack, 60 s; (c) 40 notes
    of random length 300-899 ms."""
    spec, scale = phrase.NoteSpec, PHRASE_SCALE
    a = [spec(src, scale[i % 10], length=500, consonant=60,
              flags=f"t{(i % 7 - 3) * 10}") for i in range(50)]
    a += [spec(src, scale[(i * 3) % 10], length=750, consonant=60,
               flags=f"B{(i % 5 - 2) * 10}") for i in range(47)]
    b = [spec(src, scale[i % 10], length=690, consonant=60,
              flags=HEAVY[3] + f"t{(i % 7 - 3) * 10}") for i in range(80)]
    rng = np.random.default_rng(1)
    c = [spec(src, scale[int(rng.integers(10))],
              length=int(rng.integers(300, 900)), consonant=60,
              flags=f"t{int(rng.integers(-30, 30))}") for _ in range(40)]
    return {"a": a, "b": b, "c": c}


def _audio_s(notes) -> float:
    return sum((n.consonant + n.length) / 1000.0 for n in notes)


def _render_planned(notes, bucket, quiet: bool, seed: int = 0):
    """render_phrase's float output from its own parts, with the noise
    strengths zeroed when ``quiet`` (the planner's scalars are copied:
    its memo keeps the originals)."""
    planned, _ = phrase.plan_phrase(notes, bucket=bucket)
    outs = [None] * len(planned)
    for pl in planned:
        if quiet:
            pl.scalars = dict(pl.scalars, uv_strength=0.0,
                              breath_strength=0.0)
    for (rs, _), members in phrase.group_planned(planned).items():
        rows = phrase.render_group(rs, members, seed, False,
                                   torch.device("cuda")).cpu().numpy()
        for j, m in enumerate(members):
            outs[m.index] = rows[j, :int(m.scalars["n_true"])]
    return planned, outs


def _hold(name, got, want, quiet: bool, floor: float = 0.0):
    """The parity budgets: noise stems zeroed (``quiet``), 5e-3 x peak on
    all but 0.1% of samples (a pulse onset whose phase sits within
    rounding of an integer may land one sample off) and 0.1 dB LSD; noise
    on, LSD <= max(1 dB, seed-to-seed + 0.5 dB).  Two renders that draw
    from the same noise keys are held to the first with the noise on."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape} or "
                             "non-finite")
    d = np.abs(got - want) / (np.abs(want).max() + 1e-12)
    lsd = lsd_db(got, want, SR)
    if quiet:
        if float((d > 5e-3).mean()) > 1e-3 or not lsd < 0.1:
            raise AssertionError(f"{name}: max|diff|/peak {d.max():.3e}, "
                                 f"LSD {lsd:.4f} dB over the noise-zeroed "
                                 "budget")
    elif not lsd <= max(1.0, floor + 0.5):
        raise AssertionError(f"{name}: LSD {lsd:.3f} dB over max(1, "
                             f"{floor:.3f} + 0.5)")
    return float(d.max()), lsd


def check_phrase_rows(name, notes, picks, strict: bool = False):
    """Rows ``picks`` of the phrase against the same notes rendered alone
    through render_note with the same (seed, index) key; returns the worst
    (max|diff|/peak, LSD) with the noise zeroed and with it on.  With
    ``strict`` the rows with the noise on are held to the noise-zeroed
    budget too: a row draws from its own key alone, so nothing but
    rounding that follows the batch may move it."""
    dev = torch.device("cuda")
    worst = {}
    for quiet in (True, False):
        planned, outs = _render_planned(notes, "auto", quiet)
        errs = []
        for i in picks:
            pl = planned[i]
            alone = render_note(pl.rs, pl.arrays, pl.scalars, (0, i),
                                dev).cpu().numpy()
            floor = 0.0
            if not quiet:
                floor = lsd_db(render_note(pl.rs, pl.arrays, pl.scalars,
                                           (1, i), dev).cpu().numpy(),
                               alone, SR)
            errs.append(_hold(f"phrase {name} note {i}", outs[i], alone,
                              quiet or strict, floor))
        worst[quiet] = tuple(max(e[j] for e in errs) for j in (0, 1))
    print(f"phrase {name}: rows {list(picks)} vs the note alone: noise "
          f"zeroed max|diff|/peak {worst[True][0]:.3e} LSD "
          f"{worst[True][1]:.4f} dB; noise on max|diff|/peak "
          f"{worst[False][0]:.3e} LSD {worst[False][1]:.4f} dB, held to the "
          f"{'noise-zeroed' if strict else 'seed-to-seed'} budget")
    return worst


def check_phrase_buckets(name, notes):
    """The bucketed phrase against bucket=False over every note's true
    extent, noise zeroed and on."""
    worst = {}
    for quiet in (True, False):
        exact = _render_planned(notes, False, quiet)[1]
        padded = _render_planned(notes, True, quiet)[1]
        floor = 0.0
        if not quiet:
            other = _render_planned(notes, False, quiet, seed=1)[1]
            floor = min(lsd_db(o, e, SR) for o, e in zip(other, exact))
        errs = [_hold(f"phrase {name} note {i} bucketed", p, e, quiet, floor)
                for i, (p, e) in enumerate(zip(padded, exact))]
        worst[quiet] = tuple(max(e[j] for e in errs) for j in (0, 1))
    print(f"phrase {name}: bucketed vs exact, {len(notes)} notes: noise "
          f"zeroed max|diff|/peak {worst[True][0]:.3e} LSD "
          f"{worst[True][1]:.4f} dB; noise on max|diff|/peak "
          f"{worst[False][0]:.3e} LSD {worst[False][1]:.4f} dB")
    return worst


def _sync_cards():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _median_ms(fn, reps: int, warm: int = 2) -> float:
    """Median wall ms of ``fn`` over ``reps`` runs after ``warm`` unmeasured
    ones, every card synchronized around each."""
    times = []
    for rep in range(warm + reps):
        _sync_cards()
        t0 = time.perf_counter()
        fn()
        _sync_cards()
        if rep >= warm:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phrase_slice(tmp: Path) -> dict:
    """Drive render_phrase on CUDA over the three phrases, the kernels'
    launch counters set to 0 just before and read just after, then check
    structure (groups, launches) and outputs and take the numbers.
    Returns per phrase a dict of them, and the path's launches under
    "launches"."""
    dev = torch.device("cuda")
    src = str(tmp / "voice.wav")
    phrases = phrase_notes(src)
    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    pcms, launched = {}, {}

    def counts():
        return _launches() + (_blur_launches(),)

    for name, notes in phrases.items():
        before = counts()
        pcms[name] = phrase.render_phrase(notes, pcm16=True)
        launched[name] = [b - a for a, b in zip(before, counts())]
    out = {"launches": _launches()}

    for name, notes in phrases.items():
        audio_s = _audio_s(notes)
        planned, _ = phrase.plan_phrase(notes)
        groups = phrase.group_planned(planned)
        # launches one note of each group makes alone
        want = [0, 0, 0]
        for (rs, _), members in groups.items():
            m = members[0]
            before = counts()
            render_note(rs, m.arrays, m.scalars, 0, dev)
            want = [w + b - a for w, a, b in zip(want, before, counts())]
        got, pcm = launched[name], pcms[name]
        if got != want:
            raise AssertionError(
                f"phrase {name}: {got[0]} pulse, {got[1]} cascade and "
                f"{got[2]} blur launches for {len(groups)} groups, expected "
                f"{want}: one per pass per group")
        if name == "a" and len(groups) != 2:
            raise AssertionError(f"phrase a: {len(groups)} groups, not 2")
        if name == "c" and not (len(groups) < len(notes)
                                and all(pl.rs.masked for pl in planned)):
            raise AssertionError(f"phrase c: {len(groups)} groups of "
                                 f"{len(notes)} notes, not bucketed")
        floats = phrase.render_phrase(notes)
        for i, (q, y, spec) in enumerate(zip(pcm, floats, notes)):
            n_want = int(0.06 * SR) + int(spec.length / 1000 * SR)
            if q.dtype != np.int16 or q.shape != (n_want,):
                raise AssertionError(f"phrase {name} note {i}: pcm16 gave "
                                     f"{q.dtype} {q.shape}, want {n_want}")
            if not np.isfinite(y).all() or not np.abs(q).max() > 32:
                raise AssertionError(f"phrase {name} note {i}: silent or "
                                     "non-finite")
        full_ms = _median_ms(lambda: phrase.render_phrase(notes, pcm16=True),
                             7)
        nofetch_ms = _median_ms(
            lambda: phrase.render_phrase(notes, pcm16=True, fetch=False), 7)
        reps = 3
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                phrase.render_phrase(notes, pcm16=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_us, kernels = device_busy(prof)

        def kernel_ms(kname):
            return sum(e.time_range.elapsed_us() for e in kernels
                       if kname in e.name) / 1e3 / reps

        out[name] = {
            "notes": len(notes), "audio_s": audio_s, "groups": len(groups),
            "batch_sizes": [len(m) for m in groups.values()],
            "pulse_launches": got[0], "cascade_launches": got[1],
            "blur_launches": got[2],
            "full_ms": full_ms, "nofetch_ms": nofetch_ms,
            "x_realtime": audio_s * 1e3 / full_ms,
            "x_realtime_nofetch": audio_s * 1e3 / nofetch_ms,
            "device_busy_ms": busy_us / 1e3 / reps,
            "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_kernels": len(kernels) / reps,
            "pulse_ms": kernel_ms("pulse_accumulate_kernel"),
            "cascade_ms": kernel_ms("one_pole_cascade_kernel"),
            "blur_ms": (kernel_ms("blur_rows_kernel")
                        + kernel_ms("blur_cols_kernel")),
            "blur_ms_by_kernel": {k: kernel_ms(k) for k in (
                "blur_rows_kernel", "blur_cols_kernel")},
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        }
        r = out[name]
        print(f"phrase {name}: {r['notes']} notes, {audio_s:.2f} s of audio, "
              f"{r['groups']} groups of {r['batch_sizes']} notes, launches "
              f"per phrase: pulse {got[0]} cascade {got[1]} blur {got[2]}; "
              f"warm "
              f"{full_ms:.3f} ms ({r['x_realtime']:.1f} x realtime), without "
              f"the copy to the host {nofetch_ms:.3f} ms "
              f"({r['x_realtime_nofetch']:.1f} x); profiled: device busy "
              f"{r['device_busy_ms']:.3f} ms per phrase, idle share "
              f"{r['idle_share']:.3f}, device kernels per phrase "
              f"{r['device_kernels']:.1f}, pulse kernel {r['pulse_ms']:.4f} "
              f"ms, cascade kernel {r['cascade_ms']:.4f} ms, blur kernel "
              f"{r['blur_ms']:.4f} ms; peak device "
              f"memory so far {r['peak_mib']:.0f} MiB")

    check_phrase_rows("a", phrases["a"], (0, 13, 49, 50, 96))
    # (b)'s rows with the noise on, as the port renders them (held to the
    # noise-zeroed budget) and, printed beside, with each of the two
    # batch-dependent roundings put back: cuDNN's conv1d for the blur, and
    # cuFFT's C2R reading the DC and Nyquist bins' imaginary parts
    readings = {"irfft": irfft_rows()}
    with substituted(filters, "gaussian_blur", filters.blur_plain):
        readings["plain_blur"] = check_phrase_rows(
            "b with the plain (cuDNN) blur", phrases["b"], (0, 7, 79))
    with substituted(stft, "hermitian_edges", lambda S: S):
        readings["raw_c2r"] = check_phrase_rows(
            "b with the DC and Nyquist imaginary parts left to cuFFT",
            phrases["b"], (0, 7, 79))
    readings["port"] = check_phrase_rows("b", phrases["b"], (0, 7, 79),
                                         strict=True)
    out["b"]["rows_vs_alone_noise_on"] = {
        k: v if k == "irfft" else {"max_diff_over_peak": v[False][0],
                                   "lsd_db": v[False][1]}
        for k, v in readings.items()}
    check_phrase_buckets("c", phrases["c"])

    # the 97 notes of (a) one by one, in this process
    planned, _ = phrase.plan_phrase(phrases["a"])

    def one_by_one():
        for pl in planned:
            render_note(pl.rs, pl.arrays, pl.scalars, (0, pl.index),
                        dev).cpu()

    single_ms = _median_ms(one_by_one, 3, warm=1)
    out["a"]["one_by_one_ms"] = single_ms
    print(f"phrase a: its 97 notes one by one through render_note "
          f"{single_ms:.3f} ms ({out['a']['audio_s'] * 1e3 / single_ms:.1f} "
          f"x realtime), {single_ms / out['a']['full_ms']:.1f} x the "
          "phrase render")
    return out


def recording(rel: str) -> np.ndarray:
    """One vendored recording as mono float32 at SR."""
    y, sr = read_wav_mono(REPO / rel)
    if sr != SR:
        raise AssertionError(f"{rel}: {sr} Hz, expected {SR}")
    return y.astype(np.float32)


def voicebank_cuts() -> list[np.ndarray]:
    """The 64 files of the extraction bank: cuts of the vendored
    recordings at seeded offsets, 0.4-2.0 s long (a recording shorter than
    the drawn length is taken whole), about 75 s of real voices in many
    distinct lengths."""
    rng = np.random.default_rng(2)
    sources = [recording(rel) for rel in VOICEBANK_SOURCES]
    cuts = []
    for i in range(BANK_FILES):
        y = sources[i % len(sources)]
        n = min(len(y), int(rng.uniform(0.4, 2.0) * SR))
        start = int(rng.integers(0, len(y) - n + 1))
        cuts.append(y[start:start + n])
    return cuts


def pcm16(y: np.ndarray) -> np.ndarray:
    """``y`` as write_wav stores and read_wav_mono returns it."""
    q = np.round(np.clip(y.astype(np.float64), -1.0, 32767.0 / 32768.0)
                 * 32768.0)
    return (q / 32768.0).astype(np.float32)


def bank_chunk(dev):
    """The device inputs of the bank's largest chunk (most rows x frames)
    as extract_features_batch forms it: (y, n_true, p_starts, p_nf,
    f_starts), and its file count."""
    cuts = [pcm16(y) for y in voicebank_cuts()]
    plan = list(features.chunk_plan([len(y) for y in cuts], HOP,
                                    features.EXTRACT_CHUNK_FILES,
                                    features.EXTRACT_CHUNK_FRAMES))
    n_pad, part = max(plan, key=lambda c: len(c[1]) * c[0])
    inputs = features.chunk_inputs([cuts[i] for i in part], n_pad, SR, HOP)
    return tuple(torch.as_tensor(a, device=dev) for a in inputs[:5]), len(part)


def ragged_rows(dev, batch: int = 16):
    """``batch`` cuts of the recordings with ragged lengths, from one too
    short for a second pitch frame (nf = 1) to whole 2 s recordings
    (nf = F): the padded waveforms, true counts and both frame grids with
    F the longest row's frame count."""
    sources = [recording(rel) for rel in VOICEBANK_SOURCES[:6]]
    rng = np.random.default_rng(3)
    lengths = [1900, len(sources[0]), len(sources[1])] + [
        int(rng.uniform(0.1, 2.0) * SR) for _ in range(batch - 3)]
    ys = [sources[i % 6][:n] for i, n in enumerate(lengths)]
    cfg = pitch.PitchConfig()
    p_grids = [pitch._frame_grid(len(y), SR, HOP / SR,
                                 min(pitch.pitch_window_len(SR, cfg),
                                     max(16, len(y)))) for y in ys]
    f_grids = [formants.formant_frame_grid(len(y), SR, HOP / SR) for y in ys]
    yb = np.zeros((batch, max(lengths) + 8 * HOP), np.float32)
    for j, y in enumerate(ys):
        yb[j, :len(y)] = y
    p_starts, p_nf = pitch.padded_grid(p_grids)
    f_starts, _ = pitch.padded_grid(f_grids)
    return tuple(torch.as_tensor(a, device=dev) for a in (
        yb, np.array(lengths, np.int32), p_starts, p_nf, f_starts))


def seeded_candidates(batch: int, frames: int, seed: int,
                      unvoiced_only: bool = False):
    """Pitch candidates as the tracker makes them, from a generator: a
    wandering fundamental with its octave and fifth relatives at falling
    strengths, a quarter of the slots empty (-1e9), unvoiced stretches,
    and ragged frame counts (row 0 full, row 1 a single frame)."""
    rng = np.random.default_rng(seed)
    base = 110.0 * 2 ** rng.uniform(0, 2, (batch, 1)) * 2 ** np.cumsum(
        0.01 * rng.standard_normal((batch, frames)), axis=1)
    k = 6
    mult = np.array([1.0, 0.5, 2.0, 1.5, 3.0, 0.75])
    freqs = np.clip(base[..., None] * mult * (1 + 0.01 * rng.standard_normal(
        (batch, frames, k))), 37.5, 950.0)
    strengths = rng.uniform(0.3, 0.95, (batch, frames, k)) * np.array(
        [1.0, 0.8, 0.8, 0.6, 0.5, 0.5])
    quiet = np.sin(2 * np.pi * (np.arange(frames) / 97.0
                                + rng.random((batch, 1)))) > 0.6
    strengths[quiet] *= 0.3
    strengths[rng.random((batch, frames, k)) < 0.25] = -1e9
    if unvoiced_only:
        strengths[:] = -1e9
    unvoiced = 0.45 + np.maximum(0.0, rng.normal(-0.5, 1.0, (batch, frames)))
    nf = rng.integers(1, frames + 1, batch)
    nf[0] = frames
    if batch > 1:
        nf[1] = 1
    return (freqs.astype(np.float32), strengths.astype(np.float32),
            unvoiced.astype(np.float32), nf.astype(np.int32))


def viterbi_cases(dev):
    """(name, freqs, strengths, unvoiced_strength, nf) on ``dev``: the
    candidates of a whole 2 s recording (B = 1, F = 338), of 16 ragged cuts
    (nf from 1 to F), of the bank's largest chunk, and seeded ones at B =
    64, F = 700, all unvoiced, and a long row whose backpointers overflow
    the kernel's shared memory into its global scratch."""
    def put(case):
        return tuple(torch.as_tensor(a, device=dev) for a in case)

    whole = torch.as_tensor(recording(VOICEBANK_SOURCES[0])[None], device=dev)
    y, _, p_starts, p_nf, _ = ragged_rows(dev)
    (yc, _, pc_starts, pc_nf, _), _ = bank_chunk(dev)
    dt = HOP / SR
    cases = [
        ("real_b1_f338", *pitch.viterbi_inputs(whole, SR, dt)),
        ("real_b16_ragged", *pitch.viterbi_inputs(y, SR, dt, starts=p_starts,
                                                  nf=p_nf)),
        ("bank_chunk", *pitch.viterbi_inputs(yc, SR, dt, starts=pc_starts,
                                             nf=pc_nf)),
        ("seeded_b64_f700", *put(seeded_candidates(64, 700, 0))),
        ("unvoiced_b4_f338", *put(seeded_candidates(4, 338, 1, True))),
        ("long_b2_f10300", *put(seeded_candidates(2, 10300, 2))),
    ]
    if cases[0][1].shape[1] != 338:
        raise AssertionError(f"a 2 s recording gave {cases[0][1].shape[1]} "
                             "pitch frames, expected 338")
    if 10300 * 7 <= viterbi_kernel.SHARED_BACK_BYTES:
        raise AssertionError("the long row fits the kernel's shared memory")
    return cases


def host_ms(fn) -> float:
    """Wall ms of one call of ``fn`` with the device drained around it:
    for the plain versions, loops of thousands of small launches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_viterbi_kernel(cases):
    """Kernel vs viterbi_plain on the card, exact equality of f0 and path;
    returns the largest |f0 diff| in Hz and the count of path frames that
    differ, both measured and both 0 when this returns, and each case's
    (B, F, dependent steps, kernel ms, plain ms, bound ms, what bounds
    it)."""
    vu, oj = pitch.transition_costs(pitch.PitchConfig(), HOP / SR)
    rows = {}
    worst, worst_frames = 0.0, 0
    for name, freqs, strengths, unvoiced, nf in cases:
        args = (freqs, strengths, unvoiced, nf, vu, oj)
        f0, path = viterbi_kernel.pitch_viterbi(*args)
        want_f0, want_path = pitch.viterbi_plain(*args)
        torch.cuda.synchronize()
        err = float((f0 - want_f0).abs().max())
        bad = int((path.long() != want_path).sum())
        if not (err == 0.0 and bad == 0):
            raise AssertionError(f"pitch_viterbi {name}: {bad} frames of the "
                                 "path differ from the plain version's, f0 "
                                 f"by up to {err} Hz")
        worst, worst_frames = max(worst, err), max(worst_frames, bad)
        if name.startswith("unvoiced") and float(f0.abs().max()) != 0.0:
            raise AssertionError(f"pitch_viterbi {name}: voiced frames")
        batch, frames, k = freqs.shape
        ms = cuda_ms(lambda: viterbi_kernel.pitch_viterbi(*args))
        p_ms = host_ms(lambda: pitch.viterbi_plain(*args))
        steps = int(nf.max()) - 1
        live = int(torch.clamp(nf - 1, min=0).sum())
        # candidates, strengths, unvoiced and nf read once, f0 and the
        # path written once; per live frame (K+1)^2 transitions
        bound, bound_by = bound_ms(
            4 * batch * frames * (2 * k + 1) + 4 * batch
            + 8 * batch * frames,
            VITERBI_OPS_PER_TRANSITION * (k + 1) ** 2 * live)
        voiced = float((f0 > 0).float().mean())
        print(f"pitch_viterbi {name}: B={batch} F={frames} K={k} nf "
              f"{int(nf.min())}-{int(nf.max())} voiced share {voiced:.3f} "
              f"max|f0 diff|={err} Hz, {bad} path frames differ; kernel "
              f"{ms:.5f} ms ({steps} dependent steps, "
              f"{ms * 1e3 / max(steps, 1):.3f} us per step) plain "
              f"{p_ms:.2f} ms bound {bound:.6f} ms ({bound_by})")
        rows[name] = (batch, frames, steps, ms, p_ms, bound, bound_by)
    return worst, worst_frames, rows


def known_root_polys(rows: int, seed: int, order: int = 10):
    """(coeffs (rows, order + 1) float32 monic, roots (rows, order)
    complex128): real polynomials with order // 2 conjugate root pairs
    inside the unit circle, like stable LPC polynomials, their angles kept
    apart so that float32 coefficients still pin the roots, and one real
    root in (-0.9, 0.9) at an odd order."""
    rng = np.random.default_rng(seed)
    half_n = order // 2
    r = rng.uniform(0.6, 0.98, (rows, half_n))
    th = (np.arange(half_n) + 0.5
          + rng.uniform(-0.3, 0.3, (rows, half_n))) * np.pi / max(half_n, 1)
    half = r * np.exp(1j * th)
    real = rng.uniform(-0.9, 0.9, (rows, order % 2))
    roots = np.concatenate([half, half.conj(), real], axis=1)
    coeffs = np.ones((rows, 1), np.complex128)
    for j in range(order):
        coeffs = (np.concatenate([coeffs, np.zeros((rows, 1))], axis=1)
                  - roots[:, j:j + 1] * np.concatenate(
                      [np.zeros((rows, 1)), coeffs], axis=1))
    return coeffs.real.astype(np.float32), roots


def lpc_cases(dev):
    """(name, windowed frames (rows, 551) float32 or None, coeffs (rows, 11)
    or None, known roots or None) on ``dev``: the Burg frames of a whole
    recording (plus one all-zero frame), of the 16 ragged cuts and of the
    bank's largest chunk, and 64 x 700 seeded polynomials with known
    roots.  Coefficients of a frames case come from the Burg kernel."""
    dt = HOP / SR
    whole = torch.as_tensor(recording(VOICEBANK_SOURCES[0])[None], device=dev)
    one = formants.lpc_frames(whole, SR, dt)[0][0]
    one = torch.cat([one, torch.zeros_like(one[:1])])
    y, n_true, _, _, f_starts = ragged_rows(dev)
    ragged = formants.lpc_frames(y, SR, dt, starts=f_starts,
                                 n_true=n_true.long())[0]
    (yc, nc, _, _, fc_starts), _ = bank_chunk(dev)
    chunk = formants.lpc_frames(yc, SR, dt, starts=fc_starts,
                                n_true=nc.long())[0]
    coeffs, roots = known_root_polys(64 * 700, 4)
    return [
        ("real_b1", one.contiguous(), None, None),
        ("real_b16_ragged", ragged.reshape(-1, ragged.shape[-1]), None, None),
        ("bank_chunk", chunk.reshape(-1, chunk.shape[-1]), None, None),
        ("seeded_64x700", None, torch.as_tensor(coeffs, device=dev), roots),
    ]


def check_burg_kernel(cases):
    """Burg kernel vs burg_coeffs_plain on the card for every case that has
    frames; returns the worst max |diff|, each case's coefficients and its
    (rows, wlen, kernel ms, plain ms, plain device kernels, bound ms, what
    bounds it)."""
    worst = 0.0
    rows, coeffs = {}, {}
    for name, frames, given, _ in cases:
        if frames is None:
            coeffs[name] = given
            continue
        got = burg_kernel.burg_lpc(frames, LPC_ORDER)
        want = formants.burg_coeffs_plain(frames, LPC_ORDER)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"burg_lpc {name}: non-finite coefficients")
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=BURG_RTOL, atol=BURG_ATOL):
            raise AssertionError(f"burg_lpc {name}: max |diff| {err} beyond "
                                 f"rtol {BURG_RTOL} atol {BURG_ATOL}")
        n, wlen = frames.shape
        ms = cuda_ms(lambda: burg_kernel.burg_lpc(frames, LPC_ORDER))
        p_ms = cuda_ms(lambda: formants.burg_coeffs_plain(frames, LPC_ORDER),
                       PLAIN_REPS, gap_free=False)
        with device_profile() as prof:
            formants.burg_coeffs_plain(frames, LPC_ORDER)
            torch.cuda.synchronize()
        p_kernels = len(device_busy(prof)[1])
        # frames read once, coefficients written once; per step and live
        # sample 6 flops of the two sums and 4 of the two updates
        bound, bound_by = bound_ms(
            4 * n * (wlen + LPC_ORDER + 1),
            10 * n * sum(wlen - m for m in range(1, LPC_ORDER + 1)))
        print(f"burg_lpc {name}: rows={n} wlen={wlen} order={LPC_ORDER} "
              f"max|diff|={err:.3e} kernel {ms:.5f} ms plain {p_ms:.4f} ms "
              f"in {p_kernels} device kernels bound {bound:.5f} ms "
              f"({bound_by})")
        worst = max(worst, err)
        rows[name] = (n, wlen, ms, p_ms, p_kernels, bound, bound_by)
        coeffs[name] = got
    return worst, coeffs, rows


def matched_root_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row the largest distance from a root of either (rows, order)
    set to the nearest root of the other."""
    d = (got[:, :, None] - want[:, None, :]).abs()
    return torch.maximum(d.amin(dim=2).amax(dim=1), d.amin(dim=1).amax(dim=1))


def check_lpc_roots_kernel(cases, coeffs):
    """Root kernel vs poly_roots_dk_plain on the card: roots matched per
    row, max |diff| <= ROOTS_TOL on rows whose plain roots all pass the
    convergence guard, the same NaN pattern everywhere, known roots found;
    returns the worst matched diff and each case's (rows, converged share,
    kernel ms, plain ms, eigvals ms, bound ms, what bounds it)."""
    worst = 0.0
    rows = {}
    for name, _, _, known in cases:
        a = coeffs[name].contiguous()
        got = lpc_roots_kernel.lpc_roots(a)
        want = formants.poly_roots_dk_plain(a)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(torch.view_as_real(got)),
                           torch.isnan(torch.view_as_real(want))):
            raise AssertionError(f"lpc_roots {name}: NaNs where the plain "
                                 "version has none, or the reverse")
        conv = formants.converged_roots(a, want).all(dim=1)
        if not conv.any():
            raise AssertionError(f"lpc_roots {name}: no converged row")
        err = float(matched_root_error(got[conv], want[conv]).max())
        if not err <= ROOTS_TOL:
            raise AssertionError(f"lpc_roots {name}: matched roots differ by "
                                 f"{err} > {ROOTS_TOL} on converged rows")
        note = ""
        if known is not None:
            truth = torch.as_tensor(known, device=a.device).to(
                torch.complex64)
            k_err = float(matched_root_error(got[conv], truth[conv]).max())
            note = f" known roots within {k_err:.3e}"
            if not k_err <= 1e-3:
                raise AssertionError(f"lpc_roots {name}: known roots missed "
                                     f"by {k_err}")
        n, order = got.shape
        ms = cuda_ms(lambda: lpc_roots_kernel.lpc_roots(a))
        p_ms = host_ms(lambda: formants.poly_roots_dk_plain(a))
        # the library's way to the same roots: eigenvalues of the
        # companion matrices (a yardstick; the port never calls it)
        comp = torch.zeros((n, order, order), device=a.device)
        comp[:, 0, :] = -a[:, 1:]
        comp[:, torch.arange(1, order), torch.arange(order - 1)] = 1.0
        lib_ms = None
        if n <= EIGVALS_MAX_ROWS:
            torch.linalg.eigvals(comp[:8])
            lib_ms = host_ms(lambda: torch.linalg.eigvals(comp))
        # coefficients read once, roots written once; per root and
        # iteration `order` Horner steps of 7 flops, order - 1 difference
        # products of 8 and a division and update of 14
        bound, bound_by = bound_ms(
            4 * n * (order + 1) + 8 * n * order,
            n * order * lpc_roots_kernel.DK_ITERS
            * (7 * order + 8 * (order - 1) + 14))
        share = float(conv.float().mean())
        print(f"lpc_roots {name}: rows={n} order={order} converged rows "
              f"{share:.4f} matched max|diff|={err:.3e}{note} kernel "
              f"{ms:.5f} ms plain {p_ms:.2f} ms eigvals "
              f"{'not timed' if lib_ms is None else f'{lib_ms:.2f} ms'} "
              f"bound {bound:.6f} ms ({bound_by})")
        worst = max(worst, err)
        rows[name] = (n, share, ms, p_ms, lib_ms, bound, bound_by)
    return worst, rows


def _analysis_launches():
    return (viterbi_kernel.pitch_viterbi.launches,
            lpc_roots_kernel.lpc_roots.launches,
            burg_kernel.burg_lpc.launches)


def _f16_track_equal(name, got, want, share: float = 0.999):
    """Two per-sample tracks at the .goofy's float16: equal on at least
    ``share`` of samples and within one float16 step elsewhere (a float32
    rounding that differs with the batch size can flip a value sitting on
    a float16 rounding boundary)."""
    a = np.asarray(got, np.float16)
    b = np.asarray(want, np.float16)
    same = a == b
    step = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    if a.shape != b.shape or same.mean() < share or np.any(
            np.abs(a.astype(np.float32) - b.astype(np.float32))[~same]
            > step[~same].astype(np.float32) * 1.001):
        raise AssertionError(f"{name}: float16 tracks differ on "
                             f"{1 - same.mean():.5f} of samples")
    return float(same.mean())


def knot_steps(a, b) -> float:
    """The largest difference of two (K, T) float16 log-envelope knot
    arrays in float16 steps at each value's size, beyond the float32 floor
    of the analysis: a frame's FFT rounds every bin relative to the
    frame's largest (cuFFT's plan, and so its rounding, changes with the
    batch size), so a knot at envelope e of a frame with peak p carries
    KNOT_F32_FLOOR * p / e of log-domain rounding before it is stored."""
    a = np.asarray(a).astype(np.float32)
    b = np.asarray(b).astype(np.float32)
    big = np.maximum(np.abs(a), np.abs(b))
    step = np.spacing(big.astype(np.float16)).astype(np.float32)
    peak = np.maximum(a, b).max(axis=0, keepdims=True)
    floor = KNOT_F32_FLOOR * np.exp(peak - np.minimum(a, b))
    return float((np.maximum(np.abs(a - b) - floor, 0.0) / step).max())


def _formants_close(name, got, want, hz: float = 1.0, share: float = 0.99):
    """Formant dicts {k: (T,)}: the share of (formant, frame) entries
    within ``hz``; raises under ``share``."""
    g = np.stack([np.asarray(got[k], np.float64) for k in (1, 2, 3, 4)])
    w = np.stack([np.asarray(want[k], np.float64) for k in (1, 2, 3, 4)])
    ok = float((np.abs(g - w) <= hz).mean()) if g.shape == w.shape else 0.0
    if ok < share:
        raise AssertionError(f"{name}: formant tracks {g.shape} vs {w.shape}, "
                             f"{ok:.4f} of entries within {hz} Hz")
    return ok


def _decoded_db(knots: dict) -> np.ndarray:
    """A knot dict's log-envelope in dB, (n_bins, T), decoded on the card."""
    k = torch.as_tensor(np.asarray(knots["knot_vals_log"], np.float32),
                        device=config.get_device())
    env = envelope.decode_env_from_knots(k, knots["sr"], knots["n_fft"],
                                         knots["n_bins"])
    return (20.0 * torch.log10(env)).cpu().numpy()


def render_goldens_from_wav(tmp: Path, kind: str) -> None:
    """The goldens of source ``kind`` through the CLI on CUDA from a fresh
    directory that holds the source WAV alone: the first render extracts
    and saves the .goofy, and every output is held to its golden's LSD
    budget and pitch gate."""
    work = tmp / f"fresh_{kind}"
    work.mkdir()
    src = work / "src.wav"
    shutil.copy(REPO / "tests" / "golden" / kind / "src.wav", src)
    before = _analysis_launches()
    renders = []
    for k, (name, *args) in _golden_configs():
        if k != kind:
            continue
        out = work / f"out_{name}.wav"
        if cli.main([str(src), str(out)] + [str(a) for a in args]) != 0:
            raise AssertionError(f"render {name} from the WAV: cli rc != 0")
        ours, sr = read_wav(out)
        golden, sr_g = read_wav(REPO / "tests" / "golden" / kind
                                / f"out_{name}.wav")
        if sr != sr_g or len(ours) != len(golden) or not np.isfinite(
                ours).all():
            raise AssertionError(f"render {name} from the WAV: {len(ours)} "
                                 f"samples at {sr} Hz, golden {len(golden)}")
        renders.append((name, ours, golden, sr))
    if not (work / "src_features.goofy").exists():
        raise AssertionError(f"{kind}: the first render saved no .goofy")
    ran = [b - a for a, b in zip(before, _analysis_launches())]
    if ran != [1, 1, 1]:
        raise AssertionError(f"{kind}: the renders extracted with {ran} "
                             "Viterbi, root and Burg launches, expected one "
                             "of each (the first render only)")
    # after the launch check: the pitch gate tracks on the card too
    for name, ours, golden, sr in renders:
        lsd = lsd_db(np.asarray(ours, np.float32),
                     np.asarray(golden, np.float32), sr)
        f0_note = hold_f0(name, ours, golden, sr)
        print(f"render {name} from the port's own extraction: LSD "
              f"{lsd:.3f} dB (budget {LSD_BUDGET_DB[name]:.2f}), {f0_note}")
        if not lsd <= LSD_BUDGET_DB[name]:
            raise AssertionError(f"render {name} from the WAV: LSD {lsd} dB "
                                 f"over budget {LSD_BUDGET_DB[name]}")


def check_real_voice(feats) -> None:
    """Sanity of what was extracted from the recorded sung vowel
    (tests/test_analysis.py:test_real_voice_extraction_sane)."""
    env, f0i, vmask, forms, _ = feats
    if not (np.isfinite(env).all() and env.min() >= 0.0):
        raise AssertionError("real voice: envelope negative or non-finite")
    voiced = float((vmask > 0).mean())
    f0v = f0i[vmask > 0]
    lo, hi = np.percentile(f0v, [5, 95])
    med = {}
    for k in (1, 2, 3):
        tr = np.asarray(forms[k], np.float64)
        good = tr[np.isfinite(tr) & (tr > 0)]
        if not len(good) > 0.8 * tr.size:
            raise AssertionError(f"real voice: F{k} found on {len(good)} of "
                                 f"{tr.size} frames")
        med[k] = float(np.median(good))
    print(f"real voice (_input.wav): voiced {voiced:.3f}, f0 median "
          f"{np.median(f0v):.1f} Hz (5-95% {lo:.1f}-{hi:.1f}), formant "
          f"medians {med[1]:.0f} {med[2]:.0f} {med[3]:.0f} Hz")
    if not (voiced > 0.8 and 150.0 < np.median(f0v) < 260.0 and lo > 100.0
            and hi < 350.0 and 300.0 < med[1] < 900.0
            and 900.0 < med[2] < 2500.0 and 1800.0 < med[3] < 3500.0
            and med[1] < med[2] < med[3]):
        raise AssertionError("real voice: extraction out of the vocal range")


def analysis_slice(tmp: Path) -> dict:
    """Drive the analysis path on CUDA: extract a 64-file voicebank
    folder through the CLI (the three analysis kernels' launch counters
    set to 0 just before and read just after), check what was written,
    render the goldens from the port's own extraction, and take the
    numbers.  Returns them, with the path's launches under "launches"."""
    dev = torch.device("cuda")
    bank = tmp / "bank"
    bank.mkdir()
    cuts = voicebank_cuts()
    for i, y in enumerate(cuts):
        write_wav(bank / f"v{i:02d}.wav", y, SR)
    audio_s = sum(len(y) for y in cuts) / SR
    plan = list(features.chunk_plan([len(y) for y in cuts], HOP,
                                    features.EXTRACT_CHUNK_FILES,
                                    features.EXTRACT_CHUNK_FRAMES))

    for k in (viterbi_kernel.pitch_viterbi, lpc_roots_kernel.lpc_roots,
              burg_kernel.burg_lpc):
        k.launches = 0
    if cli.main([str(bank)]) != 0:
        raise AssertionError("folder extraction: cli rc != 0")
    launches = _analysis_launches()
    goofy = sorted(bank.glob("*_features.goofy"))
    if len(goofy) != BANK_FILES:
        raise AssertionError(f"folder extraction wrote {len(goofy)} .goofy "
                             f"files for {BANK_FILES} WAVs")
    if list(launches) != [len(plan)] * 3:
        raise AssertionError(
            f"folder extraction: {launches} Viterbi, root and Burg launches "
            f"for {len(plan)} chunks, expected one of each per chunk")
    stamps = [p.stat().st_mtime_ns for p in goofy]
    if cli.main([str(bank)]) != 0 or stamps != [
            p.stat().st_mtime_ns for p in goofy] or list(
                _analysis_launches()) != list(launches):
        raise AssertionError("folder extraction: the second run did not "
                             "skip every file")
    print(f"folder extraction: {BANK_FILES} files, {audio_s:.2f} s of "
          f"audio, {len({len(y) for y in cuts})} distinct lengths, "
          f"{len(plan)} chunks of {[len(p) for _, p in plan]} files at "
          f"{[n for n, _ in plan]} padded samples; launches: Viterbi "
          f"{launches[0]} roots {launches[1]} Burg {launches[2]}; the second "
          "run skipped all")

    # batch rows against the same files alone
    ks = []
    for i in (0, 9, 23, 38, 51, 63):
        y, _ = read_wav_mono(bank / f"v{i:02d}.wav")
        _, f0_a, m_a, forms_a, kn_a = features.extract_features(
            y, SR, N_FFT, HOP, dense=False)
        kn_b, f0_b, m_b, forms_b, _, ylen = load_features(
            bank / f"v{i:02d}_features.goofy")
        name = f"folder row {i} vs the file alone"
        _f16_track_equal(name + " (f0)", f0_b, f0_a)
        _f16_track_equal(name + " (mask)", m_b, m_a)
        k_a, k_b = kn_a["knot_vals_log"], kn_b["knot_vals_log"]
        if ylen != len(y) or k_a.shape != k_b.shape:
            raise AssertionError(f"{name}: K {k_b.shape[0]} vs {k_a.shape[0]} "
                                 f"or length {ylen} vs {len(y)}")
        if knot_steps(k_a, k_b) > 1.001:
            raise AssertionError(f"{name}: knots differ by "
                                 f"{knot_steps(k_a, k_b)} float16 steps")
        _formants_close(name, forms_b, forms_a)
        ks.append(k_a.shape[0])
    print(f"folder rows (0, 9, 23, 38, 51, 63) equal the files alone: f0 "
          f"and mask at float16, K {ks}, knots to 1 float16 step, formants "
          "within 1 Hz on >= 99%")

    # against the cache the JAX package wrote for the same recording
    voice = REPO / "tests" / "golden" / "voice"
    y, _ = read_wav_mono(voice / "src.wav")
    ours = features.extract_features(y, SR, N_FFT, HOP)
    kn_r, f0_r, m_r, _, _, _ = load_features(voice / "src_features.goofy")
    agree = ((ours[2] > 0) == (m_r > 0)) & (
        (m_r <= 0) | (np.abs(ours[1] - f0_r) <= 0.01 * f0_r))
    db_o, db_r = _decoded_db(ours[4]), _decoded_db(kn_r)
    t = min(db_o.shape[1], db_r.shape[1])
    env_db = np.abs(db_o[:, :t] - db_r[:, :t])
    print(f"voice src vs the vendored .goofy: voicing and f0 (1%) agree on "
          f"{agree.mean():.4f} of samples; K {ours[4]['knot_vals_log'].shape[0]}"
          f" vs {kn_r['knot_vals_log'].shape[0]}; log-envelope |diff| mean "
          f"{env_db.mean():.3f} dB, max {env_db.max():.2f} dB")
    if not agree.mean() >= 0.98:
        raise AssertionError("voice src: f0 or voicing disagree with the "
                             f"vendored .goofy on {1 - agree.mean():.4f}")

    y_in, _ = read_wav_mono(REPO / "_input.wav")
    check_real_voice(features.extract_features(y_in, SR, N_FFT, HOP))
    render_goldens_from_wav(tmp, "voice")
    render_goldens_from_wav(tmp, "ref")

    # the numbers: analysis alone on decoded files, then the folder run
    decoded = [read_wav_mono(p)[0] for p in sorted(bank.glob("v*.wav"))]

    def extract():
        features.extract_features_batch(decoded, SR, N_FFT, HOP, dense=False)

    def folder():
        for p in goofy:
            p.unlink()
        if cli.main([str(bank)]) != 0:
            raise AssertionError("folder extraction: cli rc != 0")

    extract_ms = _median_ms(extract, 5)
    folder_ms = _median_ms(folder, 3, warm=1)
    reps = 3
    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            extract()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels = device_busy(prof)

    def kernel_ms(kname):
        return sum(e.time_range.elapsed_us() for e in kernels
                   if kname in e.name) / 1e3 / reps

    out = {
        "launches": launches, "files": BANK_FILES, "audio_s": audio_s,
        "chunks": len(plan), "chunk_files": [len(p) for _, p in plan],
        "extract_ms": extract_ms, "folder_ms": folder_ms,
        "x_realtime": audio_s * 1e3 / extract_ms,
        "x_realtime_folder": audio_s * 1e3 / folder_ms,
        "device_busy_ms": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "device_kernels": len(kernels) / reps,
        "viterbi_ms": kernel_ms("pitch_viterbi_kernel"),
        "roots_ms": kernel_ms("lpc_roots_kernel"),
        "burg_ms": kernel_ms("burg_lpc_kernel"),
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }
    print(f"analysis: {BANK_FILES} files, {audio_s:.2f} s of audio in "
          f"{len(plan)} chunks: warm {extract_ms:.3f} ms without reads and "
          f"writes ({out['x_realtime']:.1f} x realtime), {folder_ms:.3f} ms "
          f"with them ({out['x_realtime_folder']:.1f} x); profiled: device "
          f"busy {out['device_busy_ms']:.3f} ms, idle share "
          f"{out['idle_share']:.3f}, device kernels {out['device_kernels']:.1f}"
          f", Viterbi kernel {out['viterbi_ms']:.4f} ms, root kernel "
          f"{out['roots_ms']:.4f} ms, Burg kernel {out['burg_ms']:.4f} ms "
          f"per folder; peak device memory so far {out['peak_mib']:.0f} MiB")
    return out


def check_flag_notes(tmp: Path) -> None:
    """One note each with positive st, with fc fd FV P and with velocity
    other than 100 on the card, held to the port's CPU render of the same
    note and seed (the noise is counter-based, the same on both devices):
    LSD <= 1 dB."""
    cases = [("st_pos", "C4", 100, "st40"),
             ("fc_fd_fv_p", "D4", 100, "fc12fd-10FV1P60"),
             ("velocity", "E4", 150, "")]
    for name, note, vel, flags in cases:
        outs = []
        for dev in ("cuda", "cpu"):
            out = tmp / f"flag_{name}_{dev}.wav"
            GooferResampler(tmp / "voice.wav", out, note, vel, flags, 100,
                            700, 120, 0, 100, 0, "!120", "AA", device=dev)
            outs.append(np.asarray(read_wav(out)[0], np.float32))
        if outs[0].shape != outs[1].shape or not np.isfinite(outs[0]).all():
            raise AssertionError(f"note {name}: {outs[0].shape} samples on "
                                 f"the card, {outs[1].shape} on the CPU")
        lsd = lsd_db(outs[0], outs[1], SR)
        print(f"note {name} ({flags or 'no flags'}, velocity {vel}): LSD "
              f"card vs CPU {lsd:.4f} dB, peak {np.abs(outs[0]).max():.3f}")
        if not (lsd <= 1.0 and np.abs(outs[0]).max() > 0.01):
            raise AssertionError(f"note {name}: LSD {lsd} dB card vs CPU, or "
                                 "silent")


def burst_args(src: Path, out_dir: Path, count: int, tag: str) -> list:
    """``count`` POST argument lists on ``src``, one per note of a scale,
    plain ``t`` flags and the heavy 11-flag stack in turns, 60 + 250-550
    ms each, writing ``out_dir/<tag><j>.wav``."""
    return [[str(src), str(out_dir / f"{tag}{j}.wav"), PHRASE_SCALE[j % 10],
             "100", HEAVY[3] if j % 2 else f"t{(j % 7 - 3) * 10}", "0",
             str(250 + 20 * j), "60", "0", "100", "0", "!120", "AA"]
            for j in range(count)]


def _post(url: str, body: str) -> int:
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status


def _pcm_float(path) -> np.ndarray:
    return np.asarray(read_wav(path)[0], np.float32)


def _burst(url: str, args: list) -> float:
    """POST every argument list at once from its own thread; returns the
    wall ms from the first send to the last reply, and raises unless
    every reply is 200."""
    results = [None] * len(args)
    started = []
    barrier = threading.Barrier(len(args),
                                action=lambda: started.append(
                                    time.perf_counter()))

    def post(j):
        barrier.wait()
        try:
            results[j] = _post(url, " ".join(args[j]))
        except Exception as e:
            results[j] = e

    threads = [threading.Thread(target=post, args=(j,))
               for j in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_ms = (time.perf_counter() - started[0]) * 1e3
    if any(t.is_alive() for t in threads) or results != [200] * len(args):
        raise AssertionError(f"server burst: replies {results}")
    return wall_ms


def server_slice(tmp: Path) -> dict:
    """Drive the port's HTTP server in-process on the card: warm-up, one
    POST held to the CLI render of the same arguments (PCM-equal), its
    warm latency, then bursts of 16 POSTs from 16 threads (the kernels'
    launch counters set to 0 just before and read just after), each
    burst's notes held to render_phrase of the same notes in the
    batcher's order (equal at int16) and to the CLI's render (PERF.md
    section 2's row-vs-note-alone budget, noise on, at the row's noise
    key), and a malformed
    body answered 500 with a traceback.  Returns the numbers, with the
    path's launches under "launches"."""
    os.environ[config.DEVICE_ENV] = "cuda"
    src = tmp / "voice.wav"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as warm:
        server.warmup(warm)
    warmup_s = time.perf_counter() - t0
    httpd = server.ThreadedHTTPServer(("127.0.0.1", 0), server.RequestHandler)
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    batcher = server._batcher
    batches = []
    render = batcher._render
    batcher._render = lambda batch: (
        batches.append([r.args for r in batch]), render(batch))[1]
    try:
        single = burst_args(src, tmp, 1, "single")[0]
        alone = tmp / "single_cli.wav"
        if (_post(url, " ".join(single)) != 200
                or cli.main([single[0], str(alone)] + single[2:]) != 0):
            raise AssertionError("server: the single POST or its CLI "
                                 "render failed")
        if not np.array_equal(read_wav(single[1])[0], read_wav(alone)[0]):
            raise AssertionError("server: the single POST's WAV differs "
                                 "from the CLI render of its arguments")
        single_ms = []
        for _ in range(7):
            t0 = time.perf_counter()
            _post(url, " ".join(single))
            single_ms.append((time.perf_counter() - t0) * 1e3)

        runs = [burst_args(src, tmp, SERVER_BURST, f"burst{r}_")
                for r in range(SERVER_BURST_REPS)]
        fallbacks = batcher.fallback_count
        batches.clear()
        pulse_kernel.pulse_accumulate.launches = 0
        cascade_kernel.one_pole_cascade.launches = 0
        walls = [_burst(url, args) for args in runs]
        launches = _launches()
        sizes = [len(b) for b in batches]
        if batcher.fallback_count != fallbacks:
            raise AssertionError("server: a well-formed burst fell back to "
                                 "per-note rendering")
        per_burst = len(sizes) / SERVER_BURST_REPS
        if sum(sizes) != SERVER_BURST * SERVER_BURST_REPS or per_burst > 2:
            raise AssertionError(f"server: bursts of {SERVER_BURST} POSTs "
                                 f"dispatched as {sizes}")
        if min(launches) <= 0:
            raise AssertionError(f"server: bursts launched the pulse and "
                                 f"cascade kernels {launches} times")

        # the last burst's WAVs: render_phrase of each batch in the
        # batcher's order, and the CLI's render (GooferResampler) of each
        # note at its row's noise key (seed 0, index in the batch)
        last = [b for b in batches if b[0][1] in {a[1] for a in runs[-1]}]
        worst, worst_floor = (0.0, 0.0), 0.0
        for batch in last:
            if len(batch) < server.BurstBatcher.MIN_PHRASE:
                for a in batch:
                    cli.main([a[0], str(alone)] + a[2:])
                    if not np.array_equal(read_wav(a[1])[0],
                                          read_wav(alone)[0]):
                        raise AssertionError(f"server: {a[1]} differs from "
                                             "the CLI render")
                continue
            want = phrase.render_phrase(
                [phrase.NoteSpec(a[0], *a[2:]) for a in batch], pcm16=True,
                bucket=True)
            for k, (a, w) in enumerate(zip(batch, want)):
                if not np.array_equal(read_wav(a[1])[0], w / 32768.0):
                    raise AssertionError(f"server: {a[1]} differs from "
                                         "render_phrase of its batch")
                # the budget's seed-to-seed term: the CLI's own render at
                # another seed, since a bucketed row normalizes the sh/sr
                # jitter noise over its padded length (another realization)
                other = tmp / "single_cli_seed1.wav"
                GooferResampler(a[0], other, *a[2:], seed=(1, k))
                GooferResampler(a[0], alone, *a[2:], seed=(0, k))
                floor = lsd_db(_pcm_float(other), _pcm_float(alone), SR)
                err = _hold(f"server {Path(a[1]).name} vs the CLI render",
                            _pcm_float(a[1]), _pcm_float(alone), False,
                            floor)
                worst = tuple(max(x, y) for x, y in zip(worst, err))
                worst_floor = max(worst_floor, floor)

        try:
            _post(url, "no wav paths here")
            raise AssertionError("server: a malformed body was answered 200")
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.code != 500 or not body.startswith(
                    b"An error occurred.\n") or b"Traceback" not in body:
                raise AssertionError(f"server: a malformed body got {e.code} "
                                     f"{body[:80]!r}")
    finally:
        del batcher._render
        httpd.shutdown()
        httpd.server_close()
    audio_s = sum((60 + 250 + 20 * j) / 1000.0 for j in range(SERVER_BURST))
    out = {
        "warmup_s": warmup_s,
        "single_post_ms": statistics.median(single_ms),
        "burst_notes": SERVER_BURST, "burst_audio_s": audio_s,
        "burst_wall_ms": walls,
        "burst_wall_ms_median": statistics.median(walls),
        "dispatches_per_burst": per_burst, "batch_sizes": sizes,
        "x_realtime": audio_s * 1e3 / statistics.median(walls),
        "fallback_count": batcher.fallback_count - fallbacks,
        "vs_cli_max_diff_over_peak": worst[0], "vs_cli_lsd_db": worst[1],
        "cli_seed_to_seed_lsd_db": worst_floor,
        "launches": launches,
    }
    print(f"server: warm single POST {out['single_post_ms']:.3f} ms "
          f"(median of 7), burst of {SERVER_BURST} POSTs "
          f"{out['burst_wall_ms_median']:.3f} ms from the first send to the "
          f"last reply (median of {SERVER_BURST_REPS}: "
          f"{', '.join(f'{w:.3f}' for w in walls)}), {per_burst:.1f} "
          f"dispatches per burst {sizes}, {out['x_realtime']:.1f} x "
          f"realtime, fallbacks 0; launches over the bursts: pulse "
          f"{launches[0]} cascade {launches[1]}; burst WAVs equal "
          f"render_phrase at int16; vs the CLI's render at the row's key "
          f"(noise on) max|diff|/peak {worst[0]:.3e}, LSD {worst[1]:.4f} "
          f"dB (the CLI's seed-to-seed LSD up to {worst_floor:.4f} dB); "
          f"warm-up {warmup_s:.2f} s")
    return out


def facade_slice() -> dict:
    """Drive the facade on the card: models/hnm.synthesize on the voice
    source's features with FACADE_OPTIONS (the kernels' launch counters
    set to 0 just before and read just after one call), held to the
    port's CPU render of the same call (harmonic stem as PERF.md section
    2's noise-zeroed budget, the noisy stems within max(1 dB, CPU
    seed-to-seed + 0.5 dB)); then compat.f0_estimate and
    extract_formants on the voice recording, card vs CPU.  Returns the
    numbers, with the launches under "launches"."""
    pack, f0, mask, forms = facade_inputs()

    def call(device, seed=0):
        os.environ[config.DEVICE_ENV] = device
        return hnm.synthesize(pack, f0, mask, None, SR, formants=forms,
                              seed=seed, **FACADE_OPTIONS)

    call("cuda")
    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    card = call("cuda")
    launches = _launches()
    if launches != (FACADE_PULSE_LAUNCHES, FACADE_CASCADE_LAUNCHES):
        raise AssertionError(f"facade: {launches} pulse and cascade "
                             f"launches per call, expected "
                             f"{FACADE_PULSE_LAUNCHES} and "
                             f"{FACADE_CASCADE_LAUNCHES}")
    warm_ms = _median_ms(lambda: call("cuda"), 7)
    cpu, cpu1 = call("cpu"), call("cpu", seed=1)
    harm = _hold("facade harmonic stem card vs CPU", card[1], cpu[1], True)
    stems = {}
    for i, name in enumerate(("mix", "harmonic", "uv", "breath")):
        floor = lsd_db(cpu1[i], cpu[i], SR)
        stems[name] = (_hold(f"facade {name} card vs CPU", card[i], cpu[i],
                             False, floor)[1], floor)

    y = recording("tests/golden/voice/src.wav")
    os.environ[config.DEVICE_ENV] = "cuda"
    before = _analysis_launches()
    f0_card = compat.f0_estimate(y, SR, HOP / SR)
    forms_card = compat.extract_formants(y, SR, HOP)
    a_launches = tuple(b - a for a, b in zip(before, _analysis_launches()))
    os.environ[config.DEVICE_ENV] = "cpu"
    f0_cpu = compat.f0_estimate(y, SR, HOP / SR)
    forms_cpu = compat.extract_formants(y, SR, HOP)
    os.environ[config.DEVICE_ENV] = "cuda"
    if min(a_launches) <= 0:
        raise AssertionError(f"facade: the analysis launched the Viterbi, "
                             f"root and Burg kernels {a_launches} times")
    f0_share = float((np.abs(f0_card - f0_cpu)
                      <= 1e-3 * np.maximum(f0_cpu, 1.0)).mean())
    _formants_close("facade extract_formants card vs CPU", forms_card,
                    forms_cpu)
    if f0_card.shape != f0_cpu.shape or f0_share < 0.98:
        raise AssertionError(f"facade f0_estimate card vs CPU: "
                             f"{f0_share:.4f} of frames within 1e-3")
    out = {
        "call_ms": warm_ms, "audio_s": len(f0) / SR,
        "harmonic_max_diff_over_peak": harm[0], "harmonic_lsd_db": harm[1],
        "stem_lsd_db": {k: v[0] for k, v in stems.items()},
        "cpu_seed_to_seed_lsd_db": {k: v[1] for k, v in stems.items()},
        "f0_frames_within_1e-3": f0_share,
        "launches": launches, "analysis_launches": a_launches,
    }
    print(f"facade: models.hnm.synthesize with {sorted(FACADE_OPTIONS)} on "
          f"{out['audio_s']:.2f} s: warm {warm_ms:.3f} ms per call (median "
          f"of 7), launches per call: pulse {launches[0]} cascade "
          f"{launches[1]}; card vs CPU harmonic max|diff|/peak "
          f"{harm[0]:.3e} LSD {harm[1]:.4f} dB, noisy stems LSD "
          + ", ".join(f"{k} {v[0]:.3f} (seed-to-seed {v[1]:.3f})"
                      for k, v in stems.items())
          + f" dB; compat f0_estimate / extract_formants launches Viterbi "
          f"{a_launches[0]} roots {a_launches[1]} Burg {a_launches[2]}, f0 "
          f"within 1e-3 on {f0_share:.4f} of frames")
    return out


def preview_inputs(dev: str):
    """The voice source's first EDITOR_SPAN_S seconds as the editor's Play
    hands them to the preview: the envelope decoded on ``dev`` and
    sliced, with f0, mask and formants, at the default hop."""
    pack, f0, mask, forms, _, _ = load_features(
        REPO / "tests" / "golden" / "voice" / "src_features.goofy")
    knots = torch.as_tensor(np.asarray(pack["knot_vals_log"], np.float32),
                            device=dev)
    env = envelope.decode_env_from_knots(knots, pack["sr"], pack["n_fft"],
                                         pack["n_bins"]).cpu().numpy()
    b = int(EDITOR_SPAN_S * SR)
    frames = slice(0, max(1, -(-b // HOP)))
    forms = {k: np.asarray(v)[frames]
             for k, v in formants_to_int_keys(forms).items()}
    return env[:, frames], np.asarray(f0[:b]), np.asarray(mask[:b]), forms


def _scripted_hook(calls):
    """An SE1 editor hook that paints the snippet's first half unvoiced."""
    def hook(y_snip, sr, init_mask):
        calls.append((len(y_snip), sr, len(init_mask)))
        edited = np.asarray(init_mask, np.float32).copy()
        edited[: len(edited) // 2] = 0.0
        return edited
    return hook


def se1_round_trip(tmp: Path, dev: str) -> dict:
    """SE1 through cli.main on the card: the heavy note with SE1 on a copy
    of the voice source, gui.available_interactive_hook replaced by a
    scripted hook.  The hook runs once, the .goofy's mask changes in the
    snippet's first half and nowhere else, the source's cached renders go,
    and the output equals at int16 the plain render of the edited .goofy
    at the same seed."""
    bank, cache, plain = tmp / "se_bank", tmp / "se_cache", tmp / "se_plain"
    for d in (bank, cache, plain):
        d.mkdir()
    voice = REPO / "tests" / "golden" / "voice"
    shutil.copy(voice / "src.wav", bank / "v.wav")
    shutil.copy(voice / "src_features.goofy", bank / "v_features.goofy")
    for name in ("v_1.wav", "v_2.wav", "other.wav"):
        (cache / name).write_bytes(b"stale")
    feat = bank / "v_features.goofy"
    before = np.asarray(load_features(feat)[2])
    _, *args = HEAVY
    args = [str(a) for a in args]
    args[2] = "SE1" + args[2]
    calls = []
    real = gui.available_interactive_hook
    gui.available_interactive_hook = lambda: _scripted_hook(calls)
    os.environ[config.DEVICE_ENV] = dev
    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    try:
        rc = cli.main([str(bank / "v.wav"), str(cache / "out.wav")] + args)
    finally:
        gui.available_interactive_hook = real
    launches = _launches()
    if rc != 0 or len(calls) != 1:
        raise AssertionError(f"SE1: cli rc {rc}, the hook ran {len(calls)} "
                             "times")
    n_snip, sr, n_mask = calls[0]
    mask = np.asarray(load_features(feat)[2])
    changed = np.flatnonzero(mask != before)
    start = int(HEAVY[4] / 1000 * SR)        # the cut's first sample
    if (not changed.size or np.any(mask[changed] != 0.0)
            or changed.min() < start or changed.max() >= start + n_mask // 2
            or sr != SR or n_snip != n_mask):
        raise AssertionError(f"SE1: the mask changed at samples "
                             f"{changed.min() if changed.size else None}-"
                             f"{changed.max() if changed.size else None}, "
                             f"expected inside [{start}, "
                             f"{start + n_mask // 2})")
    left = sorted(p.name for p in cache.iterdir())
    if left != ["other.wav", "out.wav"]:
        raise AssertionError(f"SE1: the cache holds {left} after the edit")
    shutil.copy(feat, plain / "v_features.goofy")
    GooferResampler(plain / "v.wav", plain / "want.wav", *args, seed=0,
                    device=dev)
    got = read_pcm(cache / "out.wav")
    want = read_pcm(plain / "want.wav")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("SE1: the render differs from the plain render "
                             "of the edited .goofy")
    return {"snippet_samples": n_snip, "painted_unvoiced": int(changed.size),
            "pulse_launches": launches[0], "cascade_launches": launches[1]}


def edit_goofy_on_card(tmp: Path, dev: str) -> dict:
    """gui.edit_goofy_files on a knot-mode .goofy with no audio beside it
    on the card, tkinter replaced by tests/fake_tk.py with a scripted
    paint and Apply: the envelope decodes on the card, the window shows
    the preview synthesis (a pulse launch) and the edit is written."""
    from tests import fake_tk

    d = tmp / "goofy_edit"
    d.mkdir()
    feat = d / "v_features.goofy"
    shutil.copy(REPO / "tests" / "golden" / "voice" / "src_features.goofy",
                feat)
    n = int(load_features(feat)[5])

    def scenario(win):
        canvas = fake_tk.find_all(win, fake_tk.Canvas)[0]
        canvas.fire("<Button-3>", x=0)
        canvas.fire("<B3-Motion>", x=399)
        canvas.fire("<ButtonRelease-3>")
        fake_tk.find_button(win, "Apply").invoke()

    saved = {m: sys.modules.get(m) for m in ("tkinter", "tkinter.ttk")}
    fake_tk.reset()
    sys.modules["tkinter"] = fake_tk
    sys.modules["tkinter.ttk"] = fake_tk.ttk
    fake_tk.push_scenario(scenario)
    pulse_kernel.pulse_accumulate.launches = 0
    try:
        gui.edit_goofy_files([str(feat)], device=dev)
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    launches = pulse_kernel.pulse_accumulate.launches
    _, f0, mask, _, _, ylen = load_features(feat)
    b = int(399 / 800 * n) + 1
    if (ylen != n or launches < 1 or np.any(np.asarray(mask[:b]) != 0)
            or np.any(np.asarray(f0[:b]) != 0)
            or fake_tk.SCENARIOS):
        raise AssertionError(f"edit_goofy_files: {launches} pulse launches, "
                             f"mask[:{b}] not all unvoiced or the scenario "
                             "did not run")
    return {"pulse_launches": launches, "painted_unvoiced": b}


def editor_slice(tmp: Path, dev: str = "cuda") -> dict:
    """Drive the editor on the card (``dev``): Play's preview synthesis of
    a 2 s span of the voice source (launches per preview, warm ms, card vs
    CPU), SE1 through the CLI and the .goofy batch mode.  Returns the
    numbers, with the path's launches under "launches"."""
    env, f0, mask, forms = preview_inputs(dev)

    def preview(device):
        return gui._preview_synthesis(env, f0, mask, forms, SR, N_FFT, HOP,
                                      device=device)

    preview(dev)
    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    card = preview(dev)
    launches = _launches()
    if launches[0] < 1:
        raise AssertionError("editor preview: no pulse launch")
    warm_ms = _median_ms(lambda: preview(dev), 7)
    cpu = preview("cpu")
    if card.shape != (len(mask),) or not np.isfinite(card).all():
        raise AssertionError(f"editor preview: shape {card.shape} or "
                             "non-finite")
    lsd = lsd_db(card, cpu, SR)
    if not lsd <= PREVIEW_LSD_DB:
        raise AssertionError(f"editor preview card vs CPU: LSD {lsd} dB over "
                             f"{PREVIEW_LSD_DB}")
    se1 = se1_round_trip(tmp, dev)
    edit = edit_goofy_on_card(tmp, dev)
    out = {"preview_ms": warm_ms, "audio_s": len(mask) / SR,
           "preview_lsd_card_vs_cpu_db": lsd,
           "preview_max_diff": float(np.abs(card - cpu).max()),
           "launches_per_preview": {"pulse": launches[0],
                                    "cascade": launches[1]},
           "se1": se1, "edit_goofy_files": edit,
           "launches": (launches[0] + se1["pulse_launches"]
                        + edit["pulse_launches"],
                        launches[1] + se1["cascade_launches"])}
    print(f"editor: preview of {out['audio_s']:.2f} s warm {warm_ms:.3f} ms "
          f"(median of 7), launches per preview: pulse {launches[0]} "
          f"cascade {launches[1]}; card vs CPU LSD {lsd:.4f} dB, max|diff| "
          f"{out['preview_max_diff']:.3e}; SE1 through the CLI: the hook "
          f"ran once on {se1['snippet_samples']} samples, "
          f"{se1['painted_unvoiced']} samples painted unvoiced, stale "
          f"renders deleted, output equal at int16 to the edited .goofy's "
          f"render (pulse {se1['pulse_launches']} cascade "
          f"{se1['cascade_launches']} launches); edit_goofy_files on the "
          f"knot-mode .goofy: decoded and previewed on the card (pulse "
          f"{edit['pulse_launches']}), edit written")
    return out


def write_aiff16(path: Path, pcm: np.ndarray, sr: int) -> None:
    """Mono 16-bit AIFF: FORM, COMM with the rate as an 80-bit extended
    float, SSND of big-endian samples."""
    import struct

    e = int(sr).bit_length() - 1
    rate = struct.pack(">HQ", 16383 + e, int(sr) << (63 - e))
    comm = struct.pack(">hIh", 1, len(pcm), 16) + rate
    ssnd = struct.pack(">II", 0, 0) + pcm.astype(">i2").tobytes()
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    path.write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)


def read_pcm(path: Path) -> np.ndarray:
    from scipy.io import wavfile

    return wavfile.read(path)[1]


def codec_slice(tmp: Path, dev: str = "cuda") -> dict:
    """Drive the native codecs on the card's host: the voice source as
    16-bit FLAC and AIFF (and MP3 where libmpg123 and libmp3lame load),
    the heavy note rendered from each in a directory without a cache (the
    first render decodes, extracts and saves) held at int16 to the render
    from the WAV, a folder of wav + flac + aiff copies extracted through
    cli.main (three .goofy files with equal features, one launch of each
    analysis kernel per chunk) and each format's host decode ms.  Returns
    the numbers, with the renders' and extraction's launches under
    "launches" and "analysis_launches"."""
    import ctypes

    from scipy.io import wavfile

    from tests.flac_writer import write_flac

    sr, pcm = wavfile.read(REPO / "tests" / "golden" / "voice" / "src.wav")
    writers = {
        "wav": lambda p: shutil.copy(REPO / "tests" / "golden" / "voice"
                                     / "src.wav", p),
        "flac": lambda p: write_flac(p, pcm.astype(np.int64), sr, bps=16,
                                     blocksize=4096, mode="fixed", order=2),
        "aiff": lambda p: write_aiff16(p, pcm, sr),
    }
    mp3 = "skipped: "
    try:
        ctypes.CDLL("libmpg123.so.0")
        from tests.mp3_writer import write_mp3

        ctypes.CDLL("libmp3lame.so.0")
        writers["mp3"] = lambda p: write_mp3(p, pcm / 32768.0, sr)
        mp3 = "ran: libmpg123.so.0 and libmp3lame.so.0 loaded"
    except OSError as e:
        mp3 += str(e)
    os.environ[config.DEVICE_ENV] = dev
    _, *args = HEAVY
    args = [str(a) for a in args]
    decode_ms, renders = {}, {}
    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    for k in (viterbi_kernel.pitch_viterbi, lpc_roots_kernel.lpc_roots,
              burg_kernel.burg_lpc):
        k.launches = 0
    for fmt, write in writers.items():
        d = tmp / f"codec_{fmt}"
        d.mkdir()
        src = d / f"v.{fmt}"
        write(src)
        y, _ = read_wav_mono(src)
        if fmt != "mp3" and not np.array_equal(y, pcm / 32768.0):
            raise AssertionError(f"codec: the {fmt} source decodes to other "
                                 "samples than the WAV")
        decode_ms[fmt] = statistics.median(
            host_ms(lambda: read_wav_mono(src)) for _ in range(5))
        if cli.main([str(src), str(d / "out.wav")] + args) != 0:
            raise AssertionError(f"codec: the render from {fmt} failed")
        renders[fmt] = read_pcm(d / "out.wav")
    launches = _launches()
    r_launches = _analysis_launches()
    if min(r_launches) < len(renders):
        raise AssertionError(f"codec: {len(renders)} fresh sources launched "
                             f"the analysis kernels {r_launches} times")
    for fmt in ("flac", "aiff"):
        if not np.array_equal(renders[fmt], renders["wav"]):
            raise AssertionError(f"codec: the heavy note from {fmt} differs "
                                 "from the note from the WAV at int16")
    if "mp3" in renders and not (np.isfinite(renders["mp3"]).all()
                                 and np.abs(renders["mp3"]).max() > 1000):
        raise AssertionError("codec: the heavy note from mp3 is silent")

    folder = tmp / "codec_folder"
    folder.mkdir()
    for fmt in ("wav", "flac", "aiff"):
        writers[fmt](folder / f"v_{fmt}.{fmt}")
    for k in (viterbi_kernel.pitch_viterbi, lpc_roots_kernel.lpc_roots,
              burg_kernel.burg_lpc):
        k.launches = 0
    if cli.main([str(folder)]) != 0:
        raise AssertionError("codec: the folder extraction failed")
    a_launches = _analysis_launches()
    made = sorted(folder.glob("*_features.goofy"))
    if len(made) != 3 or list(a_launches) != [1, 1, 1]:
        raise AssertionError(f"codec folder: {len(made)} .goofy files, "
                             f"launches {a_launches}; expected 3 files in "
                             "one chunk")
    feats = [load_features(p) for p in made]
    exact = True
    for p, f in zip(made[1:], feats[1:]):
        name = f"codec folder {p.name} vs {made[0].name}"
        for i, track in ((1, "f0"), (2, "mask")):
            _f16_track_equal(f"{name} ({track})", f[i], feats[0][i])
            exact &= bool(np.array_equal(f[i], feats[0][i]))
        k_a, k_b = f[0]["knot_vals_log"], feats[0][0]["knot_vals_log"]
        if k_a.shape != k_b.shape or knot_steps(k_a, k_b) > 1.001:
            raise AssertionError(f"{name}: knots differ")
        exact &= bool(np.array_equal(k_a, k_b))
        _formants_close(name, f[3], feats[0][3])
    out = {"decode_host_ms": decode_ms, "mp3": mp3,
           "render_samples": int(len(renders["wav"])),
           "folder_features_bit_equal": exact,
           "render_analysis_launches": r_launches,
           "launches": launches,
           "analysis_launches": tuple(a + b for a, b in zip(a_launches,
                                                            r_launches))}
    print(f"codec: host decode ms (median of 5) "
          + ", ".join(f"{k} {v:.3f}" for k, v in decode_ms.items())
          + f"; heavy note from flac and aiff equal at int16 to the note "
          f"from the WAV ({len(renders['wav'])} samples; launches over "
          f"{len(renders)} renders: pulse {launches[0]} cascade "
          f"{launches[1]}); folder wav + flac + aiff: 3 .goofy, launches "
          f"Viterbi {a_launches[0]} roots {a_launches[1]} Burg "
          f"{a_launches[2]}, features bit-equal {exact}; mp3 {mp3}")
    return out


def _all_launches():
    """The five kernels' counters: pulse, cascade, Viterbi, roots, Burg."""
    return _launches() + _analysis_launches()


def _zero_launches():
    for k in (pulse_kernel.pulse_accumulate, cascade_kernel.one_pole_cascade,
              viterbi_kernel.pitch_viterbi, lpc_roots_kernel.lpc_roots,
              burg_kernel.burg_lpc):
        k.launches = 0


def parallel_meshes(dev: str) -> dict:
    """V: dp 2 x tp 2, four slots that all name the first card (``dev``);
    M1: every visible card, tp 1; M2: dp x tp over the real cards where
    the machine shows two or more.  A mesh that cannot be built is printed
    with the reason."""
    first = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    meshes = {"V": make_mesh(4, tp=2, devices=[first] * 4)}
    try:
        meshes["M1"] = make_mesh()
        print(f"parallel: mesh M1 over {meshes['M1'].size} visible "
              f"card(s): {[str(d) for d in meshes['M1'].slots]}")
    except RuntimeError as e:
        print(f"parallel: mesh M1 not built: {e}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= 2:
        meshes["M2"] = make_mesh(cards, tp=2 if cards % 2 == 0 else 1)
        print(f"parallel: mesh M2 {meshes['M2'].shape} over {cards} cards")
    else:
        print(f"parallel: mesh M2 not built: the machine shows {cards} "
              "card(s), M2 needs two or more")
    return meshes


def phrase_launch_plan(notes, slots: int, dev) -> list:
    """What render_phrase(mesh=) of ``slots`` slots launches: each group's
    non-empty shards times what one note of the group launches alone."""
    planned, _ = phrase.plan_phrase(notes, device=dev)
    want = [0, 0]
    for (rs, _), members in phrase.group_planned(planned).items():
        m = members[0]
        before = _launches()
        render_note(rs, m.arrays, m.scalars, 0, dev)
        shards = min(len(members), slots)
        want = [w + shards * (b - a)
                for w, a, b in zip(want, before, _launches())]
    return want


def production_knots(src: str, dev, k: int, b: int = 4, n: int = 32768):
    """``b`` cuts of the voice source at the production frames (1024/256):
    knots (B, K, T) read from its decoded log-envelope at the K knot bins,
    f0 and mask (B, n), formant tracks (B, 4, T); host arrays."""
    env, f0i, vmask, forms, _, _ = acquire_features(Path(src), N_FFT, HOP,
                                                    dev)
    t = 1 + n // HOP
    log_env = np.log(np.maximum(env, 1e-8))[
        envelope._knot_bin_idx(SR, N_FFT, k, N_FFT // 2 + 1)]
    offs = [i * HOP * ((env.shape[1] - t) // (b - 1)) for i in range(b)]
    tracks = np.stack([np.asarray(forms[j], np.float32) for j in (1, 2, 3, 4)])
    return (np.stack([log_env[:, o // HOP:o // HOP + t] for o in offs]),
            np.stack([f0i[o:o + n] for o in offs]).astype(np.float32),
            np.stack([vmask[o:o + n] for o in offs]).astype(np.float32),
            np.stack([tracks[:, o // HOP:o // HOP + t] for o in offs]))


def check_batch_sharded(mesh, src: str, dev) -> dict:
    """render_batch_sharded on ``mesh`` at the production frames: the
    tp-reduced log-envelope bit-equal to decode_log_env_from_knots, K 64
    and 63; the stems held to render_batch on one device, which draws
    from the same (seed, row) keys, by the noise-zeroed budget with the
    noise zeroed and on; a B that dp does not divide raises."""
    st = synth.SynthStatic(sr=SR, n_fft=N_FFT, hop=HOP, n=32768)
    worst = {}
    for k in (64, 63):
        knots, f0, mask, tracks = production_knots(src, dev, k)
        logs = par_batch.tp_log_env(mesh, knots, SR, N_FFT, N_FFT // 2 + 1)
        want = envelope.decode_log_env_from_knots(
            torch.as_tensor(knots, device=dev), SR, N_FFT, N_FFT // 2 + 1)
        if not torch.equal(torch.cat([g.to(want.device) for g in logs]),
                           want):
            raise AssertionError(f"render_batch_sharded K={k}: the tp-"
                                 "reduced log-envelope is not bit-equal")
        nb = par_batch.NoteBatch(torch.exp(want), *(
            torch.as_tensor(a, device=dev) for a in (f0, mask, tracks)),
            np.full(len(f0), f0.shape[1]))
        for quiet in (True, False):
            knobs = ({"uv_strength": 0.0, "breath_strength": 0.0} if quiet
                     else None)
            got = par_batch.render_batch_sharded(mesh, st, knots, f0, mask,
                                                 tracks, knobs=knobs)[0]
            ref = par_batch.render_batch(st, nb, knobs=knobs)[0]
            # the same (seed, row) keys: the noise-zeroed budget either way
            errs = [_hold(f"render_batch_sharded K={k} row {i}",
                          got[i].cpu().numpy(), ref[i].cpu().numpy(), True)
                    for i in range(len(f0))]
            worst[(k, quiet)] = [max(e[j] for e in errs) for j in (0, 1)]
    try:
        par_batch.render_batch_sharded(mesh, st, knots[:3], f0[:3], mask[:3],
                                       tracks[:3])
    except ValueError as e:
        if "not divisible by the dp" not in str(e):
            raise
    else:
        raise AssertionError("render_batch_sharded: B=3 on dp 2 did not "
                             "raise")
    print(f"parallel: render_batch_sharded on V, B=4 x 32768 samples, "
          f"K 64 and 63: log-envelope bit-equal to decode_log_env_from_knots;"
          f" stems vs render_batch on one device, noise zeroed max|diff|/peak "
          f"{max(worst[(k, True)][0] for k in (64, 63)):.3e} LSD "
          f"{max(worst[(k, True)][1] for k in (64, 63)):.4f} dB, noise on "
          f"max|diff|/peak {max(worst[(k, False)][0] for k in (64, 63)):.3e}"
          f" LSD {max(worst[(k, False)][1] for k in (64, 63)):.4f} dB; B=3 "
          "raises")
    return {"log_env_bit_equal": True,
            "quiet_max_rel": max(worst[(k, True)][0] for k in (64, 63)),
            "quiet_lsd_db": max(worst[(k, True)][1] for k in (64, 63)),
            "noisy_max_rel": max(worst[(k, False)][0] for k in (64, 63)),
            "noisy_lsd_db": max(worst[(k, False)][1] for k in (64, 63))}


def check_sharded_folder(one: Path, sharded: Path, files: int) -> None:
    """Each .goofy the sharded folder run wrote against the single-device
    run's, within the folder-row budget."""
    for i in range(files):
        name = f"folder v{i:02d} on V vs one device"
        a = load_features(sharded / f"v{i:02d}_features.goofy")
        b = load_features(one / f"v{i:02d}_features.goofy")
        _f16_track_equal(name + " (f0)", a[1], b[1])
        _f16_track_equal(name + " (mask)", a[2], b[2])
        k_a, k_b = a[0]["knot_vals_log"], b[0]["knot_vals_log"]
        if a[5] != b[5] or k_a.shape != k_b.shape or knot_steps(
                k_a, k_b) > 1.001:
            raise AssertionError(f"{name}: K {k_a.shape} vs {k_b.shape}, "
                                 f"length {a[5]} vs {b[5]} or knots differ")
        _formants_close(name, a[3], b[3])


def parallel_slice(tmp: Path, dev: str = "cuda", notes: int | None = None,
                   files: int = BANK_FILES, reps: int = 7,
                   mesh_reps: int = 3) -> dict:
    """Drive the mesh path (goofer_tpu_torch/parallel) on ``dev``: phrases
    (b) and (a) through render_phrase(mesh=) on every mesh, render_batch_
    sharded and the 64-file folder through extract_features_recursive
    (mesh=V), and dryrun_multichip on V (and on the real cards where there
    are two or more), the five counters set to 0 just before and read just
    after; then the checks and the numbers.  ``notes``, ``files``,
    ``reps`` and ``mesh_reps`` (the timed runs on one device and on a
    mesh) cut the phrases, the folder and the timing for a rehearsal on
    the CPU.  Returns the numbers, with the path's launches under
    "launches"."""
    t0 = time.perf_counter()
    src = str(tmp / "voice.wav")
    first = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    meshes = parallel_meshes(dev)
    sung = phrase_notes(src)
    phrases = {k: sung[k][:notes] for k in ("b", "a")}
    cuts = voicebank_cuts()[:files]
    folders = {name: tmp / f"par_{name}" for name in ("one", "V")}
    for d in folders.values():
        d.mkdir()
        for i, y in enumerate(cuts):
            write_wav(d / f"v{i:02d}.wav", y, SR)
    batch_extract.extract_features_recursive(folders["one"], device=first)
    # the single-device phrases, for the comparison
    single = {name: phrase.render_phrase(ns, device=first)
              for name, ns in phrases.items()}

    _zero_launches()
    outs, pcm, launched = {}, {}, {}
    for mname, mesh in meshes.items():
        for pname, ns in phrases.items():
            before = _all_launches()
            pcm[mname, pname] = phrase.render_phrase(ns, pcm16=True,
                                                     mesh=mesh)
            launched[mname, pname] = [
                b - a for a, b in zip(before, _all_launches())][:2]
    before = _all_launches()
    batch_extract.extract_features_recursive(folders["V"], mesh=meshes["V"])
    folder_launches = [b - a for a, b in zip(before, _all_launches())][2:]
    dryrun.dryrun_multichip(4, devices=[first] * 4)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= 2:
        dryrun.dryrun_multichip(cards)
        print(f"parallel: dryrun_multichip({cards}) over the real cards "
              "passed")
    else:
        print(f"parallel: dryrun_multichip over real cards not run: the "
              f"machine shows {cards} card(s)")
    out = {"launches": _all_launches()}
    print(f"parallel: dryrun_multichip(4) on V (four slots of {first}) "
          "passed")
    batch_info = check_batch_sharded(meshes["V"], src, first)

    # launches and outputs
    for (mname, pname), got in launched.items():
        want = phrase_launch_plan(phrases[pname], meshes[mname].size, first)
        if got != want:
            raise AssertionError(
                f"parallel: phrase {pname} on {mname} launched pulse "
                f"{got[0]} and cascade {got[1]} times, expected {want}: "
                "each shard once per pass")
    diffs = {}
    for mname in meshes:
        for pname, ns in phrases.items():
            floats = phrase.render_phrase(ns, mesh=meshes[mname])
            errs = []
            for i, (q, y, ref) in enumerate(zip(pcm[mname, pname], floats,
                                                single[pname])):
                if q.dtype != np.int16 or q.shape != ref.shape:
                    raise AssertionError(
                        f"parallel: phrase {pname} on {mname} note {i}: "
                        f"pcm16 gave {q.dtype} {q.shape}")
                # a note keeps its key (seed, index) on any shard
                errs.append(_hold(f"parallel: phrase {pname} on {mname} "
                                  f"note {i}", y, ref, True))
            diffs[mname, pname] = [max(e[j] for e in errs) for j in (0, 1)]
    plan = list(features.chunk_plan([len(y) for y in cuts], HOP,
                                    features.EXTRACT_CHUNK_FILES,
                                    features.EXTRACT_CHUNK_FRAMES))
    want = sum(min(len(part), meshes["V"].size) for _, part in plan)
    if folder_launches != [want] * 3:
        raise AssertionError(f"parallel: folder on V launched Viterbi, roots "
                             f"and Burg {folder_launches} times, expected "
                             f"{want} each: one per non-empty shard")
    check_sharded_folder(folders["one"], folders["V"], len(cuts))
    print(f"parallel: folder of {len(cuts)} files on V: {len(plan)} chunks, "
          f"launches Viterbi {folder_launches[0]} roots "
          f"{folder_launches[1]} Burg {folder_launches[2]} (one per "
          "non-empty shard); every .goofy within the folder-row budget of "
          "the single-device run")

    # the numbers
    def run(ns, mesh=None):
        if mesh is None:
            return lambda: phrase.render_phrase(ns, pcm16=True, device=first)
        return lambda: phrase.render_phrase(ns, pcm16=True, mesh=mesh)

    for pname, ns in phrases.items():
        audio_s = _audio_s(ns)
        ms = {"single": _median_ms(run(ns), reps)}
        for mname, mesh in meshes.items():
            ms[mname] = _median_ms(run(ns, mesh), mesh_reps)
        out[pname] = {
            "notes": len(ns), "audio_s": audio_s, "wall_ms": ms,
            "x_realtime": {k: audio_s * 1e3 / v for k, v in ms.items()},
            "launches": {m: launched[m, pname] for m in meshes},
            "max_rel_diff": {m: diffs[m, pname][0] for m in meshes},
            "lsd_db": {m: diffs[m, pname][1] for m in meshes}}
        print(f"parallel: phrase {pname}, {len(ns)} notes, {audio_s:.2f} s: "
              f"warm wall ms (median of {reps} after 2 on one device, of "
              f"{mesh_reps} after 2 on a mesh) " + ", ".join(
                  f"{k} {v:.3f} ({audio_s * 1e3 / v:.1f} x realtime)"
                  for k, v in ms.items())
              + "; launches " + ", ".join(
                  f"{m} {launched[m, pname]}" for m in meshes)
              + "; vs one device, noise on, noise-zeroed budget: "
              + ", ".join(
                  f"{m} max|diff|/peak {diffs[m, pname][0]:.3e} LSD "
                  f"{diffs[m, pname][1]:.4f} dB" for m in meshes))
    if dev == "cuda":
        profile_reps = 3
        with device_profile() as prof:
            t0 = time.perf_counter()
            for _ in range(profile_reps):
                phrase.render_phrase(phrases["b"], pcm16=True,
                                     mesh=meshes["V"])
            _sync_cards()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_us, kernels = device_busy(prof)
        if busy_us <= 0.0:
            raise AssertionError("parallel: no device activity for phrase "
                                 "b on V")
        out["b"]["V_device_busy_ms"] = busy_us / 1e3 / profile_reps
        out["b"]["V_idle_share"] = 1.0 - busy_us / 1e3 / wall_ms
        out["b"]["V_device_kernels"] = len(kernels) / profile_reps
    else:
        out["b"].update(V_device_busy_ms=None, V_idle_share=None,
                        V_device_kernels=None)
    decoded = [read_wav_mono(p)[0]
               for p in sorted(folders["V"].glob("v*.wav"))]

    def folder():
        for p in folders["V"].glob("*_features.goofy"):
            p.unlink()
        batch_extract.extract_features_recursive(folders["V"],
                                                 mesh=meshes["V"])

    out["folder"] = {
        "files": len(cuts), "chunks": len(plan),
        "launches_per_kernel": want,
        "analysis_ms": {
            "single": _median_ms(lambda: features.extract_features_batch(
                decoded, SR, N_FFT, HOP, dense=False, device=first), 5),
            "V": _median_ms(lambda: features.extract_features_batch(
                decoded, SR, N_FFT, HOP, dense=False, mesh=meshes["V"]),
                mesh_reps)},
        # once: the checked run above was its warm-up
        "folder_ms_V": _median_ms(folder, 1, warm=0)}
    out["render_batch_sharded"] = batch_info
    out["meshes"] = {m: {"shape": mesh.shape,
                         "devices": [str(d) for d in mesh.slots]}
                     for m, mesh in meshes.items()}
    f = out["folder"]
    print(f"parallel: phrase b on V profiled: device busy "
          f"{out['b']['V_device_busy_ms']} ms per phrase, idle share "
          f"{out['b']['V_idle_share']}, device kernels "
          f"{out['b']['V_device_kernels']}; folder analysis alone "
          f"(median of 5, V of {mesh_reps}) single "
          f"{f['analysis_ms']['single']:.3f} ms, V "
          f"{f['analysis_ms']['V']:.3f} ms; folder through "
          f"extract_features_recursive on V, once after the checked run, "
          f"{f['folder_ms_V']:.3f} ms")
    out["seconds"] = time.perf_counter() - t0
    print(f"parallel: the phase took {out['seconds']:.2f} s")
    return out


SELFTEST = REPO / "examples" / "engine_selftest_torch.py"
LAUNCHER = REPO / "launchers" / "goofer-sampler-torch.sh"
# a plain note (no flag) for the installed layout: the pulse and blur
# kernels and the WAV codec
PLAIN_NOTE = ("C4", 100, "", 0, 500, 60, 0, 100, 0, "!120", "AA")
# libraries the plain note builds: its two kernels and the WAV codec
PLAIN_NOTE_LIBS = ("pulse_accumulate", "gaussian_blur", "wavcodec")


def package_files() -> list[Path]:
    """The port's files as pyproject.toml ships them, relative to the
    repository: every module of goofer_tpu_torch's packages and the files
    its package data selects."""
    import tomllib

    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "goofer_tpu_torch"]
    pkg = REPO / "goofer_tpu_torch"
    files = set(pkg.rglob("*.py"))
    for pattern in globs:
        files.update(pkg.glob(pattern))
    return sorted(p.relative_to(REPO) for p in files)


def set_writable(root: Path, writable: bool) -> None:
    """Add or take away every write permission under ``root``."""
    for p in [root, *root.rglob("*")]:
        mode = p.stat().st_mode
        p.chmod(mode | 0o200 if writable else mode & ~0o222)


def installed_copy(dest: Path) -> list[Path]:
    """package_files() copied under ``dest``, made read-only: the layout of
    an installed port, with no setuptools or pip involved.  Returns the
    files of the copy."""
    for rel in package_files():
        (dest / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(REPO / rel, dest / rel)
    set_writable(dest, False)
    return sorted(dest.rglob("*"))


def installed_env(copy: Path, cache: Path, device: str) -> dict:
    """The environment of a process that imports the installed copy alone
    and keeps its builds under ``cache``."""
    return dict(os.environ, PYTHONPATH=str(copy), XDG_CACHE_HOME=str(cache),
                PYTHONDONTWRITEBYTECODE="1", **{config.DEVICE_ENV: device})


def logged_launches(stderr: str) -> dict:
    """The counts of the CLI's last "Kernel launches:" log line."""
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("Kernel launches:")]
    if not lines:
        raise AssertionError(f"no launch counts logged:\n{stderr[-2000:]}")
    return {name: int(n) for name, n in (
        item.strip().rsplit(" ", 1)
        for item in lines[-1].split(":", 1)[1].split(","))}


def run_cli(argv: list, cwd: Path, env: dict, what: str):
    """One subprocess; raises with its output unless it exits 0."""
    proc = subprocess.run(argv, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc


def run_selftest(wav: Path, device: str):
    """examples/engine_selftest_torch.py's main on ``wav`` on ``device``
    in this process; returns its printed lines and the launches it made
    (pulse, cascade, Viterbi, roots, Burg, blur)."""
    import contextlib
    import io

    spec = importlib.util.spec_from_file_location("engine_selftest_torch",
                                                  SELFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.environ[config.DEVICE_ENV] = device
    before = _all_launches() + (_blur_launches(),)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = mod.main([str(wav)])
    after = _all_launches() + (_blur_launches(),)
    if rc != 0:
        raise AssertionError(f"self-test on {device}: rc {rc}")
    return (printed.getvalue().splitlines(),
            tuple(b - a for a, b in zip(before, after)))


def surface_slice(tmp: Path, heavy_blur: int) -> dict:
    """The port's public surface on the card: the OpenUtau launcher, the
    engine self-test and an installed copy of the package.

    Launcher: launchers/goofer-sampler-torch.sh with the heavy note's 13
    arguments on the vendored voice source, run from another directory,
    against ``python -m goofer_tpu_torch.cli`` with the same arguments:
    equal at int16, and each logs 4 pulse, 5 cascade and ``heavy_blur``
    blur launches.  Self-test: examples/engine_selftest_torch.py on a copy
    of _input.wav, on the card (four finite stems; the Viterbi, root, Burg
    and pulse kernels launched) and on the CPU; the reconstruct stems held
    as the facade's noisy stems are (LSD <= max(1 dB, the card's
    seed-to-seed + 0.5 dB)).  Installed layout: package_files() copied
    read-only into a temporary directory, a plain note rendered on the
    card through that copy's CLI with XDG_CACHE_HOME on a scratch
    directory: its kernels and codec built there, nothing written into
    the copy, the WAV equal at int16 to the in-tree render."""
    import goofer_tpu_torch.compat as gf

    t0 = time.perf_counter()
    out = {}
    work = tmp / "surface"
    work.mkdir()
    src = work / "voice.wav"
    shutil.copy(REPO / "tests" / "golden" / "voice" / "src.wav", src)
    shutil.copy(REPO / "tests" / "golden" / "voice" / "src_features.goofy",
                work / "voice_features.goofy")
    args = [str(a) for a in HEAVY[1:]]
    # the launcher's python3 is this interpreter
    env = dict(os.environ, **{config.DEVICE_ENV: "cuda"}, PATH=os.pathsep.join(
        [os.path.dirname(sys.executable), os.environ.get("PATH", "")]))
    by_launcher = run_cli([str(LAUNCHER), str(src), str(work / "l.wav")]
                          + args, work, env, "launcher")
    by_module = run_cli([sys.executable, "-m", "goofer_tpu_torch.cli",
                         str(src), str(work / "m.wav")] + args, REPO, env,
                        "python -m goofer_tpu_torch.cli")
    pcm_l, pcm_m = read_pcm(work / "l.wav"), read_pcm(work / "m.wav")
    if pcm_l.dtype != np.int16 or not np.array_equal(pcm_l, pcm_m):
        raise AssertionError("launcher: its WAV differs from python -m "
                             "goofer_tpu_torch.cli's")
    want = {"pulse_accumulate": HEAVY_PULSE_LAUNCHES,
            "one_pole_cascade": HEAVY_CASCADE_LAUNCHES,
            "gaussian_blur": heavy_blur, "pitch_viterbi": 0, "lpc_roots": 0,
            "burg_lpc": 0}
    for what, proc in (("launcher", by_launcher),
                       ("python -m", by_module)):
        got = logged_launches(proc.stderr)
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
    out["launcher_launches"] = want
    print(f"surface launcher: {LAUNCHER.relative_to(REPO)} from another "
          f"directory, heavy note ({len(pcm_l)} samples) equal at int16 to "
          f"python -m goofer_tpu_torch.cli's; launches logged by each: "
          + ", ".join(f"{k} {v}" for k, v in want.items()))

    runs = {}
    for device in ("cuda", "cpu"):
        d = work / f"selftest_{device}"
        d.mkdir()
        wav = d / "_input.wav"
        shutil.copy(REPO / "_input.wav", wav)
        lines, launched = run_selftest(wav, device)
        stems = {}
        for tag in ("reconstruct", "harmonic", "unvoiced", "breathiness"):
            y, sr = read_wav(d / f"_input_{tag}.wav")
            if not np.isfinite(y).all() or len(y) != len(read_wav(wav)[0]):
                raise AssertionError(f"self-test on {device}: stem {tag} "
                                     "non-finite or of another length")
            stems[tag] = np.asarray(y, np.float32)
        runs[device] = (lines, launched, stems)
    lines, launched, stems = runs["cuda"]
    if min(launched[0], *launched[2:5]) <= 0:
        raise AssertionError(f"self-test: launches pulse {launched[0]}, "
                             f"Viterbi {launched[2]}, roots {launched[3]}, "
                             f"Burg {launched[4]}: each must run")
    y = read_wav_mono(REPO / "_input.wav")[0]
    os.environ[config.DEVICE_ENV] = "cuda"
    feats = gf.extract_features(y, SR, n_fft=config.ENGINE_N_FFT,
                                hop_length=config.ENGINE_HOP)
    seeds = [gf.synthesize(*feats[:3], y, SR, n_fft=config.ENGINE_N_FFT,
                           hop_length=config.ENGINE_HOP, formants=feats[3],
                           seed=seed)[0] for seed in (0, 1)]
    floor = lsd_db(seeds[1], seeds[0], SR)
    card_cpu = _hold("self-test reconstruct card vs CPU",
                     stems["reconstruct"], runs["cpu"][2]["reconstruct"],
                     False, floor)
    timed = [ln for ln in lines if ln.startswith(
        ("Feature extraction", "Synthesis", "Time taken"))]
    realtime = float(timed[-1].split("(")[1].split("x")[0])
    out["selftest"] = {
        "printed": timed, "x_realtime": realtime,
        "launches": dict(zip(("pulse", "cascade", "viterbi", "roots",
                              "burg", "blur"), launched)),
        "reconstruct_card_vs_cpu_lsd_db": card_cpu[1],
        "card_seed_to_seed_lsd_db": floor}
    print(f"surface self-test: {SELFTEST.relative_to(REPO)} on _input.wav "
          f"at n_fft {config.ENGINE_N_FFT}, hop {config.ENGINE_HOP}: "
          + "; ".join(timed) + "; four finite stems; launches "
          + ", ".join(f"{k} {v}" for k, v in out["selftest"][
              "launches"].items())
          + f"; reconstruct card vs CPU LSD {card_cpu[1]:.4f} dB (card "
          f"seed-to-seed {floor:.3f} dB)")

    copy, cache = work / "installed", work / "cache"
    copy.mkdir()
    files = installed_copy(copy)
    try:
        note = [str(a) for a in PLAIN_NOTE]
        proc = run_cli([sys.executable, "-m", "goofer_tpu_torch.cli",
                        str(src), str(work / "i.wav")] + note, work,
                       installed_env(copy, cache, "cuda"), "installed copy")
        if sorted(copy.rglob("*")) != files:
            raise AssertionError("installed copy: the render wrote into the "
                                 "package")
    finally:
        set_writable(copy, True)
    libs = sorted(p.name for p in (cache / "goofer_tpu_torch").glob("*.so"))
    missing = [n for n in PLAIN_NOTE_LIBS
               if not any(lib.startswith(f"lib{n}-") for lib in libs)]
    if missing:
        raise AssertionError(f"installed copy: {missing} not built under "
                             f"XDG_CACHE_HOME ({libs})")
    GooferResampler(src, work / "t.wav", *PLAIN_NOTE, device="cuda")
    pcm_i, pcm_t = read_pcm(work / "i.wav"), read_pcm(work / "t.wav")
    if pcm_i.dtype != np.int16 or not np.array_equal(pcm_i, pcm_t):
        raise AssertionError("installed copy: its WAV differs from the "
                             "in-tree render")
    out["installed"] = {"files": len(package_files()), "built": libs,
                        "launches": logged_launches(proc.stderr)}
    out["seconds"] = time.perf_counter() - t0
    print(f"surface installed layout: {len(package_files())} files as "
          f"pyproject.toml ships them, read-only; plain note through the "
          f"copy's CLI built {libs} under XDG_CACHE_HOME, wrote nothing "
          f"into the copy, WAV equal at int16 to the in-tree render "
          f"({len(pcm_i)} samples); launches "
          + ", ".join(f"{k} {v}" for k, v in out["installed"][
              "launches"].items())
          + f"; the phase took {out['seconds']:.2f} s")
    return out


PROFILE_STAGES = ("features", "resample", "write")
# the kernels the heavy note's trace must show: (pulse, cascade, blur)
TRACED_KERNELS = (("pulse_accumulate_kernel",), ("one_pole_cascade_kernel",),
                  ("blur_rows_kernel", "blur_cols_kernel"))


def stage_split(text: str) -> dict:
    """The last "[profile] total" report in ``text``: {"total_ms",
    "x_realtime", "stages": {name: [ms, n]}}; raises unless it holds the
    three stages once each."""
    lines = text.splitlines()
    heads = [i for i, ln in enumerate(lines)
             if ln.startswith("[profile] total ")]
    if not heads:
        raise AssertionError(f"no [profile] report logged:\n{text[-2000:]}")
    head = lines[heads[-1]].split()
    stages = {}
    for ln in lines[heads[-1] + 1:heads[-1] + 1 + len(PROFILE_STAGES)]:
        name, ms, _, _, n = ln.replace("(", " ").replace(")", " ").replace(
            ",", " ").split()[:5]
        stages[name] = [float(ms), int(n.removeprefix("n="))]
    if sorted(stages) != sorted(PROFILE_STAGES) or any(
            n != 1 for _, n in stages.values()):
        raise AssertionError(f"profile report stages {stages}, expected "
                             f"{PROFILE_STAGES} once each")
    return {"total_ms": float(head[2]),
            "x_realtime": float(head[4].removesuffix("x")),
            "stages": stages}


def traced_kernels(trace_dir: Path) -> list[int]:
    """Device events per TRACED_KERNELS entry in the one trace file under
    ``trace_dir``."""
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{trace_dir}: {len(files)} trace files")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    return [sum(any(k in e.get("name", "") for k in names) for e in events)
            for names in TRACED_KERNELS]


def profile_slice(tmp: Path) -> dict:
    """The note render's own profile on the card (utils/profiling.py),
    the heavy note through cli.main on the voice source of render_slice.

    Warm, in this process: a plain render; one with GOOFER_TPU_PROFILE=1,
    which must call torch.cuda.synchronize three times (once per stage)
    where the plain render calls it never; one with GOOFER_TPU_TRACE_DIR
    set too.  Each profiled render logs features / resample / write with
    n=1, their total within the call's wall time, and writes the plain
    render's bytes; the trace holds device events of the pulse, cascade
    and blur kernels (printed beside the launch counters' rise; CUPTI
    has dropped launches, so the counts are not held equal).  Cold: the
    same note in a fresh ``python -m goofer_tpu_torch.cli`` process with
    GOOFER_TPU_PROFILE=1, its report read from its log."""
    t0 = time.perf_counter()
    name, *args = HEAVY
    work = tmp / "profile"
    work.mkdir()
    src = tmp / "voice.wav"

    def argv(out):
        return [str(src), str(work / out)] + [str(a) for a in args]

    logger = logging.getLogger("goofer_tpu_torch")
    real_sync = torch.cuda.synchronize
    out = {"warm": {}}
    os.environ[config.DEVICE_ENV] = "cuda"
    variables = {"plain": {},
                 "profile": {"GOOFER_TPU_PROFILE": "1"},
                 "profile_trace": {"GOOFER_TPU_PROFILE": "1",
                                   "GOOFER_TPU_TRACE_DIR": str(
                                       work / "trace")}}
    for run, env in variables.items():
        records, syncs = io.StringIO(), []

        def counted_sync(device=None):
            syncs.append(device)
            real_sync(device)

        handler = logging.StreamHandler(records)
        level = logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        os.environ.update(env)
        torch.cuda.synchronize = counted_sync
        before = _launches() + (_blur_launches(),)
        try:
            t1 = time.perf_counter()
            rc = cli.main(argv(f"{run}.wav"))
            wall_ms = (time.perf_counter() - t1) * 1e3
        finally:
            torch.cuda.synchronize = real_sync
            for key in env:
                del os.environ[key]
            logger.removeHandler(handler)
            logger.setLevel(level)
        launched = [b - a for a, b in zip(
            before, _launches() + (_blur_launches(),))]
        if rc != 0:
            raise AssertionError(f"profile {run}: cli rc {rc}")
        if run == "plain":
            if syncs:
                raise AssertionError(f"profile: the plain render called "
                                     f"torch.cuda.synchronize {len(syncs)} "
                                     "times")
            plain = (work / "plain.wav").read_bytes()
            continue
        if run == "profile" and len(syncs) != len(PROFILE_STAGES):
            raise AssertionError(f"profile: {len(syncs)} synchronize calls "
                                 f"with GOOFER_TPU_PROFILE=1, expected "
                                 f"{len(PROFILE_STAGES)}")
        split = stage_split(records.getvalue())
        if not sum(ms for ms, _ in split["stages"].values()) <= wall_ms:
            raise AssertionError(f"profile {run}: stages "
                                 f"{split['stages']} over the call's "
                                 f"{wall_ms:.3f} ms")
        if (work / f"{run}.wav").read_bytes() != plain:
            raise AssertionError(f"profile {run}: the WAV differs from the "
                                 "plain render's")
        split.update(wall_ms=wall_ms, synchronize_calls=len(syncs),
                     launches=launched)
        out["warm"][run] = split
    traced = traced_kernels(work / "trace")
    if min(traced) <= 0:
        raise AssertionError(f"profile: the trace holds {traced} device "
                             f"events of {TRACED_KERNELS}")
    out["warm"]["profile_trace"]["traced_kernels"] = dict(zip(
        ("pulse", "cascade", "blur"), traced))

    env = dict(os.environ, GOOFER_TPU_PROFILE="1",
               **{config.DEVICE_ENV: "cuda"})
    t1 = time.perf_counter()
    proc = run_cli([sys.executable, "-m", "goofer_tpu_torch.cli"]
                   + argv("cold.wav"), REPO, env, "cold profiled render")
    out["cold"] = stage_split(proc.stderr)
    out["cold"]["process_wall_ms"] = (time.perf_counter() - t1) * 1e3
    out["card"] = card_line()
    out["seconds"] = time.perf_counter() - t0

    def fmt(split):
        return (", ".join(f"{k} {v[0]:.2f} ms" for k, v in
                          split["stages"].items())
                + f" (total {split['total_ms']:.2f} ms, "
                f"{split['x_realtime']:.1f}x realtime)")

    warm = out["warm"]
    print(f"profile {name} trace: device events pulse {traced[0]}, cascade "
          f"{traced[1]}, blur {traced[2]}; launch counters rose "
          + ", ".join(f"{k} {v}" for k, v in zip(
              ("pulse", "cascade", "blur"),
              warm["profile_trace"]["launches"]))
          + f"; synchronize calls plain 0, GOOFER_TPU_PROFILE "
          f"{warm['profile']['synchronize_calls']}, with the trace "
          f"{warm['profile_trace']['synchronize_calls']}; WAVs byte-equal "
          "to the plain render")
    print(f"profile {name} stage split on {out['card']}: warm "
          f"{fmt(warm['profile'])}; warm with the trace "
          f"{fmt(warm['profile_trace'])}; cold process "
          f"{fmt(out['cold'])}, process wall "
          f"{out['cold']['process_wall_ms']:.1f} ms; the phase took "
          f"{out['seconds']:.2f} s")
    return out


def build_codecs() -> tuple[list[Path], float]:
    """Build the two host codec libraries (g++), one thread each; returns
    their paths and the seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(native.build, (native.WAV_SRC, native.SND_SRC)))
    return libs, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        codecs = pool.submit(build_codecs)
        libs = _build.build_all([
            pulse_kernel.KERNEL, cascade_kernel.KERNEL, viterbi_kernel.KERNEL,
            lpc_roots_kernel.KERNEL, burg_kernel.KERNEL, blur_kernel.KERNEL])
        codec_libs, codec_s = codecs.result()
    print(f"build {', '.join(p.name for p in libs)}: "
          f"{time.perf_counter() - t0:.2f} s")
    print(f"codec build {', '.join(p.name for p in codec_libs)} (g++, "
          f"beside the nvcc builds): {codec_s:.2f} s")

    err, p_rows = check_pulse_kernel(_pulse_cases() + phrase_pulse_cases()
                                     + facade_pulse_cases())
    c_err, c_rel, c_rows = check_cascade_kernel(
        cascade_cases() + phrase_cascade_cases() + phrase_cascade_cases(20)
        + facade_cascade_cases())
    bl_err, bl_rel, bl_rows = check_blur_kernel(blur_cases())
    dev = torch.device("cuda")
    v_err, v_bad, v_rows = check_viterbi_kernel(viterbi_cases(dev))
    frame_cases = lpc_cases(dev)
    b_err, lpc_coeffs, b_rows = check_burg_kernel(frame_cases)
    r_err, r_rows = check_lpc_roots_kernel(frame_cases, lpc_coeffs)
    del frame_cases, lpc_coeffs

    pulse_kernel.pulse_accumulate.launches = 0
    cascade_kernel.one_pole_cascade.launches = 0
    blur_kernel.gaussian_blur.launches = 0
    blur_by_phase = {}

    def blurred(phase: str, start: int) -> None:
        blur_by_phase[phase] = _blur_launches() - start
        if blur_by_phase[phase] <= 0:
            raise AssertionError(f"the {phase} path never launched the blur "
                                 "kernel")

    with tempfile.TemporaryDirectory() as tmp:
        warm, per_note = render_slice(Path(tmp))
        launches, c_launches = _launches()
        check_heavy(Path(tmp))
        check_flag_notes(Path(tmp))
        prof = profile_heavy(Path(tmp))
        blurred("note", 0)
        start = _blur_launches()
        phrases = phrase_slice(Path(tmp))
        blurred("phrase", start)
        start = _blur_launches()
        analysis = analysis_slice(Path(tmp))
        blurred("analysis", start)
        start = _blur_launches()
        served = server_slice(Path(tmp))
        blurred("server", start)
        start = _blur_launches()
        facade = facade_slice()
        blurred("facade", start)
        start = _blur_launches()
        edited = editor_slice(Path(tmp))
        blurred("editor", start)
        start = _blur_launches()
        codec = codec_slice(Path(tmp))
        blurred("codec", start)
        start = _blur_launches()
        par = parallel_slice(Path(tmp))
        blurred("parallel", start)
        start = _blur_launches()
        surface = surface_slice(Path(tmp), per_note[HEAVY[0]][2])
        blurred("surface", start)
        start, before = _blur_launches(), _launches()
        profile = profile_slice(Path(tmp))
        pr_launches = [b - a for a, b in zip(before, _launches())]
        blurred("profile", start)
    codec["build_s"] = codec_s
    pa_launches = par.pop("launches")
    if min(pa_launches) <= 0:
        raise AssertionError(f"the mesh path launched the five kernels "
                             f"{pa_launches} times: each must run")
    v_launches, r_launches, b_launches = analysis.pop("launches")
    if min(v_launches, r_launches, b_launches) <= 0:
        raise AssertionError(
            f"the folder extraction launched the Viterbi kernel "
            f"{v_launches}, the root kernel {r_launches} and the Burg "
            f"kernel {b_launches} times")
    sv_launches, sv_c_launches = served.pop("launches")
    fa_launches, fa_c_launches = facade.pop("launches")
    fa_analysis = facade.pop("analysis_launches")
    ed_launches, ed_c_launches = edited.pop("launches")
    co_launches, co_c_launches = codec.pop("launches")
    co_analysis = codec.pop("analysis_launches")
    ph_launches, ph_c_launches = phrases.pop("launches")
    if ph_launches <= 0 or ph_c_launches <= 0:
        raise AssertionError(f"the phrases launched the pulse kernel "
                             f"{ph_launches} and the cascade kernel "
                             f"{ph_c_launches} times")
    if launches <= 0:
        raise AssertionError("the render never launched the pulse kernel")
    if c_launches <= 0:
        raise AssertionError("the render never launched the cascade kernel")
    heavy = per_note[HEAVY[0]]
    if heavy != (HEAVY_PULSE_LAUNCHES, HEAVY_CASCADE_LAUNCHES,
                 HEAVY_BLUR_LAUNCHES):
        raise AssertionError(f"heavy note: {heavy[0]} pulse, {heavy[1]} "
                             f"cascade and {heavy[2]} blur launches, "
                             f"expected {HEAVY_PULSE_LAUNCHES}, "
                             f"{HEAVY_CASCADE_LAUNCHES} and "
                             f"{HEAVY_BLUR_LAUNCHES}")
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
    print(json.dumps({"phrases": phrases}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"server": served}))
    print(json.dumps({"facade": facade}))
    print(json.dumps({"editor": edited}))
    print(json.dumps({"codec": codec}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"surface": surface}))
    print(json.dumps({"profile": profile}))
    def per_chunk(n_launches):
        return {"launches_per_chunk": n_launches / analysis["chunks"],
                "chunks": analysis["chunks"],
                "timed_case": "bank_chunk: the 64-file folder's largest "
                              "chunk"}

    vb, vf, v_steps, v_ms, v_p_ms, v_bound, v_bound_by = v_rows["bank_chunk"]
    rn, _, r_ms, r_p_ms, r_lib_ms, r_bound, r_bound_by = r_rows["bank_chunk"]
    bn, bw, b_ms, b_p_ms, b_p_kernels, b_bound, b_bound_by = \
        b_rows["bank_chunk"]
    analysis_kernels = [{
        "name": "pitch_viterbi",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/pitch_viterbi.cu",
        "replaces": "goofer_tpu/analysis/pitch.py:180",
        "note": "replaces non-Pallas JAX code: _viterbi's two associative "
                "scans of max-plus matrices; here the sequential solve "
                "with a backtrace, one CTA per file, the transition costs "
                "computed ahead of the chain",
        "launches": (v_launches + fa_analysis[0] + co_analysis[0]
                     + pa_launches[2]),
        "launches_parallel_path": pa_launches[2],
        "launches_folder_path": v_launches,
        "launches_facade_path": fa_analysis[0],
        "launches_codec_path": co_analysis[0],
        **per_chunk(v_launches),
        "max_abs_err": v_err,
        "path_frames_differing": v_bad,
        "ms": v_ms,
        "plain_ms": v_p_ms,
        "bound_ms": v_bound,
        "bound_by": v_bound_by,
        "dependent_steps": v_steps,
        "library_ms": None,
        "library_note": no_library,
        "shape": f"B={vb} F={vf} K=6",
        "ms_by_case": {k: v[3] for k, v in v_rows.items()},
        "plain_ms_by_case": {k: v[4] for k, v in v_rows.items()},
        "bound_ms_by_case": {k: v[5] for k, v in v_rows.items()},
        "folder_device_ms": analysis["viterbi_ms"],
    }, {
        "name": "lpc_roots",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/lpc_roots.cu",
        "replaces": "goofer_tpu/analysis/formants.py:119",
        "note": "replaces non-Pallas JAX code: _poly_roots_dk's fori_loop "
                "of 60 Durand-Kerner iterations; floor(32 / order) "
                "frames per warp, a root per lane",
        "launches": (r_launches + fa_analysis[1] + co_analysis[1]
                     + pa_launches[3]),
        "launches_parallel_path": pa_launches[3],
        "launches_folder_path": r_launches,
        "launches_facade_path": fa_analysis[1],
        "launches_codec_path": co_analysis[1],
        **per_chunk(r_launches),
        "max_abs_err": r_err,
        "ms": r_ms,
        "plain_ms": r_p_ms,
        "bound_ms": r_bound,
        "bound_by": r_bound_by,
        "library_ms": r_lib_ms,
        "library_note": "torch.linalg.eigvals of the companion matrices, "
                        "timed here and used nowhere in the port",
        "shape": f"rows={rn} order={LPC_ORDER}",
        "ms_by_case": {k: v[2] for k, v in r_rows.items()},
        "plain_ms_by_case": {k: v[3] for k, v in r_rows.items()},
        "library_ms_by_case": {k: v[4] for k, v in r_rows.items()},
        "bound_ms_by_case": {k: v[5] for k, v in r_rows.items()},
        "converged_rows_by_case": {k: v[1] for k, v in r_rows.items()},
        "folder_device_ms": analysis["roots_ms"],
    }, {
        "name": "burg_lpc",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/burg_lpc.cu",
        "replaces": "goofer_tpu/analysis/formants.py:83",
        "note": "replaces non-Pallas JAX code: _burg_coeffs' fori_loop "
                "over the order; one warp per frame, each lane's "
                "stretch of the errors in registers (shared memory past "
                "1152 samples)",
        "launches": (b_launches + fa_analysis[2] + co_analysis[2]
                     + pa_launches[4]),
        "launches_parallel_path": pa_launches[4],
        "launches_folder_path": b_launches,
        "launches_facade_path": fa_analysis[2],
        "launches_codec_path": co_analysis[2],
        **per_chunk(b_launches),
        "max_abs_err": b_err,
        "ms": b_ms,
        "plain_ms": b_p_ms,
        "plain_device_kernels": b_p_kernels,
        "bound_ms": b_bound,
        "bound_by": b_bound_by,
        "library_ms": None,
        "library_note": no_library,
        "shape": f"rows={bn} wlen={bw} order={LPC_ORDER}",
        "ms_by_case": {k: v[2] for k, v in b_rows.items()},
        "plain_ms_by_case": {k: v[3] for k, v in b_rows.items()},
        "bound_ms_by_case": {k: v[5] for k, v in b_rows.items()},
        "folder_device_ms": analysis["burg_ms"],
    }]
    print(json.dumps({"kernels": [{
        "name": "pulse_accumulate",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/pulse_accumulate.cu",
        "replaces": "goofer_tpu/ops/pallas/pulse_kernel.py:61",
        "note": "the whole pulse pass in one cluster launch, f0 in and "
                "pulse train out: phase scan, onsets and onset tables "
                "(goofer_tpu/ops/pulse.py:109, :84, :170) and the "
                "K-bounded LF accumulation of the Pallas kernel",
        "launches": (launches + ph_launches + sv_launches + fa_launches
                     + ed_launches + co_launches + pa_launches[0]
                     + pr_launches[0]),
        "launches_note_path": launches,
        "launches_profile_path": pr_launches[0],
        "launches_parallel_path": pa_launches[0],
        "launches_phrase_path": ph_launches,
        "launches_server_path": sv_launches,
        "launches_per_server_burst": sv_launches / SERVER_BURST_REPS,
        "launches_per_facade_call": fa_launches,
        "launches_editor_path": ed_launches,
        "launches_per_editor_preview": edited["launches_per_preview"][
            "pulse"],
        "launches_codec_path": co_launches,
        "launches_per_phrase": {k: v["pulse_launches"]
                                for k, v in phrases.items()},
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
        "phrase_device_ms": {k: v["pulse_ms"] for k, v in phrases.items()},
        "heavy_note_device_ms": prof["pulse_ms"],
        "heavy_note_device_share": prof["pulse_share"],
    }, {
        "name": "one_pole_cascade",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/one_pole_cascade.cu",
        "replaces": "goofer_tpu/ops/scan_iir.py:41",
        "note": "replaces non-Pallas JAX code: first_order_recurrence_pos, "
                "the stage solver of dynamic_one_pole_cascade",
        "launches": (c_launches + ph_c_launches + sv_c_launches
                     + fa_c_launches + ed_c_launches + co_c_launches
                     + pa_launches[1] + pr_launches[1]),
        "launches_note_path": c_launches,
        "launches_profile_path": pr_launches[1],
        "launches_parallel_path": pa_launches[1],
        "launches_phrase_path": ph_c_launches,
        "launches_server_path": sv_c_launches,
        "launches_per_server_burst": sv_c_launches / SERVER_BURST_REPS,
        "launches_per_facade_call": fa_c_launches,
        "launches_editor_path": ed_c_launches,
        "launches_codec_path": co_c_launches,
        "launches_per_phrase": {k: v["cascade_launches"]
                                for k, v in phrases.items()},
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
        "plain_ms_by_case": {k: v[5] for k, v in c_rows.items()},
        "bound_ms_by_case": {k: v[6] for k, v in c_rows.items()},
        "phrase_device_ms": {k: v["cascade_ms"] for k, v in phrases.items()},
        "heavy_note_device_ms": prof["cascade_ms"],
        "heavy_note_device_share": prof["cascade_share"],
    }, {
        "name": "gaussian_blur",
        "route": "cuda",
        "source": "goofer_tpu_torch/csrc/gaussian_blur.cu",
        "replaces": "goofer_tpu/ops/filters.py:68",
        "note": "replaces non-Pallas JAX code: _conv_valid_lastaxis (a "
                "direct conv up to 33 taps, an FFT convolution above) "
                "behind gaussian_blur1d; the bits of an output depend on "
                "the tap count alone (in-order fmaf along the bins; along "
                "the samples in-order partitions of the taps, one warp "
                "each, added in order), so a row does not depend on its "
                "batch; a complex spectrum in one launch",
        "launches": sum(blur_by_phase.values()),
        "launches_by_path": blur_by_phase,
        "launches_per_heavy_note": heavy[2],
        "launches_per_phrase": {k: v["blur_launches"]
                                for k, v in phrases.items()},
        "max_abs_err": bl_err,
        "max_rel_err": bl_rel,
        "ms": bl_rows["note_s441"][2],
        "plain_ms": bl_rows["note_s441"][3],
        "bound_ms": bl_rows["note_s441"][5],
        "bound_by": bl_rows["note_s441"][6],
        "library_ms": bl_rows["note_s441"][4],
        "library_note": "torch.nn.functional.conv1d (cuDNN) of the rows "
                        "already reflect-padded, timed here; on the card "
                        "the port never calls it",
        "timed_case": "note_s441: B=1, n=48510, sigma 441, 3529 taps (pd)",
        "ms_by_case": {k: v[2] for k, v in bl_rows.items()},
        "plain_ms_by_case": {k: v[3] for k, v in bl_rows.items()},
        "library_ms_by_case": {k: v[4] for k, v in bl_rows.items()},
        "bound_ms_by_case": {k: v[5] for k, v in bl_rows.items()},
        "phrase_device_ms": {k: v["blur_ms"] for k, v in phrases.items()},
        "phrase_device_ms_by_kernel": {k: v["blur_ms_by_kernel"]
                                       for k, v in phrases.items()},
        "heavy_note_device_ms": prof["blur_ms"],
        "heavy_note_device_ms_by_kernel": prof["blur_ms_by_kernel"],
        "heavy_note_device_share": prof["blur_share"],
        "ms_by_kernel": {
            "blur_rows_kernel": {k: v[2] for k, v in bl_rows.items()
                                 if len(v[0]) == 2},
            "blur_cols_kernel": {k: v[2] for k, v in bl_rows.items()
                                 if len(v[0]) > 2}},
    }] + analysis_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
