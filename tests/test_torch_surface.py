"""The port's public surface against goofer_tpu's, on the CPU.

Every name a goofer_tpu subpackage ``__init__`` exports comes from the
port's counterpart; the helpers the port lacked until now (midi_to_hz,
f0_rmse_cents, linear_interp, linear_interp_extrap, gaussian_blur_freq,
forward_fill, plan_sample_loop, apply_frame_plan, three config constants)
are held to their JAX functions on seeded inputs.  Tolerances: the
float64 NumPy helpers (midi_to_hz, f0_rmse_cents, plan_sample_loop) and
the index-only forward_fill exactly; the float32 interpolations and the
plan applier atol 1e-6 (one or two float32 roundings of values of size
<= 10, in another order); the frequency blur atol 1e-6 (a 17-tap float32
sum in two convolution orders).  The blur kernel's tiling is modelled
here in NumPy (the CUDA source has no CPU build) and held to the plain
version at 1e-5 x max|x|.  Also here: the launcher and the engine
self-test example on the CPU, the package as pyproject.toml ships it, and
an audit of every public top-level name of goofer_tpu's modules (ported,
or in NOT_PORTED with its reason)."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import pkgutil  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from goofer_tpu import config as j_config  # noqa: E402
from goofer_tpu.ops import filters as j_filters  # noqa: E402
from goofer_tpu.ops import interp as j_interp  # noqa: E402
from goofer_tpu.ops import pulse as j_pulse  # noqa: E402
from goofer_tpu.sampler import flags as j_flags  # noqa: E402
from goofer_tpu.sampler import plan as j_plan  # noqa: E402
from goofer_tpu.utils import metrics as j_metrics  # noqa: E402
from goofer_tpu_torch import config, native  # noqa: E402
from goofer_tpu_torch.ops import filters, interp, pulse  # noqa: E402
from goofer_tpu_torch.ops.cuda import _build, blur_kernel  # noqa: E402
from goofer_tpu_torch.sampler import flags, plan  # noqa: E402
from goofer_tpu_torch.utils import metrics  # noqa: E402
from goofer_tpu_torch.utils.audio_io import write_wav  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
RNG_SEED = 20
SUBPACKAGES = ("analysis", "engine", "io", "models", "ops", "sampler",
               "utils")


def _exported(package_dir: Path) -> list[str]:
    """The names an ``__init__.py`` imports, in order."""
    tree = ast.parse((package_dir / "__init__.py").read_text())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_goofer_tpu(sub):
    """The port's subpackage exports goofer_tpu's names, each the port's
    own definition: a function or class of the port's module of the same
    name as goofer_tpu's, or (ops) the port's submodule."""
    names = _exported(REPO / "goofer_tpu" / sub)
    assert names and _exported(REPO / "goofer_tpu_torch" / sub) == names
    ours = importlib.import_module(f"goofer_tpu_torch.{sub}")
    theirs = importlib.import_module(f"goofer_tpu.{sub}")
    for name in names:
        mine, ref = getattr(ours, name), getattr(theirs, name)
        want = ref.__name__.replace("goofer_tpu.", "goofer_tpu_torch.", 1) \
            if sub == "ops" else ref.__module__.replace(
                "goofer_tpu.", "goofer_tpu_torch.", 1)
        assert (mine.__name__ if sub == "ops" else mine.__module__) == want
        if sub != "ops":
            assert mine.__name__ == ref.__name__


UNIVERSAL = "the universal fallback graph, which bounds XLA compiles; " \
    "the port renders eagerly"
COMPILE = "compile machinery for XLA or the TPU"
# (goofer_tpu module, public top-level name) -> why the port's counterpart
# module has no such name
NOT_PORTED = {
    ("sampler/render_core.py", "universal_static"): UNIVERSAL,
    ("sampler/render_core.py", "universalize_inputs"): UNIVERSAL,
    ("sampler/render_core.py", "clear_compiled_render_graphs"):
        "drops jit executables pinned for the graph budget: " + COMPILE,
    ("sampler/render_core.py", "FORMANT_BELL_SIGMAS"):
        "renamed to ops/envelope.py:FORMANT_BELL_SIGMAS_HZ",
    ("sampler/resampler.py", "render_note_auto"): UNIVERSAL,
    ("sampler/resampler.py", "warm_universal"): UNIVERSAL,
    ("sampler/resampler.py", "plan_warm_entries"): UNIVERSAL,
    ("sampler/resampler.py", "WARM_NOTE_SECONDS"): UNIVERSAL,
    ("sampler/resampler.py", "WARM_SAMPLE_RATES"): UNIVERSAL,
    ("sampler/resampler.py", "GRAPH_BUDGET"): COMPILE,
    ("sampler/phrase.py", "PHRASE_GRAPH_BUDGET"): COMPILE,
    ("ops/envelope.py", "env_shape_traced"): UNIVERSAL,
    ("ops/envelope.py", "banded_gather_lerp_columns"): UNIVERSAL,
    ("ops/filters.py", "gaussian_blur1d_traced"): UNIVERSAL,
    ("ops/filters.py", "fft_conv_valid"):
        "a power-of-two FFT convolution for XLA-TPU compile times; the "
        "port's blur is csrc/gaussian_blur.cu: " + COMPILE,
    ("engine/synth.py", "synth_core_impl"):
        "the unjitted body of the jitted synth_core; the port's eager "
        "body is engine/synth.py:_synth_body",
    ("analysis/pitch.py", "pitch_graph_bucketed"):
        "a compile bucket of padded signals; the port's pitch_graph takes "
        "any length: " + COMPILE,
    ("config.py", "ENVELOPE_MATMUL_DTYPE"):
        "a bfloat16 option for the TPU's MXU; the port pins float32: "
        + COMPILE,
    ("ops/scan_iir.py", "first_order_recurrence"):
        "renamed to ops/scan_iir.py:_affine_scan, the stage solver",
    ("ops/scan_iir.py", "first_order_recurrence_pos"):
        "log-domain blocks that keep exp inside float32 on the TPU; the "
        "port's stages run in csrc/one_pole_cascade.cu",
    ("ops/scan_iir.py", "dynamic_one_pole_cascade"):
        "renamed to ops/scan_iir.py:cascade, which takes the stage "
        "coefficients where it took the cutoff",
    ("ops/pallas/pulse_kernel.py", "pulse_accumulate_pallas"):
        "the Pallas kernel; counterpart ops/cuda/pulse_kernel.py",
    ("ops/pallas/pulse_kernel.py", "BLK"):
        "the Pallas block; the CUDA tile is ops/cuda/pulse_kernel.py:TILE",
    ("ops/pallas/pulse_kernel.py", "OCTET"):
        "the Pallas sublane group of the TPU's vector registers",
    ("utils/aot.py", "wrap"): "the exported-module store: " + COMPILE,
    ("utils/aot.py", "store_dir"): "the exported-module store: " + COMPILE,
    ("utils/aot.py", "log"): "the exported-module store: " + COMPILE,
}


def _public_names(path: Path, imported: bool) -> set[str]:
    """The public names a module binds at its top level: its functions,
    classes and assignments, and with ``imported`` its imports too."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_goofer_tpu_name_is_ported_or_decided_against():
    """Parsed, not imported: every public top-level name of each
    goofer_tpu module exists in the port's module of the same path, or
    stands in NOT_PORTED with its reason; and every NOT_PORTED entry is
    still missing from the port."""
    missing = set()
    for path in sorted((REPO / "goofer_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "goofer_tpu")
        ours = REPO / "goofer_tpu_torch" / rel
        have = _public_names(ours, True) if ours.is_file() else set()
        missing.update((rel.as_posix(), name)
                       for name in _public_names(path, False) - have)
    assert sorted(missing - NOT_PORTED.keys()) == []
    assert sorted(NOT_PORTED.keys() - missing) == []


def test_midi_to_hz_matches_goofer_tpu():
    m = np.random.default_rng(RNG_SEED).uniform(0, 127, 64)
    for arg in (m, 69, 60.5, list(m[:3])):
        np.testing.assert_array_equal(flags.midi_to_hz(arg),
                                      j_flags.midi_to_hz(arg))


def test_f0_rmse_cents_matches_goofer_tpu():
    rng = np.random.default_rng(RNG_SEED)
    a = rng.uniform(80, 400, 300) * (rng.random(300) > 0.2)
    b = a * 2 ** (rng.normal(0, 0.01, 300)) * (rng.random(300) > 0.1)
    for args in ((a, b), (a, b[:250]), (a, b, False), (a * 0, b)):
        assert metrics.f0_rmse_cents(*args) == j_metrics.f0_rmse_cents(*args)


def test_config_constants_match_goofer_tpu():
    for name in ("ENGINE_N_FFT", "ENGINE_HOP", "VOICING_THRESHOLD_HZ"):
        assert getattr(config, name) == getattr(j_config, name)


def _interp_inputs():
    rng = np.random.default_rng(RNG_SEED)
    x = np.sort(rng.random(12)) * 10
    x[5] = x[4]                                  # a zero-width segment
    y = rng.standard_normal(12)
    x_new = np.concatenate([np.linspace(-3, 13, 97), x])
    return [a.astype(np.float32) for a in (x, y, x_new)]


@pytest.mark.parametrize("fill", [None, 0.25])
def test_linear_interp_matches_goofer_tpu(fill):
    x, y, x_new = _interp_inputs()
    got = interp.linear_interp(torch.as_tensor(x), torch.as_tensor(y),
                               torch.as_tensor(x_new), fill)
    want = j_interp.linear_interp(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(x_new), fill)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_linear_interp_extrap_matches_goofer_tpu():
    x, y, x_new = _interp_inputs()
    x[5] += 0.5                                  # extrapolation needs a slope
    x = np.sort(x)
    got = interp.linear_interp_extrap(x, y, x_new)
    want = j_interp.linear_interp_extrap(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(x_new))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_forward_fill_matches_goofer_tpu():
    rng = np.random.default_rng(RNG_SEED)
    values = rng.standard_normal((3, 200)).astype(np.float32)
    valid = rng.random((3, 200)) > 0.7
    valid[1, :40] = False
    got = pulse.forward_fill(torch.as_tensor(values), torch.as_tensor(valid),
                             -2.5)
    for row in range(3):
        want = j_pulse.forward_fill(jnp.asarray(values[row]),
                                    jnp.asarray(valid[row]), -2.5)
        np.testing.assert_array_equal(got[row].numpy(), np.asarray(want))


@pytest.mark.parametrize("pre,tail,desired", [(0, 1000, 5000),
                                              (0, 5000, 800), (13, 777, 2000),
                                              (5, 3, 100)])
def test_plan_sample_loop_matches_goofer_tpu(pre, tail, desired):
    got = plan.plan_sample_loop(pre, tail, desired)
    want = j_plan.plan_sample_loop(pre, tail, desired)
    for field in ("pos0", "pos1", "w"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(40,), (5, 37)])
def test_apply_frame_plan_matches_goofer_tpu(shape):
    rng = np.random.default_rng(RNG_SEED)
    src = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    plans = [plan.plan_env_loop(3, n - 3, 90, "avg"),
             plan.plan_sample_loop(4, n - 4, 75),
             plan.plan_prefix_stretch(n, 9, 1.4)]
    j_plans = [j_plan.plan_env_loop(3, n - 3, 90, "avg"),
               j_plan.plan_sample_loop(4, n - 4, 75),
               j_plan.plan_prefix_stretch(n, 9, 1.4)]
    for mine, theirs in zip(plans, j_plans):
        got = plan.apply_frame_plan(torch.as_tensor(src), mine)
        want = j_plan.apply_frame_plan(jnp.asarray(src), theirs)
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("sigma", [0.5, 2.0])
def test_gaussian_blur_freq_matches_goofer_tpu(sigma):
    env = np.random.default_rng(RNG_SEED).random((65, 23)).astype(np.float32)
    got = filters.gaussian_blur_freq(torch.as_tensor(env), sigma)
    want = j_filters.gaussian_blur_freq(jnp.asarray(env), sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    batched = filters.gaussian_blur_freq(torch.as_tensor(env[None]), sigma)
    assert torch.equal(batched[0], got)


# ------------------------------------------------- the blur kernel's tiling

def _reflect(j: np.ndarray, n: int) -> np.ndarray:
    """The kernel's reflect index (numpy's repeated reflection)."""
    if n == 1:
        return np.zeros_like(j)
    period = 2 * (n - 1)
    m = np.mod(j, period)
    return np.where(m >= n, period - m, m)


def rows_model(x: np.ndarray, taps: np.ndarray,
               run: int | None = None) -> np.ndarray:
    """csrc/gaussian_blur.cu's blur_rows_kernel in NumPy, at the layout
    blur_kernel.rows_geometry picks (or with ``run`` outputs per lane):
    per (row, tile) the staged span (its size as the source allocates it,
    so a read past it raises); per tap partition, each lane's run of
    outputs summed over its window of run + 15 samples per chunk of 16
    taps, then the tail, in tap order; the partials added in partition
    order and written back in tile order."""
    batch, n = x.shape
    ntaps = len(taps)
    radius = (ntaps - 1) // 2
    geo = blur_kernel.rows_geometry(batch, n, ntaps, run)
    chunk = blur_kernel.TAP_CHUNK
    assert geo.threads <= 512 and geo.part_len % chunk == 0
    assert (geo.parts - 1) * geo.part_len < ntaps <= geo.parts * geo.part_len
    r, tile = geo.run, geo.tile
    span = tile + ntaps - 1
    starts = np.arange(geo.tiles) * tile
    s = x[:, _reflect(starts[:, None] - radius + np.arange(span), n)]
    base = (np.arange(blur_kernel.WARP * geo.groups) * r)[:, None]
    total = None
    for p in range(geo.parts):
        k0 = p * geo.part_len
        k1 = min(ntaps, k0 + geo.part_len)
        whole = k0 + (k1 - k0) // chunk * chunk
        acc = np.zeros((batch, geo.tiles) + base.shape[:1] + (r,),
                       np.float32)
        for kb in range(k0, whole, chunk):
            xs = s[:, :, base + kb + np.arange(r + chunk - 1)]
            w = taps[kb:kb + chunk]
            assert kb % 4 == 0 and len(w) == chunk
            for q in range(chunk):
                acc = acc + w[q] * xs[..., q:q + r]
        for k in range(whole, k1):
            acc = acc + taps[k] * s[:, :, base + k + np.arange(r)]
        acc = acc.reshape(batch, geo.tiles * tile)
        total = acc if total is None else total + acc
    return total[:, :n]


def cols_threads(outer: int, n: int, inner: int, ntaps: int,
                 run: int | None = None):
    """csrc/gaussian_blur.cu's blur_cols_kernel grid: (slab, first output,
    column) of every thread that passes the bound check, and its run (the
    wrapper's col_run, or ``run``)."""
    run = run or blur_kernel.col_run(outer, n, inner, ntaps)
    runs = -(-n // run)
    threads = outer * runs * inner
    blocks = -(-threads // blur_kernel.COL_THREADS)
    idx = np.arange(blocks * blur_kernel.COL_THREADS)
    idx = idx[idx < threads]
    rest = idx // inner
    return rest // runs, rest % runs * run, idx % inner, run


def cols_cover(outer: int, n: int, inner: int, ntaps: int,
               run: int | None = None) -> np.ndarray:
    """How many threads of blur_cols_kernel write each (slab, output,
    column)."""
    slab, i0, col, run = cols_threads(outer, n, inner, ntaps, run)
    hits = np.zeros((outer, n, inner), np.int64)
    for i in range(run):
        ok = i0 + i < n
        np.add.at(hits, (slab[ok], i0[ok] + i, col[ok]), 1)
    return hits


def cols_model(x: np.ndarray, taps: np.ndarray,
               run: int | None = None) -> np.ndarray:
    """blur_cols_kernel in NumPy on (outer, n, inner): each thread's window
    of run + ntaps - 1 reflected bins of its column, its outputs summed
    over it in tap order, stored where the bound check lets them."""
    outer, n, inner = x.shape
    ntaps = len(taps)
    radius = (ntaps - 1) // 2
    slab, i0, col, run = cols_threads(outer, n, inner, ntaps, run)
    window = x[slab[:, None],
               _reflect(i0[:, None] - radius + np.arange(run + ntaps - 1),
                        n),
               col[:, None]]
    out = np.full_like(x, np.nan)
    for i in range(run):
        acc = np.zeros(len(slab), np.float32)
        for k in range(ntaps):
            acc = acc + taps[k] * window[:, i + k]
        ok = i0 + i < n
        out[slab[ok], i0[ok] + i, col[ok]] = acc[ok]
    return out


# n and sigma: the edges of the first layout's 1152-output tile, the
# short track
@pytest.mark.parametrize("n,sigma", [
    (1, 2.0), (2, 2.0), (5, 20.0), (1151, 0.5), (1152, 12.25), (1153, 2.0),
    (2307, 25.0), (700, 441.0)])
def test_blur_rows_model_matches_plain(n, sigma):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    taps = filters.gaussian_kernel1d(sigma)
    want = filters.blur_plain(torch.as_tensor(x), taps).numpy()
    got = rows_model(x, taps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("batch,n,sigma", [
    (1, 48510, 441.0), (1, 700, 441.0), (1, 48510, 20.0), (80, 4136, 9.25),
    (3, 2 * 32 * 15 + 1, 882.0), (2, 5000, 80.0), (1, 3000, 100.0)])
def test_blur_rows_model_one_row_and_every_run(batch, n, sigma):
    """The heavy note's one row of 48510 (13 tap partitions of 272), a
    700-sample row under 3529 taps, the jitter's batch, 7057 taps (16
    partitions), 641 and 801 taps (2 and 3): the layout rows_geometry
    picks matches the plain version, and every run of RUNS sums the same
    terms in the same order, bit for bit."""
    x = np.random.default_rng(n + batch).standard_normal(
        (batch, n)).astype(np.float32)
    taps = filters.gaussian_kernel1d(sigma)
    want = filters.blur_plain(torch.as_tensor(x), taps).numpy()
    got = rows_model(x, taps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(x).max())
    for run in blur_kernel.RUNS:
        np.testing.assert_array_equal(rows_model(x, taps, run), got)


@pytest.mark.parametrize("outer,n,sigma,run", [
    (1, 48510, 441.0, 7), (80, 33074, 441.0, 15), (16, 33074, 441.0, 15),
    (3, 700, 441.0, 1), (1, 48510, 20.0, 1), (80, 8270, 12.25, 7),
    (80, 4136, 9.25, 3)])
def test_blur_rows_geometry_fills_the_card(outer, n, sigma, run):
    """3529 taps make 13 partitions of 272: the note's row spreads over
    217 CTAs of 13 warps, (b)'s 80 rows over 5520; a 700-sample row gets
    32-output tiles; the short blurs fill 4-warp CTAs.  The largest run
    whose grid reaches 16 warps per SM, else the smallest; a CTA never
    exceeds 512 threads."""
    ntaps = len(filters.gaussian_kernel1d(sigma))
    geo = blur_kernel.rows_geometry(outer, n, ntaps)
    assert geo.threads <= 512 and geo.run == run and geo.tile <= n
    warps = outer * geo.tiles * geo.threads // blur_kernel.WARP
    assert warps >= blur_kernel.MIN_GRID_WARPS or run == 1
    if ntaps == 3529:
        assert (geo.parts, geo.part_len, geo.groups) == (13, 272, 1)
    else:
        assert (geo.parts, geo.groups) == (1, blur_kernel.MIN_WARPS)


@pytest.mark.parametrize("outer,n,inner", [(1, 513, 130), (3, 17, 129),
                                           (2, 5, 1000), (4, 40, 7)])
def test_blur_cols_grid_covers_each_output_once(outer, n, inner):
    """At every run the kernel is built for: the tap count's own and the
    small grid's."""
    for ntaps in (5, 57, 201):
        for run in (None, blur_kernel.COL_RUN_SMALL,
                    blur_kernel.COL_RUN_SHORT if ntaps <= 17
                    else blur_kernel.COL_RUN):
            assert (cols_cover(outer, n, inner, ntaps, run) == 1).all()


@pytest.mark.parametrize("outer,n,inner,sigma", [
    (2, 513, 2 * 130, 0.5), (1, 513, 190, 1.75), (1, 513, 327, 2.0),
    (2 * 130, 513, 2, 0.5),
    (2, 40, 9, 7.0), (1, 17, 5, 25.0)])
def test_blur_cols_model_matches_plain(outer, n, inner, sigma):
    """The bin-axis layout: a complex slab of inner 2T at 5 taps, the
    heavy note's 15 and 17, env_shape's 57, the generic 201 taps over 17
    bins (repeated reflection)."""
    x = np.random.default_rng(n + inner).standard_normal(
        (outer, n, inner)).astype(np.float32)
    taps = filters.gaussian_kernel1d(sigma)
    want = filters.blur_plain(torch.as_tensor(x), taps, axis=1).numpy()
    own = (blur_kernel.COL_RUN_SHORT if len(taps) <= 17
           else blur_kernel.COL_RUN)
    for run in (own, blur_kernel.COL_RUN_SMALL):
        assert (cols_cover(outer, n, inner, len(taps), run) == 1).all()
        np.testing.assert_allclose(cols_model(x, taps, run), want, rtol=0,
                                   atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("shape,ntaps,run", [
    ((80, 513, 130), 5, 32), ((80, 513, 344), 17, 32),
    ((80, 513, 260), 5, 32), ((80, 513, 130), 57, 16),
    ((1, 513, 380), 5, 4), ((1, 513, 190), 15, 4), ((1, 513, 327), 17, 4),
    ((80 * 130, 513, 2), 5, 4), ((190, 513, 2), 5, 4),
    ((80, 513, 130), 1, 16), ((80, 513, 130), 59, 16)])
def test_blur_cols_run_fills_the_card(shape, ntaps, run):
    """Phrase (b)'s spectra keep the tap count's run (the generic
    instantiation's for a count not unrolled); the heavy note's B = 1
    spectra take the small run, for 4 x the threads, and so do the
    complex STFT spectra as stored, (B T, bins, 2) floats."""
    assert blur_kernel.col_run(*shape, ntaps) == run


# ------------------------------------------------------- launcher, example

PLAIN = ["C4", "100", "", "0", "500", "60", "0", "100", "0", "!120", "AA"]


@pytest.fixture
def voice(tmp_path, monkeypatch):
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    for ext in (".wav", "_features.goofy"):
        shutil.copy(REPO / "tests" / "golden" / "voice" / f"src{ext}",
                    tmp_path / f"voice{ext}")
    return tmp_path / "voice.wav"


def test_launcher_renders_as_cli_main(voice, tmp_path):
    """launchers/goofer-sampler-torch.sh, run from another directory as
    OpenUtau runs it, writes the WAV cli.main writes.  Both run in a
    process of their own on one thread (with several, the CPU's FFT and
    convolutions may split their sums by the machine's load), and the
    launcher's python3 is this interpreter."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PATH=os.pathsep.join([os.path.dirname(sys.executable),
                                     os.environ.get("PATH", "")]))
    launcher = REPO / "launchers" / "goofer-sampler-torch.sh"
    runs = {}
    for name, argv in (
            ("launcher", [str(launcher)]),
            ("cli.main", [sys.executable, "-c",
                          "import sys; from goofer_tpu_torch import cli; "
                          "sys.exit(cli.main(sys.argv[1:]))"])):
        runs[name] = subprocess.run(
            argv + [str(voice), str(tmp_path / f"{name}.wav")] + PLAIN,
            cwd=tmp_path if name == "launcher" else REPO,
            capture_output=True, text=True, timeout=300, env=env)
        assert runs[name].returncode == 0, runs[name].stderr
    assert chip_smoke.logged_launches(runs["launcher"].stderr) == \
        dict.fromkeys(("pulse_accumulate", "one_pole_cascade",
                       "gaussian_blur", "pitch_viterbi", "lpc_roots",
                       "burg_lpc"), 0)
    assert (tmp_path / "launcher.wav").read_bytes() == \
        (tmp_path / "cli.main.wav").read_bytes()


def test_engine_selftest_example_on_cpu(tmp_path, monkeypatch):
    """examples/engine_selftest_torch.py on a short cut of _input.wav:
    the four stems at the input's length, finite, and the feature dump
    under the reference's keys (GOOFER.py:1306-1321)."""
    from goofer_tpu_torch.utils.audio_io import read_wav

    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    y, sr = read_wav(REPO / "_input.wav")
    wav = tmp_path / "cut.wav"
    write_wav(wav, np.asarray(y[:int(0.4 * sr)], np.float32), sr)
    spec = importlib.util.spec_from_file_location(
        "engine_selftest_torch",
        REPO / "examples" / "engine_selftest_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert example.main([str(wav), "--dump-features"]) == 0
    for tag in ("reconstruct", "harmonic", "unvoiced", "breathiness"):
        stem, sr_s = read_wav(tmp_path / f"cut_{tag}.wav")
        assert sr_s == sr and len(stem) == int(0.4 * sr)
        assert np.isfinite(stem).all()
    dump = np.load(tmp_path / "cut_features.npz", allow_pickle=True)
    assert sorted(dump.files) == sorted(
        ["env_spec", "f0_interp", "voicing_mask", "formants", "sr", "y_len"])
    assert dump["env_spec"].dtype == np.float16
    assert dump["env_spec"].shape[0] == config.ENGINE_N_FFT // 2 + 1


# --------------------------------------------------------------- packaging

def _kernels():
    """Every Kernel of the port's ops/cuda wrappers."""
    from goofer_tpu_torch.ops import cuda

    found = []
    for info in pkgutil.iter_modules(cuda.__path__):
        mod = importlib.import_module(f"goofer_tpu_torch.ops.cuda.{info.name}")
        found += [v for v in vars(mod).values()
                  if isinstance(v, _build.Kernel)]
    return found


def test_compiled_sources_ship_as_package_data():
    """Every source that ops/cuda/_build.py and native/ compile at first
    use is a file that pyproject.toml's package data ships; the shipped
    files are the package's, with no build output among them."""
    files = chip_smoke.package_files()
    assert all(p.parts[0] == "goofer_tpu_torch" for p in files)
    assert not any(p.suffix in (".so", ".pyc") for p in files)
    shipped = set(files)
    kernels = _kernels()
    assert len(kernels) == 6
    for source in [k.source for k in kernels] + [native.WAV_SRC,
                                                 native.SND_SRC]:
        assert source.is_file()
        assert source.relative_to(REPO) in shipped, source


def test_checkout_builds_into_its_build_dir():
    assert _build.default_build_dir() == REPO / "build" / "goofer_tpu_torch"


def test_installed_copy_writes_the_same_wav(tmp_path):
    """The package as pyproject.toml ships it, copied read-only, imported
    alone: it builds its WAV codec under XDG_CACHE_HOME, writes nothing
    into the copy, and writes the bytes the in-tree write_wav writes."""
    copy, cache = tmp_path / "site", tmp_path / "cache"
    copy.mkdir()
    files = chip_smoke.installed_copy(copy)
    y = np.random.default_rng(RNG_SEED).uniform(-1.2, 1.2, 4410)
    np.save(tmp_path / "y.npy", y.astype(np.float32))
    code = ("import sys, numpy as np, goofer_tpu_torch\n"
            "from goofer_tpu_torch.ops.cuda import _build\n"
            "from goofer_tpu_torch.utils import write_wav\n"
            "print(goofer_tpu_torch.__file__)\n"
            "print(_build.BUILD_DIR)\n"
            "write_wav(sys.argv[1], np.load(sys.argv[2]), 44100)\n")
    try:
        run = subprocess.run(
            [sys.executable, "-c", code, str(tmp_path / "a.wav"),
             str(tmp_path / "y.npy")], cwd=tmp_path, capture_output=True,
            text=True, timeout=300,
            env=chip_smoke.installed_env(copy, cache, "cpu"))
        assert run.returncode == 0, run.stderr
        assert sorted(copy.rglob("*")) == files
    finally:
        chip_smoke.set_writable(copy, True)
    package, build_dir = run.stdout.split()
    assert Path(package).is_relative_to(copy)
    assert Path(build_dir) == cache / "goofer_tpu_torch"
    assert [p.name.split("-")[0] for p in Path(build_dir).glob("*.so")] == [
        "libwavcodec"]
    write_wav(tmp_path / "b.wav", np.load(tmp_path / "y.npy"), 44100)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()
