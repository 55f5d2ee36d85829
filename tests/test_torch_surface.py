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
self-test example on the CPU, and the package as pyproject.toml ships
it."""
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


def rows_model(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """csrc/gaussian_blur.cu's blur_rows_kernel in NumPy: per (row, tile)
    the staged span (its size as the source allocates it, so a read past
    it raises), each thread's RUN outputs summed over chunks of RUN taps
    and the tail, in tap order, then written back in tile order."""
    run, threads, tile = blur_kernel.RUN, blur_kernel.THREADS, \
        blur_kernel.TILE
    batch, n = x.shape
    ntaps = len(taps)
    radius = (ntaps - 1) // 2
    padded = -(-ntaps // run) * run
    span = tile + padded + run
    base = (np.arange(threads) * run)[:, None]
    out = np.empty_like(x)
    for row in range(batch):
        for t0 in range(0, n, tile):
            s = x[row, _reflect(t0 - radius + np.arange(span), n)]
            acc = np.zeros((threads, run), np.float32)
            whole = ntaps // run * run
            for kb in range(0, whole, run):
                xs = s[base + kb + np.arange(2 * run - 1)]
                for q in range(run):
                    acc = acc + taps[kb + q] * xs[:, q:q + run]
            for k in range(whole, ntaps):
                acc = acc + taps[k] * s[base + k + np.arange(run)]
            valid = min(tile, n - t0)
            out[row, t0:t0 + valid] = acc.reshape(-1)[:valid]
    return out


def cols_cover(outer: int, n: int, inner: int) -> np.ndarray:
    """How many threads of csrc/gaussian_blur.cu's blur_cols_kernel write
    each (slab, output, column): its grid and index arithmetic."""
    threads, run = blur_kernel.COL_THREADS, blur_kernel.COL_RUN
    runs = -(-n // run)
    per_slab = -(-runs * inner // threads)
    hits = np.zeros((outer, n, inner), np.int64)
    for block in range(outer * per_slab):
        slab = block // per_slab
        idx = (block % per_slab) * threads + np.arange(threads)
        col, i0 = idx % inner, idx // inner * run
        for c, start in zip(col, i0):
            if start < n:
                hits[slab, start:min(start + run, n), c] += 1
    return hits


@pytest.mark.parametrize("n,sigma", [
    (1, 2.0), (2, 2.0), (5, 20.0), (blur_kernel.TILE - 1, 0.5),
    (blur_kernel.TILE, 12.25), (blur_kernel.TILE + 1, 2.0),
    (2 * blur_kernel.TILE + 3, 25.0), (700, 441.0)])
def test_blur_rows_model_matches_plain(n, sigma):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    taps = filters.gaussian_kernel1d(sigma)
    want = filters.blur_plain(torch.as_tensor(x), taps).numpy()
    got = rows_model(x, taps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("outer,n,inner", [(1, 513, 130), (3, 17, 129),
                                           (2, 5, 1000), (4, 40, 7)])
def test_blur_cols_grid_covers_each_output_once(outer, n, inner):
    assert (cols_cover(outer, n, inner) == 1).all()


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
