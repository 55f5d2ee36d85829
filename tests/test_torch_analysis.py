"""The port's analysis modules vs goofer_tpu's on the CPU: the same seeded
NumPy inputs go through the JAX function and its PyTorch counterpart, the
hand kernels through their plain versions (the CUDA kernels themselves
are held to those on the card, tests/test_torch_cuda.py).

Tolerances, with their reasons: frame grids and frames are bit-exact
(integer indexing); pitch candidates agree to 1e-4 in strength and 1e-3
relative in frequency where they are real peaks (two FFT libraries in
float32), slots without a peak carry -1e9 and arbitrary frequencies in
both packages; the sequential Viterbi equals a float32 NumPy restatement
exactly and goofer_tpu's marginal decode on >= 98% of frames (they differ
only at exact score ties); Burg coefficients rtol 1e-3 / atol 1e-4 (other
orders of 551-term float32 sums); Durand-Kerner roots 1e-4 where they
converged; formants within 1 Hz on >= 99% of entries (a root at a gate
can fall on either side)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu.analysis import formants as j_formants  # noqa: E402
from goofer_tpu.analysis import pitch as j_pitch  # noqa: E402
from goofer_tpu.ops import envelope as j_envelope  # noqa: E402
from goofer_tpu_torch.analysis import formants, pitch  # noqa: E402
from goofer_tpu_torch.ops import envelope  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    burg_kernel,
    lpc_roots_kernel,
    viterbi_kernel,
)
from goofer_tpu_torch.utils.audio_io import read_wav_mono  # noqa: E402
from tests.test_analysis import _sawtooth, _viterbi_np, _vowel  # noqa: E402

SR = 44100
HOP = 256
DT = HOP / SR
REF_WAV = "tests/golden/ref/src.wav"
GRID_CASES = [(44100, 0.7), (44100, 0.09), (48000, 0.45), (22050, 0.3),
              (44100, 0.041)]


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def ref_wave():
    y, sr = read_wav_mono(REF_WAV)
    assert sr == SR
    return y.astype(np.float32)


def _signals():
    """The four signal classes of tests/test_analysis.py's Viterbi test:
    glide, vibrato, noisy tone, silence then onset (0.7 s each)."""
    rng = np.random.default_rng(5)
    t = np.arange(int(0.7 * SR)) / SR
    return {
        "glide": _sawtooth(180.0 * 2 ** (0.5 * t / 0.7), 0.7),
        "vibrato": _sawtooth(
            220.0 * 2 ** (np.sin(2 * np.pi * 5.5 * t) / 12), 0.7),
        "noisy": (_sawtooth(150.0, 0.7) + 0.25 * rng.standard_normal(
            len(t)).astype(np.float32)),
        "onset": np.concatenate([np.zeros(len(t) // 3, np.float32),
                                 _sawtooth(110.0, 0.7)[len(t) // 3:]]),
    }


SIGNALS = _signals()


# ------------------------------------------------------------ grids, frames

@pytest.mark.parametrize("sr,dur", GRID_CASES)
def test_frame_grids_equal_jax(sr, dur):
    n = int(dur * sr)
    cfg = pitch.PitchConfig()
    assert pitch.pitch_window_len(sr, cfg) == j_pitch.pitch_window_len(
        sr, j_pitch.PitchConfig())
    wlen = min(pitch.pitch_window_len(sr, cfg), max(16, n))
    got = pitch._frame_grid(n, sr, HOP / sr, wlen)
    want = j_pitch._frame_grid(n, sr, HOP / sr, wlen)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    got_f = formants.formant_frame_grid(n, sr, HOP / sr)
    want_f = j_formants.formant_frame_grid(n, sr, HOP / sr)
    assert got_f[0] == want_f[0] and got_f[2:] == want_f[2:]
    np.testing.assert_array_equal(got_f[1], want_f[1])
    assert formants._formant_decim(sr, 5500.0) == j_formants._formant_decim(
        sr, 5500.0)


@pytest.mark.parametrize("sr,dur", GRID_CASES)
def test_frames_bitexact_vs_gather_and_jax(sr, dur):
    """The cases of test_strided_frames_bitexact_vs_gather: clamped head
    and tail rows, tiny signals where every row is clamped, and padding
    past nf (starts repeated, zero-padded waveform)."""
    cfg = pitch.PitchConfig()
    rng = np.random.default_rng(11)
    n = int(dur * sr)
    y = rng.standard_normal(n).astype(np.float32)
    wlen = min(pitch.pitch_window_len(sr, cfg), max(16, n))
    nf, starts, _ = pitch._frame_grid(n, sr, HOP / sr, wlen)
    starts_p, nf_arr = pitch.padded_grid([(nf, starts)], nf + 7)
    assert nf_arr.tolist() == [nf] and (starts_p[0, nf:] == starts[-1]).all()
    y_pad = np.concatenate([y, np.zeros(4 * HOP, np.float32)])
    got = pitch.frames_at(_t(y_pad)[None], _t(starts_p), wlen)[0].numpy()
    want = y_pad[starts_p[0][:, None] + np.arange(wlen)[None, :]]
    assert np.array_equal(got, want)
    jax_frames = np.asarray(j_pitch._frames_praat(
        jnp.asarray(y_pad), jnp.asarray(starts_p[0].astype(np.int32)), nf,
        wlen, HOP))
    assert np.array_equal(got[:nf], jax_frames[:nf])


def test_frames_of_a_row_shorter_than_the_window():
    y = np.arange(10, dtype=np.float32)[None]
    got = pitch.frames_at(_t(y), torch.zeros((1, 2), dtype=torch.int64), 16)
    assert got.shape == (1, 2, 16)
    assert np.array_equal(got[0, 0, :10].numpy(), y[0])
    assert (got[0, :, 10:] == 0).all()


# --------------------------------------------------------------- candidates

def _both_candidates(y):
    cfg = pitch.PitchConfig()
    n = len(y)
    wlen = min(pitch.pitch_window_len(SR, cfg), max(16, n))
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    nf, starts, _ = pitch._frame_grid(n, SR, DT, wlen)
    got = pitch._candidates(_t(y)[None], float(SR), wlen, nfft, cfg,
                            _t(starts)[None])
    want = j_pitch._candidates(jnp.asarray(y), float(SR), wlen, nfft,
                               j_pitch.PitchConfig(), jnp.asarray(starts),
                               HOP)
    return [g[0].numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", ["glide", "noisy", "onset"])
def test_candidates_match_jax(name):
    (f_t, s_t, peak_t), (f_j, s_j, peak_j) = _both_candidates(SIGNALS[name])
    np.testing.assert_allclose(peak_t, peak_j, atol=1e-6)
    # a frame that holds a sliver of signal at the window's edge has an
    # autocorrelation of rounding noise, and its "peaks" are either FFT's
    same = (s_t > -1e8).sum(1) == (s_j > -1e8).sum(1)
    assert same.mean() >= 0.98
    # both rank by strength; two peaks within the tolerance may swap
    for f_a, s_a, f_b, s_b in zip(f_t[same], s_t[same], f_j[same],
                                  s_j[same]):
        k = int((s_a > -1e8).sum())
        np.testing.assert_allclose(s_a[:k], s_b[:k], atol=1e-4)
        if np.all(np.diff(s_b[:k]) < -2e-4):
            np.testing.assert_allclose(f_a[:k], f_b[:k], rtol=1e-3)


# ------------------------------------------------------------------ Viterbi

def _viterbi_f32(freqs, strengths, unvoiced, vu, oj):
    """The sequential solve in NumPy float32, operation for operation as
    viterbi_plain and the CUDA kernel run it."""
    k = freqs.shape[1]
    s_all = np.concatenate([strengths, unvoiced[:, None]], 1).astype(
        np.float32)
    f_all = np.concatenate([freqs, np.zeros_like(freqs[:, :1])], 1).astype(
        np.float32)
    nf = len(s_all)
    vu, oj = np.float32(vu), np.float32(oj)
    delta = s_all[0]
    back = np.zeros((nf, k + 1), np.int64)
    for t in range(1, nf):
        fp, fn_ = f_all[t - 1][:, None], f_all[t][None, :]
        pv, nv = fp > 0, fn_ > 0
        jump = oj * np.abs(np.log2(np.maximum(fp, np.float32(1e-6))
                                   / np.maximum(fn_, np.float32(1e-6))))
        cost = np.where(pv & nv, jump, np.where(pv ^ nv, vu, np.float32(0)))
        scores = delta[:, None] - cost.astype(np.float32)
        back[t] = np.argmax(scores, axis=0)
        delta = s_all[t] + np.max(scores, axis=0)
    path = np.zeros(nf, np.int64)
    path[-1] = int(np.argmax(delta))
    for t in range(nf - 1, 0, -1):
        path[t - 1] = back[t][path[t]]
    return f_all[np.arange(nf), path], path


def _jax_viterbi_inputs(y):
    """goofer_tpu's candidates and unvoiced strengths of one signal, as
    NumPy float32."""
    cfg = j_pitch.PitchConfig()
    n = len(y)
    wlen = min(j_pitch.pitch_window_len(SR, cfg), max(16, n))
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    _, starts, _ = j_pitch._frame_grid(n, SR, DT, wlen)
    freqs, strengths, local_peak = j_pitch._candidates(
        jnp.asarray(y), float(SR), wlen, nfft, cfg, jnp.asarray(starts), HOP)
    gp = max(float(np.max(np.abs(y))), 1e-12)
    uv = cfg.voicing_threshold + np.maximum(
        0.0, 2.0 - (np.asarray(local_peak) / gp
                    * (1.0 + cfg.voicing_threshold) / cfg.silence_threshold))
    return (np.asarray(freqs), np.asarray(strengths),
            np.asarray(uv, dtype=np.float32))


@pytest.fixture(scope="module")
def jax_inputs():
    return {name: _jax_viterbi_inputs(y) for name, y in SIGNALS.items()}


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_viterbi_plain_vs_sequential_and_jax(jax_inputs, name):
    freqs, strengths, uv = jax_inputs[name]
    vu, oj = pitch.transition_costs(pitch.PitchConfig(), DT)
    nf = torch.tensor([len(uv)], dtype=torch.int32)
    f0, path = pitch.viterbi_plain(_t(freqs)[None], _t(strengths)[None],
                                   _t(uv)[None], nf, vu, oj)
    want_f0, want_path = _viterbi_f32(freqs, strengths, uv, vu, oj)
    assert np.array_equal(path[0].numpy(), want_path)
    assert np.array_equal(f0[0].numpy(), want_f0)
    # the float64-cost restatement of tests/test_analysis.py and JAX's
    # parallel-prefix solve: equal away from exact score ties
    dt_ratio = np.float32(DT / 0.01)
    seq = _viterbi_np(freqs, strengths, uv, j_pitch.PitchConfig(),
                      float(dt_ratio))
    assert np.mean(f0[0].numpy() == seq) >= 0.98
    par = np.asarray(j_pitch._viterbi(
        jnp.asarray(freqs), jnp.asarray(strengths), jnp.asarray(uv),
        j_pitch.PitchConfig(), dt_ratio))
    assert np.mean(f0[0].numpy() == par) >= 0.98


def test_viterbi_plain_ragged_batch_equals_rows_alone(jax_inputs):
    """Rows padded past their true frame counts (the padding holds
    another signal's candidates, not zeros) equal the unpadded solves
    exactly on true frames, and are 0 / -1 past them."""
    names = sorted(SIGNALS)
    vu, oj = pitch.transition_costs(pitch.PitchConfig(), DT)
    full = len(jax_inputs[names[0]][2])
    counts = [full, 1, 37, full - 5]
    rows = []
    for name, nf in zip(names, counts):
        f, s, u = jax_inputs[name]
        junk = jax_inputs[names[-1]]
        rows.append((np.concatenate([f[:nf], junk[0][nf:]]),
                     np.concatenate([s[:nf], junk[1][nf:]]),
                     np.concatenate([u[:nf], junk[2][nf:]])))
    f0, path = pitch.viterbi_plain(
        *(_t(np.stack([r[i] for r in rows])) for i in range(3)),
        torch.tensor(counts, dtype=torch.int32), vu, oj)
    for j, (name, nf) in enumerate(zip(names, counts)):
        f, s, u = jax_inputs[name]
        want_f0, want_path = _viterbi_f32(f[:nf], s[:nf], u[:nf], vu, oj)
        assert np.array_equal(f0[j, :nf].numpy(), want_f0), name
        assert np.array_equal(path[j, :nf].numpy(), want_path), name
        assert (f0[j, nf:] == 0).all() and (path[j, nf:] == -1).all()


def test_viterbi_single_frame_picks_the_strongest():
    freqs = _t([[[100.0, 200.0, 300.0]], [[100.0, 200.0, 300.0]]])
    strengths = _t([[[0.2, 0.9, 0.1]], [[0.2, 0.3, 0.1]]])
    uv = _t([[0.45], [0.45]])
    nf = torch.ones(2, dtype=torch.int32)
    f0, path = pitch.viterbi_plain(freqs, strengths, uv, nf, 0.1, 0.2)
    assert f0[:, 0].tolist() == [200.0, 0.0] and path[:, 0].tolist() == [1, 3]


@pytest.mark.parametrize("name", ["vibrato", "onset"])
def test_pitch_graph_tracks_like_jax(name):
    y = SIGNALS[name]
    got = pitch.track_pitch(y, SR, DT, device="cpu")
    want = j_pitch.track_pitch(jnp.asarray(y), SR, DT)
    assert got.shape == want.shape and got.dtype == np.float32
    close = np.abs(got - want) <= 1e-3 * np.maximum(want, 1.0)
    assert close.mean() >= 0.98, close.mean()


def test_pitch_graph_padded_rows_equal_signals_alone():
    """Two signals of different lengths zero-padded into one batch, each
    with the frame grid of its true length."""
    cfg = pitch.PitchConfig()
    ys = [SIGNALS["glide"], SIGNALS["onset"][:17000]]
    grids = [pitch._frame_grid(len(y), SR, DT, min(
        pitch.pitch_window_len(SR, cfg), max(16, len(y)))) for y in ys]
    starts, nf = pitch.padded_grid(grids, 130)
    yb = np.zeros((2, 36000), np.float32)
    for j, y in enumerate(ys):
        yb[j, :len(y)] = y
    got = pitch.pitch_graph(_t(yb), SR, DT, cfg, _t(starts), _t(nf)).numpy()
    for j, y in enumerate(ys):
        alone = pitch.track_pitch(y, SR, DT, device="cpu")
        assert np.array_equal(got[j, :nf[j]], alone)
        assert (got[j, nf[j]:] == 0).all()


# ----------------------------------------------------------------- gap fill

@pytest.mark.parametrize("case", ["short_gaps", "edge_gaps", "random"])
def test_fix_f0_gaps_equals_jax(case):
    if case == "short_gaps":
        f0 = np.array([100, 100, 0, 0, 120, 120, 0, 0, 0, 0, 0, 130, 0, 0],
                      dtype=np.float32)
    elif case == "edge_gaps":
        f0 = np.array([0, 0, 100, 100, 0], dtype=np.float32)
    else:
        rng = np.random.default_rng(7)
        f0 = rng.uniform(80, 400, 300).astype(np.float32)
        f0[rng.random(300) < 0.45] = 0.0
    for max_gap in (2, 4):
        got = pitch.fix_f0_gaps(_t(f0), max_gap=max_gap).numpy()
        want = np.asarray(j_pitch.fix_f0_gaps(jnp.asarray(f0),
                                              max_gap=max_gap))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    batched = pitch.fix_f0_gaps(_t(np.stack([f0, f0[::-1].copy()])), 4)
    assert np.array_equal(batched[0].numpy(),
                          pitch.fix_f0_gaps(_t(f0), 4).numpy())


# ------------------------------------------------------------ Burg and roots

def _burg_f64(frames, order):
    """Burg's recursion in NumPy float64, frame by frame."""
    out = np.zeros((len(frames), order + 1))
    for r, x in enumerate(np.asarray(frames, np.float64)):
        f, b = x.copy(), x.copy()
        a = np.zeros(order + 1)
        a[0] = 1.0
        for m in range(1, order + 1):
            ff, bb = f[m:], b[m - 1:-1]
            k = -2.0 * np.dot(ff, bb) / max(np.dot(ff, ff) + np.dot(bb, bb),
                                            1e-20)
            f[m:], b[m:] = ff + k * bb, bb + k * ff
            a[:m + 1] = a[:m + 1] + k * a[:m + 1][::-1]
        out[r] = a
    return out


@pytest.fixture(scope="module")
def ref_frames(ref_wave):
    """The windowed Burg frames of the reference source, (F, 551)."""
    frames, sr2 = formants.lpc_frames(_t(ref_wave)[None], SR, DT)
    assert sr2 == 11025.0 and frames.shape[-1] == 551
    return frames[0]


@pytest.mark.parametrize("order", [8, 10, 12])
def test_burg_coeffs_vs_jax_and_float64(ref_frames, order):
    got = formants.burg_coeffs_plain(ref_frames, order).numpy()
    want = np.asarray(j_formants._burg_coeffs(
        jnp.asarray(ref_frames.numpy()), order, ref_frames.shape[1]))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    exact = _burg_f64(ref_frames.numpy(), order)
    np.testing.assert_allclose(got, exact, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(want, exact, rtol=1e-3, atol=1e-4)
    assert (got[:, 0] == 1).all()


def test_burg_coeffs_silent_frame():
    a = formants.burg_coeffs_plain(torch.zeros((2, 64)), 6)
    assert a.tolist() == [[1.0] + [0.0] * 6] * 2


def _keyed(arr):
    return sorted(arr, key=lambda z: (round(z.real, 4), round(z.imag, 4)))


def test_durand_kerner_known_roots():
    # (z-0.5)(z-2)(z^2+1) = z^4 -2.5 z^3 + 2 z^2 -2.5 z + 1
    c = _t([[1.0, -2.5, 2.0, -2.5, 1.0]])
    roots = formants.poly_roots_dk_plain(c)
    assert roots.shape == (1, 4) and roots.dtype == torch.complex64
    np.testing.assert_allclose(_keyed(roots[0].numpy()),
                               _keyed(np.array([0.5, 2.0, 1j, -1j])),
                               rtol=1e-3, atol=1e-3)
    want = np.asarray(j_formants._poly_roots_dk(jnp.asarray(c.numpy()), 4))
    np.testing.assert_allclose(roots.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("order", [8, 10, 12])
def test_durand_kerner_real_frames_match_jax(ref_frames, order):
    a = formants.burg_coeffs_plain(ref_frames, order)
    got = formants.poly_roots_dk_plain(a)
    want = np.asarray(j_formants._poly_roots_dk(jnp.asarray(a.numpy()),
                                                order))
    conv = formants.converged_roots(a, got).all(dim=1).numpy()
    assert conv.mean() > 0.9
    # root k starts from the same point in both and is iterated alike
    assert np.abs(got.numpy() - want)[conv].max() <= 1e-4


# ------------------------------------------------- the kernels' layouts
# The two LPC kernels' decompositions, restated on the CPU with the
# lanes as a tensor axis: what their index arithmetic does is held to the
# plain versions here, where the CUDA sources cannot run.

def _roots_warp_model(coeffs, iters=60):
    """csrc/lpc_roots.cu's lanes: floor(32 / order) rows per warp, lane
    r * order + k iterating root k of the warp's row r against roots
    read from lanes r * order + j (mod 32, as a shuffle reads); lanes
    past the warp's rows iterate row 0's copy and store nothing."""
    rows, order = coeffs.shape[0], coeffs.shape[1] - 1
    per_warp = 32 // order
    first = torch.arange(-(-rows // per_warp)) * per_warp
    lane = torch.arange(32)
    r, k = lane // order, lane % order
    row = first[:, None] + r[None]
    live = (r[None] < per_warp) & (row < rows)
    c = coeffs[torch.where(live, row, first[:, None])].to(torch.complex64)
    z0 = 0.9 * np.exp(2j * np.pi * (k.numpy() + 0.25) / order)
    z = torch.as_tensor(z0.astype(np.complex64)).expand(len(first), 32)
    tiny = torch.tensor(1e-20, dtype=torch.complex64)
    for _ in range(iters):
        p = torch.zeros_like(z) + c[..., 0]
        for i in range(1, order + 1):
            p = p * z + c[..., i]
        d = None
        for j in range(order):
            fac = z - z[:, (r * order + j) % 32] + (k == j)
            d = fac if d is None else d * fac
        z = z - p / torch.where(d.abs() < 1e-20, tiny, d)
    out = torch.full((rows, order), complex("nan"), dtype=torch.complex64)
    out[row[live], k.expand_as(live)[live]] = z[live]
    return out


@pytest.mark.parametrize("order,rows", [(10, 7), (10, 3), (11, 5), (16, 3),
                                        (17, 2), (32, 2), (1, 40), (3, 23)])
def test_roots_warp_layout_model(order, rows):
    """Rows packed per warp equal the plain version's; a NaN row and an
    all-zero polynomial (z^order) among them stay in their own lanes."""
    rng = np.random.default_rng(order * 100 + rows)
    coeffs = np.ones((rows, order + 1), np.float32)
    coeffs[:, 1:] = rng.uniform(-0.5, 0.5, (rows, order)) / order
    coeffs[rows // 2, 1:] = 0.0
    coeffs[rows - 1, 1] = np.nan
    a = _t(coeffs)
    got = torch.view_as_real(_roots_warp_model(a))
    want = torch.view_as_real(formants.poly_roots_dk_plain(a))
    assert torch.isnan(want[rows - 1]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5,
                               equal_nan=True)


def _burg_stretch(wlen):
    """csrc/burg_lpc.cu's samples per lane: the shortest even stretch up
    to 36 (registers), else ceil(wlen / 32) (shared memory)."""
    need = -(-wlen // 32)
    return need + need % 2 if need <= 36 else need


def _burg_warp_model(frames, order):
    """csrc/burg_lpc.cu's warp per frame: the frame right-aligned in 32
    lanes' stretches, per-lane sums of the live samples, an xor
    butterfly, the unmasked update in place, a[i] += k a[m - i] by lane
    with a[32] = 0 at lane 0, m = 32, and the last k as a[32]."""
    rows, wlen = frames.shape
    length = _burg_stretch(wlen)
    pad = 32 * length - wlen
    f = torch.nn.functional.pad(frames, (pad, 0)).reshape(rows, 32, length)
    b = f.clone()
    lane = torch.arange(32)
    first = lane * length - pad
    a = (lane == 0).float().expand(rows, 32).clone()
    k = torch.zeros(rows, 1)
    for m in range(1, order + 1):
        b_in = torch.cat([b[:, :1, -1], b[:, :-1, -1]], dim=1)
        b_prev = torch.cat([b_in[..., None], b[..., :-1]], dim=2)
        live = (torch.arange(length)[None] >= (m - first)[:, None]).float()
        num = (f * b_prev * live).sum(dim=2)
        den = ((f * f + b_prev * b_prev) * live).sum(dim=2)
        for off in (16, 8, 4, 2, 1):
            num, den = num + num[:, lane ^ off], den + den[:, lane ^ off]
        k = -2.0 * num[:, :1] / torch.clamp(den[:, :1], min=1e-20)
        f, b = f + k[..., None] * b_prev, b_prev + k[..., None] * f
        src = m - lane
        partner = a[:, src % 32]
        a = torch.where((src >= 0) & (src < 32), a + k * partner, a)
    return torch.cat([a, k], dim=1)[:, :order + 1]


@pytest.mark.parametrize("wlen,order", [(551, 10), (32, 32), (5, 10),
                                        (1, 3), (600, 12), (1152, 10),
                                        (1153, 10), (4010, 8), (100, 32)])
def test_burg_warp_layout_model(wlen, order):
    """The warp-per-frame decomposition against the plain version (rtol
    1e-3 / atol 1e-4: other orders of the sums), at stretches on both
    sides of the register / shared-memory boundary, with wlen < order, at
    order 32 (the 33rd coefficient) and with a silent frame."""
    rng = np.random.default_rng(wlen + order)
    x = rng.standard_normal((4, wlen + 2))
    x = x[:, 2:] + 1.6 * x[:, 1:-1] - 0.9 * x[:, :-2]
    t = np.linspace(-1, 1, wlen)
    frames = _t((x * np.exp(-12 * t * t)).astype(np.float32))
    frames[2] = 0.0
    got = _burg_warp_model(frames, order)
    want = formants.burg_coeffs_plain(frames, order)
    assert (got[:, 0] == 1).all()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    assert _burg_stretch(wlen) <= 36 or wlen > 1152


@pytest.mark.parametrize("source", ["vowel", "ref"])
def test_formant_graph_matches_jax(source, ref_wave):
    y = (ref_wave if source == "ref"
         else _vowel(120.0, [700.0, 1220.0, 2600.0], [80.0, 90.0, 120.0]))
    got = formants.track_formants(y, SR, DT, device="cpu")
    want = j_formants.track_formants(jnp.asarray(y), SR, DT)
    assert got.shape == want.shape and got.shape[0] == 5
    close = np.abs(got - want) <= 1.0
    assert close.mean() >= 0.99, close.mean()
    # what is left sits at a gate: dropped (0) in one of the two, or within
    # a few Hz of 50 Hz or of Nyquist - 50 Hz
    rest = np.stack([got[~close], want[~close]])
    assert ((rest == 0).any(0) | (rest.min(0) < 60.0)
            | (rest.max(0) > 11025 / 2 - 60.0)).all()
    assert formants.track_formants(y, SR, DT, target_frames=500,
                                   device="cpu").shape == (5, 500)


def test_formant_graph_all_zero_signal_is_finite():
    tracks = formants.track_formants(np.zeros(SR // 4, np.float32), SR, DT,
                                     device="cpu")
    assert np.isfinite(tracks).all()


def test_decimate_matches_jax(ref_wave):
    got, sr2 = formants._decimate(_t(ref_wave)[None], float(SR), 4)
    want, sr2_j = j_formants._decimate(jnp.asarray(ref_wave), float(SR), 4)
    assert sr2 == sr2_j == 11025.0 and got.shape[1] == want.shape[0]
    # a direct 127-tap sum against an FFT convolution, float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-6)
    # a padded row holding its last true sample decimates like the file
    n = len(ref_wave)
    padded = np.concatenate([ref_wave, np.zeros(3000, np.float32)])
    held, _ = formants._decimate(_t(padded)[None], float(SR), 4,
                                 torch.tensor([n]))
    assert np.array_equal(held[0, :got.shape[1]].numpy(), got[0].numpy())


# -------------------------------------------------------------- knot codec

@pytest.fixture(scope="module")
def ref_env(ref_wave):
    from goofer_tpu_torch.ops.filters import gaussian_blur1d
    from goofer_tpu_torch.ops.stft import stft

    mag = stft(_t(ref_wave), 1024, HOP).abs() + 1e-8
    return gaussian_blur1d(mag, 2.0, axis=0).numpy()


def test_knot_bin_idx_and_errors_match_jax(ref_env):
    for k in envelope.KNOT_K_VALUES:
        np.testing.assert_array_equal(
            envelope._knot_bin_idx(SR, 1024, k, 513),
            j_envelope._knot_bin_idx(SR, 1024, k, 513))
    errs, log_env, ks = envelope.knot_errors(_t(ref_env), SR, 1024)
    errs_j, log_j, ks_j = j_envelope._knot_errors(jnp.asarray(ref_env), SR,
                                                  1024)
    assert list(ks) == list(ks_j)
    np.testing.assert_allclose(errs.numpy(), np.asarray(errs_j), rtol=1e-4)
    np.testing.assert_allclose(log_env.numpy(), np.asarray(log_j), atol=1e-5)


def test_knot_errors_batched_check_columns(ref_env):
    """A batch row with fewer true frames than its padding takes its own
    check columns."""
    t = ref_env.shape[1]
    pad = np.concatenate([ref_env, np.full((513, 9), 1e-8, np.float32)], 1)
    cols = np.linspace(0, t - 1, min(256, t)).astype(np.int64)
    errs_b, _, _ = envelope.knot_errors(_t(np.stack([pad, pad])), SR, 1024,
                                        check_idx=_t(np.stack([cols, cols])))
    errs, _, _ = envelope.knot_errors(_t(ref_env), SR, 1024)
    np.testing.assert_allclose(errs_b[0].numpy(), errs.numpy(), rtol=1e-6)
    assert np.array_equal(errs_b[0].numpy(), errs_b[1].numpy())


@pytest.mark.parametrize("smooth", [False, True])
def test_compress_env_to_knots_matches_jax(ref_env, smooth):
    env = ref_env
    if smooth:     # a smooth envelope meets the budget at a small K
        bins = np.arange(513)[:, None]
        env = (np.exp(-bins / 150.0) * (1.0 + 0.3 * np.sin(bins / 40.0))
               * np.ones((1, 20))).astype(np.float32)
    got = envelope.compress_env_to_knots(env, SR, 1024)
    want = j_envelope.compress_env_to_knots(jnp.asarray(env), SR, 1024)
    assert got["knot_vals_log"].shape == want["knot_vals_log"].shape
    assert got["knot_vals_log"].dtype == np.float16
    assert smooth == (got["knot_vals_log"].shape[0] < 192)
    a = got["knot_vals_log"].astype(np.float32)
    b = np.asarray(want["knot_vals_log"]).astype(np.float32)
    step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    assert (np.abs(a - b) <= step.astype(np.float32)).all()
    np.testing.assert_array_equal(got["hz_knots"], want["hz_knots"])
    assert {k: got[k] for k in ("mode", "n_bins", "n_fft", "sr")} == {
        k: want[k] for k in ("mode", "n_bins", "n_fft", "sr")}
    # decode of the port's knots is goofer_tpu's decode
    dec = envelope.decode_env_from_knots(_t(a), SR, 1024, 513).numpy()
    dec_j = np.asarray(j_envelope.decode_env_from_knots(
        jnp.asarray(a), SR, 1024, 513))
    np.testing.assert_allclose(dec, dec_j, rtol=1e-5)


# ----------------------------------------------------------------- wrappers

def _viterbi_args(device="cpu"):
    freqs = torch.full((2, 5, 3), 200.0, device=device)
    return (freqs, torch.full((2, 5, 3), 0.5, device=device),
            torch.full((2, 5), 0.45, device=device),
            torch.full((2,), 5, dtype=torch.int32, device=device), 0.1, 0.2)


WRAPPERS = {
    "viterbi": (viterbi_kernel, lambda m: m.pitch_viterbi, _viterbi_args),
    "roots": (lpc_roots_kernel, lambda m: m.lpc_roots,
              lambda device="cpu": (torch.ones((4, 11), device=device),)),
    "burg": (burg_kernel, lambda m: m.burg_lpc,
             lambda device="cpu": (torch.ones((4, 64), device=device), 10)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_cpu_runs_plain(name):
    module, fn, args = WRAPPERS[name]
    before = fn(module).launches
    out = fn(module)(*args())
    plain = {"viterbi": pitch.viterbi_plain,
             "roots": formants.poly_roots_dk_plain,
             "burg": formants.burg_coeffs_plain}[name](*args())
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(torch.view_as_real(a) if a.is_complex() else a,
                           torch.view_as_real(b) if b.is_complex() else b)
    assert fn(module).launches == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_never_falls_back(name, monkeypatch, tmp_path):
    """A CUDA tensor with no buildable kernel raises: it does not take the
    plain version (meta tensors stand in for CUDA ones)."""
    module, fn, args = WRAPPERS[name]

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(module.KERNEL, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(module, "_check_inputs", lambda *a: None)
    before = fn(module).launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(module)(*args("meta"))
    assert fn(module).launches == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_rejects_other_devices(name):
    module, fn, args = WRAPPERS[name]
    with pytest.raises(ValueError, match="expected"):
        fn(module)(*args("meta"))
