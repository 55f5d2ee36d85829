"""The port's native codecs (goofer_tpu_torch.native) against goofer_tpu's
(goofer_tpu.native), case by case after tests/test_native.py,
tests/test_sndcodec.py and tests/test_mp3.py: the same files decode to
bit-equal float32 arrays at equal sample rates, every corrupt or fuzzed
stream raises in both, and the port builds its libraries under
build/goofer_tpu_torch/, never into the package."""
import pytest

torch = pytest.importorskip("torch")

import ctypes  # noqa: E402
import struct  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from goofer_tpu import native as j_native  # noqa: E402
from goofer_tpu.utils import audio_io as j_audio_io  # noqa: E402
from goofer_tpu_torch import native  # noqa: E402
from goofer_tpu_torch.ops.cuda import _build  # noqa: E402
from goofer_tpu_torch.utils import audio_io  # noqa: E402
from tests.flac_writer import write_flac  # noqa: E402

SR = 44100
PACKAGE = Path(native.__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def reference_decoder_outside_tree(tmp_path_factory):
    """goofer_tpu builds its FLAC/AIFF decoder beside its source when the
    library there looks stale; point it at a temporary file, so that
    these tests never rewrite the tracked goofer_tpu/native/_sndcodec.so."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_SND_SO",
                   tmp_path_factory.mktemp("ref") / "_sndcodec.so")
        mp.setattr(j_native, "_snd_lib", None)
        yield


def _walk(rng, n, scale=400, bps=16, ch=None):
    """Random-walk int signal (tests/test_sndcodec.py:_walk)."""
    shape = (n,) if ch is None else (n, ch)
    x = np.cumsum(rng.integers(-scale, scale + 1, size=shape), axis=0)
    lim = (1 << (bps - 1)) - 1
    return np.clip(x, -lim, lim).astype(np.int64)


def _expect(samples, bps):
    return np.asarray(samples, np.float64) / float(1 << (bps - 1))


def _decode_both(kind, path):
    """read_<kind> of both packages: (data, sr), or the OSError class."""
    out = []
    for mod in (native, j_native):
        try:
            out.append(getattr(mod, f"read_{kind}")(path))
        except OSError:
            out.append(OSError)
    return out


def _same_decode(kind, path):
    """Both decode ``path`` bit-equal (returns the port's (data, sr)) or
    both raise (returns None)."""
    ours, theirs = _decode_both(kind, path)
    if theirs is OSError or ours is OSError:
        assert ours is theirs is OSError, (ours, theirs)
        return None
    assert ours[1] == theirs[1]
    assert ours[0].dtype == theirs[0].dtype == np.float32
    assert ours[0].shape == theirs[0].shape
    assert ours[0].tobytes() == theirs[0].tobytes()
    return ours


def _write_aiff(path, x, sr, sampwidth, ch=1, force_aiff=False):
    """tests/test_sndcodec.py:_write_aiff through the stdlib writer."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc
    f = aifc.open(str(path), "wb")
    if force_aiff:
        f.aiff()
    f.setnchannels(ch)
    f.setsampwidth(sampwidth)
    f.setframerate(sr)
    raw = bytearray()
    for v in np.asarray(x).reshape(-1):
        raw += int(v).to_bytes(sampwidth, "big", signed=True)
    f.writeframes(bytes(raw))
    f.close()


# ------------------------------------------------------------- the build

def test_libraries_build_outside_the_package():
    for lib, src in ((native.load(), native.WAV_SRC),
                     (native.load_snd(), native.SND_SRC)):
        path = Path(lib._name).resolve()
        assert path.parent == _build.BUILD_DIR.resolve()
        assert path == _build.library_path(src, native.GXX_FLAGS).resolve()
    assert not list(PACKAGE.rglob("*.so"))
    for name in ("wavcodec.cpp", "sndcodec.cpp"):
        ours = (_build.CSRC / name).read_bytes()
        assert ours == (Path(j_native.__file__).parent / name).read_bytes()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        native.build(bad)
    assert not list((tmp_path / "build").glob("*"))


# ----------------------------------------------- WAV (tests/test_native.py)

@pytest.mark.parametrize("shape,sr", [((5000,), 44100), ((2000, 2), 22050)])
def test_wav_roundtrip_equal(tmp_path, shape, sr):
    rng = np.random.default_rng(13)
    y = rng.uniform(-0.9, 0.9, size=shape).astype(np.float32)
    ours, theirs = tmp_path / "o.wav", tmp_path / "t.wav"
    native.write_wav(ours, y, sr)
    j_native.write_wav(theirs, y, sr)
    assert ours.read_bytes() == theirs.read_bytes()
    got, got_sr = _same_decode("wav", ours)
    assert got_sr == sr and got.shape == shape
    np.testing.assert_allclose(got, y, atol=1.0 / 32768 + 1e-6)


def _riff(path, fmt_code, bits, payload, sr, extra=b""):
    """tests/test_native.py:_write_wav_raw, with chunks before data."""
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(extra) + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, 1, sr,
                            sr * bits // 8, bits // 8, bits))
        f.write(extra + b"data" + struct.pack("<I", len(payload)) + payload)


@pytest.mark.parametrize("case", ["float32", "pcm24", "extra_chunks"])
def test_wav_subformats_equal(tmp_path, case):
    y = np.random.default_rng(13).uniform(-0.5, 0.5, 300).astype(np.float32)
    p = tmp_path / f"{case}.wav"
    if case == "float32":
        _riff(p, 3, 32, y.tobytes(), 48000)
        atol = 1e-7
    elif case == "pcm24":
        ints = (y * 8388608.0).astype(np.int32)
        _riff(p, 1, 24, b"".join(struct.pack("<i", v)[:3] for v in ints),
              32000)
        atol = 2.0 / 8388608
    else:
        pcm = (np.clip(y, -1, 32767 / 32768) * 32768).astype(np.int16)
        _riff(p, 1, 16, pcm.tobytes(), 44100,
              extra=b"LIST" + struct.pack("<I", 6) + b"INFOxx")
        atol = 1.0 / 32768
    got, _ = _same_decode("wav", p)
    np.testing.assert_allclose(got, y, atol=atol)


def test_wav_corrupt_raises_in_both(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFnope")
    assert _same_decode("wav", bad) is None
    assert _same_decode("wav", tmp_path / "missing.wav") is None


# --------------------------------------------- FLAC (tests/test_sndcodec.py)

def _flac_case(name):
    """(samples, bps, sr, write_flac keywords) of one decoder path."""
    rng = np.random.default_rng(11)
    if name == "constant":
        return np.full(1000, -12345, np.int64), 16, SR, dict(mode="constant")
    if name == "verbatim":
        return _walk(rng, 1000), 16, SR, dict(mode="verbatim")
    if name.startswith("fixed"):
        return _walk(rng, 1000), 16, SR, dict(mode="fixed",
                                              order=int(name[-1]))
    if name == "lpc2":
        return _walk(rng, 1000), 16, SR, dict(
            mode="lpc", lpc_coefs=[1024, -512], lpc_shift=9,
            lpc_precision=12)
    if name == "lpc4":
        return _walk(rng, 1000), 16, SR, dict(
            mode="lpc", lpc_coefs=[700, 300, -150, 75], lpc_shift=10,
            lpc_precision=11)
    if name.startswith("stereo_"):
        x = _walk(rng, 700, ch=2)
        x[:, 1] = x[:, 0] + _walk(rng, 700, scale=60)
        x = np.clip(x, -(1 << 15) + 1, (1 << 15) - 1)
        return x, 16, SR, dict(mode="fixed", order=2,
                               channel_mode=name[len("stereo_"):])
    if name == "rice2_escape":
        return _walk(rng, 1024), 16, SR, dict(
            blocksize=512, mode="fixed", order=1, porder=3, method=1,
            escape_partitions=(0, 5))
    if name == "wasted_bits":
        return _walk(rng, 600, scale=100) << 3, 16, SR, dict(
            mode="fixed", order=2, wasted=3)
    if name == "bps24_short_last_frame":
        return _walk(rng, 777, scale=50_000, bps=24), 24, 48000, dict(
            mode="fixed", order=2)
    if name == "multibyte_utf8":
        return _walk(rng, 192 * 140 + 17, scale=30), 16, SR, dict(
            blocksize=192, mode="fixed", order=1)
    raise KeyError(name)


FLAC_CASES = ["constant", "verbatim", "fixed0", "fixed1", "fixed2",
              "fixed3", "fixed4", "lpc2", "lpc4", "stereo_indep",
              "stereo_left_side", "stereo_right_side", "stereo_mid_side",
              "rice2_escape", "wasted_bits", "bps24_short_last_frame",
              "multibyte_utf8"]


@pytest.mark.parametrize("name", FLAC_CASES)
def test_flac_decodes_bit_equal(tmp_path, name):
    x, bps, sr, kw = _flac_case(name)
    kw = {"blocksize": 256, **kw}
    p = tmp_path / "t.flac"
    write_flac(p, x, sr, bps=bps, **kw)
    data, got_sr = _same_decode("flac", p)
    assert got_sr == sr and data.shape == x.shape
    np.testing.assert_array_equal(data.astype(np.float64), _expect(x, bps))


def test_flac_info_and_corrupt(tmp_path):
    p = tmp_path / "i.flac"
    write_flac(p, _walk(np.random.default_rng(2), 300), 32000, bps=16,
               blocksize=128, mode="verbatim")
    data, sr = _same_decode("flac", p)
    assert sr == 32000 and len(data) == 300
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaX" + b"\x00" * 64)
    assert _same_decode("flac", bad) is None
    assert _same_decode("flac", tmp_path / "missing.flac") is None


def test_flac_truncated_at_frame_boundary_trims(tmp_path):
    """STREAMINFO promises 2n samples, the frames carry n: both trim to
    the decoded samples."""
    p = tmp_path / "t.flac"
    n = 1024
    x = _walk(np.random.default_rng(3), n)
    write_flac(p, x, SR, bps=16, blocksize=256, mode="fixed", order=1)
    raw = bytearray(p.read_bytes())
    total = 2 * n
    raw[8 + 13] = (raw[8 + 13] & 0xF0) | ((total >> 32) & 0xF)
    raw[8 + 14: 8 + 18] = (total & 0xFFFFFFFF).to_bytes(4, "big")
    p.write_bytes(bytes(raw))
    data, sr = _same_decode("flac", p)
    assert sr == SR and data.shape == (n,)
    np.testing.assert_array_equal(data.astype(np.float64), _expect(x, 16))


def _fuzz_base(kind, path):
    rng = np.random.default_rng(5)
    if kind == "flac":
        write_flac(path, _walk(rng, 4000), SR, bps=16, blocksize=512,
                   mode="fixed", order=2)
    else:
        _write_aiff(path, _walk(rng, 2000), SR, 2, force_aiff=True)


@pytest.mark.parametrize("kind", ["flac", "aiff"])
def test_decoders_agree_on_fuzzed_streams(tmp_path, kind):
    """200 seeded truncations and byte flips (tests/test_sndcodec.py's
    no-crash contract): each mutation raises in both packages or decodes
    bit-equal in both."""
    base = tmp_path / f"f.{kind}"
    _fuzz_base(kind, base)
    raw = bytearray(base.read_bytes())
    rng = np.random.default_rng(99 if kind == "flac" else 7)
    mut = tmp_path / f"mut.{kind}"
    errors = 0
    for i in range(200):
        buf = bytearray(raw)
        if i % 3 == 0:
            buf = buf[: rng.integers(4, len(buf))]
        else:
            for _ in range(int(rng.integers(1, 9))):
                buf[int(rng.integers(0, len(buf)))] = int(
                    rng.integers(0, 256))
        mut.write_bytes(bytes(buf))
        errors += _same_decode(kind, mut) is None
    assert 0 < errors < 200


# --------------------------------------------- AIFF (tests/test_sndcodec.py)

@pytest.mark.parametrize("sampwidth,force_aiff,ch", [
    (2, True, 1), (2, False, 1), (3, True, 1), (1, True, 1), (2, True, 2)])
def test_aiff_decodes_bit_equal(tmp_path, sampwidth, force_aiff, ch):
    bps = 8 * sampwidth
    x = _walk(np.random.default_rng(4), 500, scale=1 << (bps - 6), bps=bps,
              ch=None if ch == 1 else ch)
    p = tmp_path / ("t.aiff" if ch == 1 else "s.aif")
    _write_aiff(p, x, 22050, sampwidth, ch=ch, force_aiff=force_aiff)
    data, sr = _same_decode("aiff", p)
    assert sr == 22050 and data.shape == x.shape
    np.testing.assert_array_equal(data.astype(np.float64), _expect(x, bps))


def test_aiff_unsupported_bit_depth_raises_in_both(tmp_path):
    def chunk(cid, body):
        return cid + struct.pack(">I", len(body)) + body \
            + (b"\x00" if len(body) % 2 else b"")

    comm = struct.pack(">hIh", 1, 10, 4) + bytes.fromhex(
        "400EAC44000000000000")                # 44100 as 80-bit extended
    ssnd = struct.pack(">II", 0, 0) + b"\x00" * 20
    body = b"AIFF" + chunk(b"COMM", comm) + chunk(b"SSND", ssnd)
    p = tmp_path / "w.aiff"
    p.write_bytes(b"FORM" + struct.pack(">I", len(body)) + body)
    assert _same_decode("aiff", p) is None


# ------------------------------------------------- MP3 (tests/test_mp3.py)

@pytest.fixture(scope="module")
def mp3():
    """The MP3 cases need the system libmpg123 (decoder) and libmp3lame
    (tests/mp3_writer.py); they skip without either."""
    for name in ("libmpg123.so.0", "libmp3lame.so.0"):
        try:
            ctypes.CDLL(name)
        except OSError:
            pytest.skip(f"{name} is not installed")
    from tests.mp3_writer import write_mp3

    return write_mp3


def _tone(f0, n, amp=0.4):
    return amp * np.sin(2 * np.pi * f0 * np.arange(n) / SR)


def _pitch_hz(seg):
    ac = np.correlate(seg, seg, "full")[len(seg) - 1:]
    lo, hi = int(SR / 500), int(SR / 100)
    return SR / (lo + int(np.argmax(ac[lo:hi])))


@pytest.mark.parametrize("channels", [1, 2])
def test_mp3_decodes_bit_equal(tmp_path, mp3, channels):
    n = SR // 2
    ref = (_tone(220.0, n) if channels == 1
           else np.stack([_tone(220.0, n), _tone(330.0, n)], axis=1))
    p = tmp_path / "t.mp3"
    mp3(p, ref, SR)
    data, sr = _same_decode("mp3", p)
    assert sr == SR and len(data) >= n         # codec delay and padding
    assert data.ndim == channels
    for c, f0 in enumerate((220.0, 330.0)[:channels]):
        seg = data[4000: n - 2000] if channels == 1 else data[4000:n - 2000, c]
        assert abs(_pitch_hz(seg) - f0) < 6.0


def test_mp3_garbage_raises_in_both(tmp_path, mp3):
    p = tmp_path / "bad.mp3"
    p.write_bytes(b"\x00\x01garbage" * 50)
    assert _same_decode("mp3", p) is None
    with pytest.raises(RuntimeError, match="soundfile"):
        audio_io.read_wav(p)


# ------------------------------------------------------- audio_io routing

def test_audio_io_reads_every_format_as_goofer_tpu(tmp_path, mp3):
    """read_wav_mono of a WAV, a mid-side FLAC, an AIFF and an MP3: the
    same float64 arrays as goofer_tpu's."""
    x = _walk(np.random.default_rng(6), 900, ch=2)
    paths = [tmp_path / "v.flac", tmp_path / "v.aiff", tmp_path / "v.mp3",
             tmp_path / "v.wav"]
    write_flac(paths[0], x, SR, bps=16, blocksize=256, mode="fixed",
               order=2, channel_mode="mid_side")
    _write_aiff(paths[1], x[:, 0], SR, 2, force_aiff=True)
    mp3(paths[2], _tone(260.0, SR // 2), SR)
    audio_io.write_wav(paths[3], _expect(x, 16), SR)
    for p in paths:
        ours, sr = audio_io.read_wav_mono(p)
        theirs, sr_j = j_audio_io.read_wav_mono(p)
        assert sr == sr_j == SR and ours.dtype == np.float64
        assert ours.tobytes() == theirs.tobytes(), p.name
    y, _ = audio_io.read_wav_mono(paths[0])
    np.testing.assert_array_equal(y, _expect(x, 16).mean(axis=1))


@pytest.mark.parametrize("name,payload", [
    ("x.mp3", b"\xff\xfb\x90\x00" + b"\x00" * 100),
    ("x.flac", b"fLaX" + b"\x00" * 64),
    ("x.aiff", b"FORM\x00\x00\x00\x04AIFF")])
def test_audio_io_curated_error(tmp_path, name, payload):
    """A file every native decoder rejects raises goofer_tpu's curated
    RuntimeError in both packages."""
    if j_audio_io._sf is not None:
        pytest.skip("soundfile present: goofer_tpu decodes through it")
    p = tmp_path / name
    p.write_bytes(payload)
    for mod in (audio_io, j_audio_io):
        with pytest.raises(RuntimeError, match="soundfile"):
            mod.read_wav(p)


# ------------------------------------------------ a FLAC source end to end

@pytest.fixture(scope="module")
def voice_cut():
    """The first 0.7 s of the vendored voice recording as int16."""
    from scipy.io import wavfile

    sr, pcm = wavfile.read(Path(__file__).parent / "golden" / "voice"
                           / "src.wav")
    return pcm[: int(0.7 * sr)], sr


def _write_source(path, pcm, sr):
    """``pcm`` as a 16-bit WAV, FLAC or AIFF by the suffix of ``path``."""
    if path.suffix == ".wav":
        audio_io.write_wav(path, pcm, sr)
    elif path.suffix == ".flac":
        write_flac(path, pcm.astype(np.int64), sr, bps=16, blocksize=4096,
                   mode="fixed", order=2)
    else:
        _write_aiff(path, pcm, sr, 2, force_aiff=True)


def test_flac_source_renders_as_the_wav(tmp_path, voice_cut, monkeypatch):
    """A note from a FLAC source without a cache (decode, analysis, render
    through the CLI) equals, at int16, the note from the same samples as
    a WAV."""
    from scipy.io import wavfile

    from goofer_tpu_torch import cli

    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    pcm, sr = voice_cut
    outs = []
    for suffix in (".wav", ".flac"):
        d = tmp_path / suffix[1:]
        d.mkdir()
        _write_source(d / f"v{suffix}", pcm, sr)
        out = d / "out.wav"
        assert cli.main([str(d / f"v{suffix}"), str(out), "C4", "100",
                         "t10", "0", "300", "60", "0", "100", "0", "!120",
                         "AA"]) == 0
        assert (d / "v_features.goofy").exists()
        outs.append(wavfile.read(out)[1])
    assert outs[0].dtype == np.int16 and np.abs(outs[0]).max() > 1000
    np.testing.assert_array_equal(outs[0], outs[1])


def test_mixed_folder_extracts_every_audio_file(tmp_path, voice_cut,
                                                monkeypatch):
    """The CLI's folder mode over wav + flac + aiff copies of one
    recording and a file that is not audio: one .goofy per file that
    goofer_tpu's is_audio_file picks, with equal features."""
    from goofer_tpu_torch import cli
    from goofer_tpu_torch.io.goofy import load_features

    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    pcm, sr = voice_cut
    for name in ("a.wav", "b.flac", "c.aiff"):
        _write_source(tmp_path / name, pcm, sr)
    (tmp_path / "notes.txt").write_text("not audio")
    assert cli.main([str(tmp_path)]) == 0
    picked = sorted(p.stem for p in tmp_path.iterdir()
                    if j_audio_io.is_audio_file(p))
    made = sorted(p.name[: -len("_features.goofy")]
                  for p in tmp_path.glob("*_features.goofy"))
    assert made == picked == ["a", "b", "c"]
    feats = [load_features(tmp_path / f"{s}_features.goofy") for s in made]
    for other in feats[1:]:
        np.testing.assert_array_equal(other[0]["knot_vals_log"],
                                      feats[0][0]["knot_vals_log"])
        for i in (1, 2):
            np.testing.assert_array_equal(other[i], feats[0][i])
        assert other[4:] == feats[0][4:] == (sr, len(pcm))
