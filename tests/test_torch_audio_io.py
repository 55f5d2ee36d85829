"""The port's audio I/O against goofer_tpu's: int16 PCM is written as it
is and float input quantized by the native codec (ties away from zero),
file bytes equal; WAV subformats decode to equal arrays; is_audio_file
follows the same five extensions."""
import pytest

torch = pytest.importorskip("torch")

import shutil  # noqa: E402
import struct  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import goofer_tpu.utils.audio_io as j_audio_io  # noqa: E402
from goofer_tpu_torch.sampler.phrase import (  # noqa: E402
    NoteSpec,
    render_phrase_to_wavs,
)
from goofer_tpu_torch.utils.audio_io import (  # noqa: E402
    is_audio_file,
    read_wav,
    write_wav,
)

VOICE = Path(__file__).parent / "golden" / "voice"
TIES = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 100.5]) / 32768
TIES_PCM = [1, 2, 3, -1, -2, -3, 101]
WRITE_CASES = {
    "int16": np.array([0, 1000, -1000, 20000, -32768, 32767], np.int16),
    "float64": np.random.default_rng(3).uniform(-1.2, 1.2, 500),
    "float32_ties": TIES.astype(np.float32),
    "float64_ties": TIES,
    "near_full_scale": np.array([1 - 1e-9, -1 + 1e-9, 32767.5 / 32768,
                                 -32767.5 / 32768, -32768.5 / 32768,
                                 1.0, -1.0], np.float64),
    "stereo": np.stack([TIES, -TIES[::-1]], axis=1).astype(np.float32),
}


@pytest.mark.parametrize("dtype", sorted(WRITE_CASES))
def test_write_wav_bytes_equal_goofer_tpu(tmp_path, dtype):
    data = WRITE_CASES[dtype]
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    write_wav(ours, data, 44100)
    j_audio_io.write_wav(theirs, data, 44100)
    assert ours.read_bytes() == theirs.read_bytes()
    if dtype == "int16":
        np.testing.assert_array_equal(wavfile.read(ours)[1], data)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_wav_rounds_ties_away_from_zero(tmp_path, dtype):
    write_wav(tmp_path / "t.wav", TIES.astype(dtype), 44100)
    assert wavfile.read(tmp_path / "t.wav")[1].tolist() == TIES_PCM


def _riff(path, fmt_code, bits, payload: bytes, channels=1, sr=44100,
          extra=b""):
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(extra) + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels, sr,
                            sr * channels * bits // 8, channels * bits // 8,
                            bits))
        f.write(extra + b"data" + struct.pack("<I", len(payload)) + payload)


def _pcm24(ints) -> bytes:
    return b"".join(struct.pack("<i", int(v))[:3] for v in ints)


_Y = np.random.default_rng(5).uniform(-0.9, 0.9, 300)
READ_CASES = {
    "pcm16": (1, 16, (_Y * 32768).astype("<i2").tobytes(), 1, b""),
    "pcm24": (1, 24, _pcm24(_Y * 8388608), 1, b""),
    "pcm32": (1, 32, (_Y * 2147483648).astype("<i4").tobytes(), 1, b""),
    "float32": (3, 32, _Y.astype("<f4").tobytes(), 1, b""),
    "float64": (3, 64, _Y.astype("<f8").tobytes(), 1, b""),
    "pcm8": (1, 8, (_Y * 127 + 128).astype(np.uint8).tobytes(), 1, b""),
    "stereo16": (1, 16, (_Y * 32768).astype("<i2").tobytes(), 2, b""),
    "extra_chunks": (1, 16, (_Y * 32768).astype("<i2").tobytes(), 1,
                     b"LIST" + struct.pack("<I", 6) + b"INFOxx"),
}


@pytest.mark.parametrize("name", sorted(READ_CASES))
def test_read_wav_equal_goofer_tpu(tmp_path, name):
    fmt, bits, payload, channels, extra = READ_CASES[name]
    p = tmp_path / f"{name}.wav"
    _riff(p, fmt, bits, payload, channels, extra=extra)
    ours, sr = read_wav(p)
    theirs, sr_j = j_audio_io.read_wav(p)
    assert sr == sr_j == 44100 and ours.dtype == np.float64
    assert ours.shape == theirs.shape and ours.tobytes() == theirs.tobytes()
    frames = len(_Y) // channels if channels > 1 else len(_Y)
    assert ours.shape == ((frames, channels) if channels > 1 else (frames,))


@pytest.mark.parametrize("name", ["a.wav", "b.WAV", "c.flac", "d.aiff",
                                  "e.aif", "f.mp3", "g.goofy", "h.ogg",
                                  "noext"])
def test_is_audio_file_equal_goofer_tpu(name):
    assert is_audio_file(name) == j_audio_io.is_audio_file(name)


def test_phrase_pcm16_wavs_equal_float_wavs(tmp_path, monkeypatch):
    """render_phrase_to_wavs with pcm16=True writes the float path's
    samples to within one PCM step (the device-side quantization and
    the writer's round the same values)."""
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    src = tmp_path / "v.wav"
    shutil.copy(VOICE / "src.wav", src)
    shutil.copy(VOICE / "src_features.goofy", tmp_path / "v_features.goofy")
    notes = [NoteSpec(str(src), "C4", length=200, consonant=60, flags="t10"),
             NoteSpec(str(src), "E4", length=260, consonant=60)]
    pcm = [tmp_path / f"pcm{i}.wav" for i in range(2)]
    flt = [tmp_path / f"flt{i}.wav" for i in range(2)]
    render_phrase_to_wavs(notes, pcm, pcm16=True, device="cpu")
    render_phrase_to_wavs(notes, flt, device="cpu")
    for a, b in zip(pcm, flt):
        ya, yb = wavfile.read(a)[1], wavfile.read(b)[1]
        assert ya.dtype == yb.dtype == np.int16 and ya.shape == yb.shape
        assert np.abs(ya.astype(np.int32) - yb).max() <= 1
        assert np.abs(ya).max() > 1000
