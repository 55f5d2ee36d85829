"""The port's WAV writer: int16 PCM is written as it is, float input is
quantized, both byte for byte as goofer_tpu's scipy path writes them."""
import pytest

torch = pytest.importorskip("torch")

import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import goofer_tpu.utils.audio_io as j_audio_io  # noqa: E402
from goofer_tpu_torch.sampler.phrase import (  # noqa: E402
    NoteSpec,
    render_phrase_to_wavs,
)
from goofer_tpu_torch.utils.audio_io import write_wav  # noqa: E402

VOICE = Path(__file__).parent / "golden" / "voice"


@pytest.mark.parametrize("dtype", ["int16", "float64"])
def test_write_wav_bytes_equal_goofer_tpu(tmp_path, monkeypatch, dtype):
    # goofer_tpu's scipy path: no native codec, no soundfile
    monkeypatch.setattr(j_audio_io, "_native_codec", lambda: None)
    monkeypatch.setattr(j_audio_io, "_sf", None)
    if dtype == "int16":
        data = np.array([0, 1000, -1000, 20000, -32768, 32767], np.int16)
    else:
        data = np.random.default_rng(3).uniform(-1.2, 1.2, 500)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    write_wav(ours, data, 44100)
    j_audio_io.write_wav(theirs, data, 44100)
    assert ours.read_bytes() == theirs.read_bytes()
    if dtype == "int16":
        np.testing.assert_array_equal(wavfile.read(ours)[1], data)


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
