"""The note render does not move: digests of int16 renders on the CPU.

The heavy 11-flag note and the first 4 notes of chip_smoke.py's phrase
(b), rendered from the vendored voice source with fixed seeds, must give
the int16 samples recorded in DIGESTS bit for bit.  The digests were
taken from the tree before the facade's synthesis options (subharmonic
semitone lists, subharmonic jitter, volume vibrato, brightness off,
roughness) became SynthStatic fields and knobs: a field or a noise
stream that the note render forgets to pass changes a digest.  One
intra-op thread, so that no reduction's split depends on the worker.

The heavy note goes through write_wav, whose float path became the
native codec's (ties rounded away from zero, as goofer_tpu writes them):
its digest was re-recorded then, from the same float samples, of which
10 sit on a tie and moved by one step."""
import pytest

torch = pytest.importorskip("torch")

import hashlib  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from goofer_tpu_torch.sampler.phrase import NoteSpec, render_phrase  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402

VOICE = Path(__file__).parent / "golden" / "voice"
HEAVY_FLAGS = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"
PHRASE_SCALE = ("C4", "D4", "E4", "F4")

DIGESTS = {
    "heavy_note":
        "72e95d190a044e19f54ffffe107e2edefa844157dc39383d37b66672517a4dc1",
    "phrase_b_0":
        "2bdf277fe317a47b7f967efcf31a5d52583a6af4ca02f05e7d87c5c292af2ff6",
    "phrase_b_1":
        "6dd7b4034ea17045966c5c1b8c6580d5fdca975636b72ea84d207ec7ed02542d",
    "phrase_b_2":
        "c9600b1d3a4229d1aaa363245778b264efcdac0e76a4d53026f45a004eb38c78",
    "phrase_b_3":
        "cecc2c7fcf0409fff572ee0294bcd87ace2cf6818f82deb06940108c979f93ea",
}


def render_digests(tmp: Path) -> dict:
    """sha256 of each render's int16 samples."""
    src = tmp / "voice.wav"
    shutil.copy(VOICE / "src.wav", src)
    shutil.copy(VOICE / "src_features.goofy", tmp / "voice_features.goofy")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp / "heavy.wav"
        GooferResampler(src, out, "C4", 100, HEAVY_FLAGS, 100, 900, 200, 0,
                        100, 0, "!120", "AA", device="cpu")
        pcm = {"heavy_note": wavfile.read(out)[1]}
        notes = [NoteSpec(str(src), PHRASE_SCALE[i], length=690,
                          consonant=60,
                          flags=HEAVY_FLAGS + f"t{(i % 7 - 3) * 10}")
                 for i in range(4)]
        for i, y in enumerate(render_phrase(notes, pcm16=True,
                                            device="cpu")):
            pcm[f"phrase_b_{i}"] = y
    finally:
        torch.set_num_threads(threads)
    return {k: hashlib.sha256(np.ascontiguousarray(v, np.int16).tobytes())
            .hexdigest() for k, v in pcm.items()}


def test_note_and_phrase_renders_unchanged(tmp_path):
    assert render_digests(tmp_path) == DIGESTS
