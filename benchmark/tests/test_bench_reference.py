"""The plain reference held to something other than the program it
judges: the real-voice goldens that the upstream resampler rendered from
the vendored recording (tests/golden/voice/out_voice_*.wav, read as
data), within the budgets tests/test_golden.py holds them to.

The reference renders each golden's 11 arguments from the recording's
``.goofy`` on the CPU at the noise key 0; the upstream draws other noise,
so each budget is the upstream's own seed-to-seed floor plus 0.5 dB, and
the F0 is held where both tracks are voiced on 8 frames or more (not for
the texture, whose layers make any tracker octave-unstable)."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

GOLDEN = harness.REPO / "tests" / "golden" / "voice"
# (name, the 11 arguments after the two paths): tools/make_goldens.py's
# VOICE_CONFIGS, with which the goldens were rendered
VOICE_CONFIGS = [
    ("voice_neutral", "A3", 100, "", 100, 900, 200, 0, 100, 0, "!120",
     "AA"),
    ("voice_shift_loop", "E4", 100, "t20L1", 100, 1200, 200, 0, 100, 0,
     "!120", "AA"),
    ("voice_formants", "A3", 100, "g-12fa6fb-5fw20br25es15", 100, 900,
     200, 0, 100, 0, "!120", "AA"),
    ("voice_texture", "C4", 100, "V70B35sh30sr25sd20su30", 100, 900,
     200, 0, 100, 0, "!120", "AA"),
    ("voice_fry", "G3", 100, "vf30vh50vl25st-20sa20", 100, 900, 200, 0,
     100, 0, "!120", "ABAC#3#AD"),
]
# tests/test_golden.py's VOICE_LSD_BUDGET_DB and F0_BUDGET_CENTS
LSD_BUDGET_DB = {
    "voice_neutral": 0.70 + 0.5,
    "voice_shift_loop": 0.65 + 0.5,
    "voice_formants": 0.71 + 0.5,
    "voice_texture": 1.38 + 0.5,
    "voice_fry": 0.79 + 0.5,
}
F0_BUDGET_CENTS = 15.0
F0_UNSTABLE = {"voice_texture"}


@pytest.fixture(scope="module")
def voice():
    import torch

    from benchmark.reference import note

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield note.load_voice(GOLDEN / "src_features.goofy", "cpu")
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,args", [(c[0], c[1:]) for c in
                                       VOICE_CONFIGS])
def test_reference_renders_the_goldens(voice, name, args):
    from scipy.io import wavfile

    from benchmark.reference import note
    from goofer_tpu_torch.analysis.pitch import track_pitch
    from goofer_tpu_torch.utils.metrics import f0_rmse_cents, lsd_db

    sr, golden = wavfile.read(GOLDEN / f"out_{name}.wav")
    ours = note.pcm16_codec(note.render(voice, [str(a) for a in args], 0,
                                        "cpu"))
    assert len(ours) == len(golden)
    golden = golden.astype(np.float32) / 32768.0
    ours = ours.astype(np.float32) / 32768.0
    lsd = lsd_db(ours, golden, sr)
    assert lsd <= LSD_BUDGET_DB[name], (name, lsd)
    if name in F0_UNSTABLE:
        return
    f0_g = track_pitch(golden, sr, 256 / sr, device="cpu")
    f0_o = track_pitch(ours, sr, 256 / sr, device="cpu")
    voiced = (f0_g > 0) & (f0_o > 0)
    assert voiced.sum() >= 8, name
    rmse = f0_rmse_cents(f0_o[voiced], f0_g[voiced])
    assert rmse <= F0_BUDGET_CENTS, (name, rmse)
