"""The comparison that decides ``correct``: WAVs the timed path wrote,
against the plain reference (reference/note.py) rendering each note
alone from the same vendored files and arguments.

Per note it reads, in int16 steps of the reference's own quantization:

- ``length_gap``: samples by which the file's length differs (exact);
- ``rms_gap``: rms(file - reference) / rms(reference);
- ``p999_gap``: the 99.9th percentile of |file - reference| over the
  peak |reference| (a pulse onset within rounding of a sample boundary
  may land one sample off, as on the program's own parity budgets);

and the worst over the notes compared.  A request that raised, or whose
WAV is missing, counts in ``failed``.
"""
from __future__ import annotations

import math

import numpy as np


NUMBERS = ("failed", "length_gap", "rms_gap", "p999_gap")
# what a note reads where its file cannot be compared at all
UNREADABLE = 1e9


def note_gaps(got: np.ndarray, want: np.ndarray) -> dict:
    if len(got) != len(want):
        return {"length_gap": abs(len(got) - len(want)),
                "rms_gap": UNREADABLE, "p999_gap": UNREADABLE}
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    w = want.astype(np.float64)
    rms_ref = math.sqrt(float(np.mean(w * w))) + 1e-12
    peak = float(np.abs(w).max()) + 1e-12
    return {"length_gap": 0,
            "rms_gap": math.sqrt(float(np.mean(d * d))) / rms_ref,
            "p999_gap": float(np.percentile(d, 99.9)) / peak}


class Reference:
    """The plain reference of one cell's notes on ``device``: each alias's
    ``.goofy`` loaded and decoded once, each note planned and rendered
    alone at its exact length."""

    def __init__(self, bank, config: dict, entry, device):
        from benchmark.reference import note

        self.note = note
        self.bank = bank
        self.n_fft = config["n_fft"]
        self.hop = config["hop"]
        self.device = device
        self.quantize = (note.pcm16_device if entry.QUANTIZE == "device"
                         else note.pcm16_codec)
        self.phrases = entry.PHRASES
        self.voices: dict = {}
        self.bucketed: dict = {}

    def voice(self, alias: str):
        if alias not in self.voices:
            self.voices[alias] = self.note.load_voice(self.bank.goofy(alias),
                                                      self.device)
        return self.voices[alias]

    def buckets(self, request: list) -> bool:
        """Whether the phrase planner renders ``request`` through length
        buckets, by the planner's rule on the request's own notes."""
        if not self.phrases:
            return False
        if id(request) not in self.bucketed:
            self.bucketed[id(request)] = self.note.phrase_buckets(
                self.note.plan(self.voice(n["alias"]), n["args"], self.n_fft,
                               self.hop) for n in request)
        return self.bucketed[id(request)]

    def pcm(self, r: dict) -> np.ndarray:
        """The reference's int16 PCM of a kept record's note."""
        n = r["note"]
        y = self.note.render(self.voice(n["alias"]), n["args"], r["key"],
                             self.device, n_fft=self.n_fft, hop=self.hop,
                             bucket=self.buckets(r["request"]))
        return self.quantize(y)


def compare(records: list, ref: Reference, sample_rate: int) -> dict:
    """Worst gaps over ``records`` (dicts of ``note``, its ``request``,
    ``key`` and ``path``)."""
    from scipy.io import wavfile

    worst = {"length_gap": 0, "rms_gap": 0.0, "p999_gap": 0.0}
    for r in records:
        sr, got = wavfile.read(str(r["path"]))
        gaps = note_gaps(got, ref.pcm(r))
        if sr != sample_rate or got.dtype != np.int16:
            gaps = {"length_gap": UNREADABLE, "rms_gap": UNREADABLE,
                    "p999_gap": UNREADABLE}
        for k, v in gaps.items():
            worst[k] = max(worst[k], v)
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none exceeds it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
