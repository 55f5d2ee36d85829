"""The default comparison that decides ``correct`` (harness.py, part 5):
WAVs the timed path wrote, against the plain reference
(reference/note.py) rendering each note alone from the same vendored
files and arguments.

Per note it reads, in int16 steps of the reference's own quantization:

- ``length_gap``: samples by which the file's length differs (exact);
- ``rms_gap``: rms(file - reference) / rms(reference);
- ``p999_gap``: the 99.9th percentile of |file - reference| over the
  peak |reference| (a pulse onset within rounding of a sample boundary
  may land one sample off, as on the program's own parity budgets);

and the worst over the notes compared.  A request that raised, or whose
WAV is missing, counts in ``failed``.  ``judge`` holds every cell's
numbers, whatever its comparer, to the configuration's limits.

The control (``control``, run by ``control.py``): the configurations
state float32 with TF32 off.  TF32 changes no bit of this render (no op
of it runs on tensor cores), so the reference one precision below rounds
every float32 tensor its ops return to bfloat16, as a render that stores
its signals in bfloat16 would hold them (float64 phases and integers
stay), and writes each kept note's WAV in the program's place.
"""
from __future__ import annotations

import math

import numpy as np


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
        self.noise_key = entry.noise_key
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
        n = r["item"]
        y = self.note.render(self.voice(n["alias"]), n["args"],
                             self.noise_key(r["index"]),
                             self.device, n_fft=self.n_fft, hop=self.hop,
                             bucket=self.buckets(r["request"]))
        return self.quantize(y)


def compare(records: list, ref: Reference, sample_rate: int) -> dict:
    """Worst gaps over ``records`` (dicts of the note, ``item``, its
    ``request``, its ``index`` there and the WAV's ``path``)."""
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


def _bf16_mode():
    """A torch function mode that rounds every float32 tensor an op
    returns to bfloat16."""
    import torch
    from torch.overrides import TorchFunctionMode

    def lower(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        if isinstance(x, (tuple, list)):
            return type(x)(lower(v) for v in x)
        return x

    class Bf16(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            return lower(func(*args, **(kwargs or {})))

    return Bf16()


def worst(records: list, inputs, config: dict, entry, device) -> dict:
    """The comparer's numbers: each kept note of the voicebank ``inputs``
    rendered by ``entry`` (its class) against the reference on
    ``device``."""
    return compare(records, Reference(inputs, config, entry, device),
                   config["sample_rate"])


def control(records: list, inputs, config: dict, entry, device) -> dict:
    """``worst`` of each record's note rendered by a second reference,
    every op in bfloat16, and written over the program's WAV."""
    from scipy.io import wavfile

    low = Reference(inputs, config, entry, device)
    with _bf16_mode():
        for r in records:
            wavfile.write(str(r["path"]), config["sample_rate"],
                          np.asarray(low.pcm(r), dtype=np.int16))
    return worst(records, inputs, config, entry, device)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit, in the limits' order; correct when
    none exceeds it.  The limits name ``failed`` and every number the
    comparer read, and no other."""
    if "failed" not in limits or set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} against limits "
                         f"{sorted(limits)}: each number needs a limit, "
                         "and failed is always judged")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
