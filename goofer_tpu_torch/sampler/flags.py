"""UTAU flag-string parsing and the 34-flag parameter decode.

A JAX-free copy of goofer_tpu/sampler/flags.py.

The flag surface is the resampler's API contract (ref README.md:6-41); each
derivation below cites its decode site in GooferResampler.__init__
(ref: SillySampler.py:286-411).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

NOTE_OFFSETS = {"C": 0, "C#": 1, "D": 2, "D#": 3, "E": 4, "F": 5,
                "F#": 6, "G": 7, "G#": 8, "A": 9, "A#": 10, "B": 11}
NOTE_RE = re.compile(r"([A-G]#?)(-?\d+)")
FLAG_RE = re.compile(r"([A-Za-z]{1,4})([+-]?\d+)?")


def parse_flags(flag_string: str) -> dict:
    """'g-20B30' -> {'g': -20, 'B': 30}; '/' separators stripped; a flag
    with no value maps to None (ref: SillySampler.py:50-54)."""
    flags = {}
    for key, val in FLAG_RE.findall(flag_string.replace("/", "")):
        flags[key] = int(val) if val else None
    return flags


def note_to_midi(note: str) -> int:
    m = NOTE_RE.match(note)
    if not m:
        raise ValueError(f"Bad note '{note}'")
    name, octave = m.groups()
    return (int(octave) + 1) * 12 + NOTE_OFFSETS[name]


def midi_to_hz(m):
    return 440.0 * 2.0 ** ((np.asarray(m, dtype=np.float64) - 69.0) / 12.0)


def _clampf(v, lo, hi) -> float:
    """Scalar clamp: np.clip on Python scalars costs ~10 us each and the
    flag decode runs per note on the phrase-planning hot path."""
    v = float(v)
    return lo if v < lo else (hi if v > hi else v)


def _ci_get(flags: dict, name: str, default=0):
    """Case-insensitive flag lookup used by several decode sites."""
    val = next((v for k, v in flags.items() if k.lower() == name.lower()),
               default)
    return default if val is None else val


@dataclass
class NoteParams:
    """All per-note parameters derived from the 13 UTAU args + flags."""
    # positional args (normalized units)
    pitch_midi: int = 60
    velocity: float = 100.0
    offset_sec: float = 0.0
    length_sec: float = 1.0
    consonant_sec: float = 0.0
    cutoff_sec: float = 0.0
    volume: float = 1.0
    modulation: float = 0.0      # parsed but unused, like the reference
    tempo: float = 120.0
    bend_cents: np.ndarray = field(
        default_factory=lambda: np.array([0.0], dtype=np.float32))

    # flag-derived
    use_editor: bool = False
    formant_shift: float = 1.0
    brightness_env: float = 1.0
    f_shifts: tuple = (1.0, 1.0, 1.0, 1.0)
    f0_jitter: bool = False
    f0_jitter_strength: float = 0.0
    volume_jitter: bool = False
    volume_jitter_strength: float = 0.0
    sd_strength: float = 0.0
    breathiness_mix: float = 1.0
    unvoiced_mix: float = 1.0
    harmonic_mix: float = 1.0
    loop_mode: str = "concat"
    tension: float = 0.0
    subharm_weight: float = 0.0
    add_subharm: bool = False
    reverse: bool = False
    growl_mix: float = 0.0
    aperiodic_mix: float = 0.0
    subharm_gain: float = 0.0
    normalize: float = 1.0
    env_shape: float = 0.0
    force_voiced: bool = False
    pitch_dyn: float = 0.0
    formant_width: float = 0.0
    formant_strengths: tuple = (0.0, 0.0, 0.0, 0.0)
    t_cents: float = 0.0
    fry_amount: float = 0.0      # vf
    fry_base_hz: float = 50.0    # vh
    fry_glide_pct: float = 15.0  # vl

    @classmethod
    def from_args(cls, pitch: str, velocity, flags: str = "",
                  offset=0, length=1000, consonant=0, cutoff=0,
                  volume=100, modulation=0, tempo="!120",
                  pitch_string: str = "AA") -> "NoteParams":
        from goofer_tpu_torch.sampler.pitchstring import pitch_string_to_cents

        f = parse_flags(flags)

        fst = _clampf(_ci_get(f, "fst"), -100, 100) / 100.0
        strengths = tuple(
            _clampf(fst + _ci_get(f, name) / 100.0, -1.0, 1.0)
            for name in ("fsta", "fstb", "fstc", "fstd"))

        sh = f.get("sh", None)
        sr_flag = f.get("sr", None)

        lval = _ci_get(f, "l", None)
        loop_mode = {0: "concat", 1: "avg", 2: "stretch"}.get(lval, "concat")

        sg = f.get("sg", 0) or 0
        tempo_f = float(str(tempo).lstrip("!"))

        return cls(
            pitch_midi=note_to_midi(pitch),
            velocity=float(velocity),
            offset_sec=float(offset) / 1000.0,
            length_sec=float(length) / 1000.0,
            consonant_sec=float(consonant) / 1000.0,
            cutoff_sec=float(cutoff) / 1000.0,
            volume=float(volume) / 100.0,
            modulation=float(modulation) / 100.0,
            tempo=tempo_f,
            bend_cents=pitch_string_to_cents(pitch_string),
            use_editor=_ci_get(f, "se") == 1,
            formant_shift=1.0 + (f.get("g", 0) or 0) / 200.0,
            brightness_env=((f.get("br", 0) or 0) + 100) / 100.0,
            f_shifts=tuple(1.0 + (f.get(n, 0) or 0) / 100.0
                           for n in ("fa", "fb", "fc", "fd")),
            f0_jitter=sh is not None and sh > 0,
            f0_jitter_strength=(sh or 0) / 50.0,
            volume_jitter=sr_flag is not None and sr_flag > 0,
            volume_jitter_strength=(sr_flag or 0) / 50.0,
            sd_strength=float(f.get("sd", 0) or 0),
            breathiness_mix=((f.get("B", 0) or 0) + 100) / 100.0,
            unvoiced_mix=((f.get("U", 0) or 0) + 100) / 100.0,
            harmonic_mix=_clampf(
                f.get("V", 100) if f.get("V", 100) is not None else 100,
                0, 100) / 100.0,
            loop_mode=loop_mode,
            tension=(f.get("st", 0) or 0) / 100.0,
            subharm_weight=(sg / 100.0) * 1.5,
            add_subharm=sg > 0,
            reverse=f.get("R", 0) == 1,
            growl_mix=_clampf(f.get("sj", 0) or 0, 0, 100) / 100.0,
            aperiodic_mix=_clampf(f.get("sa", 0) or 0, 0, 100) / 100.0,
            subharm_gain=_clampf(f.get("su", 0) or 0, 0, 100) / 100.0,
            normalize=(_clampf(f["P"], 0, 100) / 100.0
                       if f.get("P") is not None else 1.0),
            env_shape=_clampf(_ci_get(f, "es"), -100, 100) / 100.0,
            force_voiced=f.get("FV", 0) == 1,
            pitch_dyn=float(int(_clampf(_ci_get(f, "pd"), -100, 100))) / 100.0,
            formant_width=((f.get("fw", 0) or 0) / 100.0) * 0.1,
            formant_strengths=strengths,
            t_cents=float(f.get("t", 0) or 0),
            fry_amount=float(f.get("vf", 0) or 0),
            # explicit vh0/vl0 are REAL values the reference honors
            # (vh floors at 1 Hz, SillySampler.py:886-888) — `or`
            # fallbacks here would silently remap 0 to the default
            fry_base_hz=max(1.0, float(
                f["vh"] if f.get("vh") is not None else 50)),
            fry_glide_pct=_clampf(
                f["vl"] if f.get("vl") is not None else 15, 0.0, 100.0),
        )

    @property
    def velocity_factor(self) -> float:
        """Consonant-velocity prefix time factor (ref: SillySampler.py:766)."""
        return float(2.0 ** (1.0 - self.velocity / 100.0))
