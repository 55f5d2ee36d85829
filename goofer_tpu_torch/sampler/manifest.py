"""OpenUtau expression manifest generation.

The reference ships a hand-written SillySampler.yaml declaring each flag as
an OpenUtau expression (ref: SillySampler.yaml:1-289).  Here the manifest
is generated from a flag registry so the YAML, the CLI flag decoder and the
docs can never drift apart.  Content is expression-for-expression
equivalent to the reference manifest (g/B/P ride OpenUtau's built-in
GEN/BRE/P expressions, hence their absence, matching the reference).

A copy of goofer_tpu/sampler/manifest.py (pure Python; the port imports
nothing of goofer_tpu).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Expression:
    key: str
    name: str
    abbr: str
    lo: int
    hi: int
    default: int
    flag: str | None = None          # Numerical expressions
    options: tuple | None = None     # Options expressions


EXPRESSIONS = (
    Expression("cent", "Pitch Offset", "foff", -100, 100, 0, flag="t"),
    Expression("fmwd", "Formant Width (SillySampler)", "S_FW", -100, 100, 0,
               flag="fw"),
    Expression("fmst", "Formant Strength Global (SillySampler)", "S_FT",
               -100, 100, 0, flag="fst"),
    Expression("SF1", "Scale Formant (F1) (SillySampler)", "S_F1",
               -100, 100, 0, flag="fa"),
    Expression("SF2", "Scale Formant (F2) (SillySampler)", "S_F2",
               -100, 100, 0, flag="fb"),
    Expression("SF3", "Scale Formant (F3) (SillySampler)", "S_F3",
               -100, 100, 0, flag="fc"),
    Expression("SF4", "Scale Formant (F4) (SillySampler)", "S_F4",
               -100, 100, 0, flag="fd"),
    Expression("STF1", "Strength Formant (F1) (SillySampler)", "STF1",
               -100, 100, 0, flag="fsta"),
    Expression("STF2", "Strength Formant (F2) (SillySampler)", "STF2",
               -100, 100, 0, flag="fstb"),
    Expression("STF3", "Strength Formant (F3) (SillySampler)", "STF3",
               -100, 100, 0, flag="fstc"),
    Expression("STF4", "Strength Formant (F4) (SillySampler)", "STF4",
               -100, 100, 0, flag="fstd"),
    Expression("Hvoi", "Voiced Harmonics (SillySampler)", "S_V",
               0, 100, 100, flag="V"),
    Expression("cons", "Unvoiced Consonant Gain (SillySampler)", "S_C",
               -100, 100, 0, flag="U"),
    Expression("grit", "Grittiness (SillySampler)", "S_G", 0, 100, 0,
               flag="sh"),
    Expression("dist", "Distortion (SillySampler)", "S_D", 0, 100, 0,
               flag="sr"),
    Expression("tens", "Tension (SillySampler)", "S_T", -100, 100, 0,
               flag="st"),
    Expression("grwl", "Growl (SillySampler)", "S_GW", 0, 100, 0,
               flag="sg"),
    Expression("vfry", "Vocal Fry (SillySampler)", "S_VF", -100, 100, 0,
               flag="vf"),
    Expression("vfhz", "Vocal Fry Base Hz (SillySampler)", "S_VZ",
               0, 100, 50, flag="vh"),
    Expression("vfsl", "Vocal Fry Slide Amount (SillySampler)", "S_VL",
               0, 100, 15, flag="vl"),
    Expression("thdr", "Dryness (SillySampler)", "S_DR", 0, 100, 0,
               flag="sd"),
    Expression("rasp", "Rasp (SillySampler)", "S_SJ", 0, 100, 0,
               flag="sj"),
    Expression("wgwl", "Whisper Growl (SillySampler)", "S_WG", 0, 100, 0,
               flag="sa"),
    Expression("subh", "Subharmonics (SillySampler)", "S_SH", 0, 100, 0,
               flag="su"),
    Expression("brig", "Brightness", "BRI", -100, 100, 0, flag="br"),
    Expression("evsh", "Envelope Shaping (SillySampler)", "EVSH",
               -100, 100, 0, flag="es"),
    Expression("pdyn", "Dynamic from Pitch (SillySampler)", "PDYN",
               -100, 100, 0, flag="pd"),
    Expression("sust", "Sustain Behavior (SillySampler)", "S_SS", 0, 1, 0,
               options=("L0", "L1", "L2")),
    Expression("fvoi", "Force Voicing (SillySampler)", "FVOI", 0, 1, 0,
               options=("FV0", "FV1")),
    Expression("rev", "Reverse", "REV", 0, 1, 0, options=("R0", "R1")),
    Expression("edit", "SillyEditor", "SEDI", 0, 1, 0,
               options=("SE0", "SE1")),
)


def manifest_dict() -> dict:
    out = {}
    for e in EXPRESSIONS:
        entry = {
            "name": e.name,
            "abbr": e.abbr,
            "type": "Options" if e.options else "Numerical",
            "min": e.lo,
            "max": e.hi,
            "default_value": e.default,
            "is_flag": True,
        }
        if e.options:
            entry["options"] = list(e.options)
        else:
            entry["flag"] = e.flag
        out[e.key] = entry
    return {"expressions": out}


def write_manifest(path) -> None:
    """Emit the OpenUtau YAML manifest."""
    lines = ["expressions:"]
    for e in EXPRESSIONS:
        lines.append(f"  {e.key}:")
        lines.append(f"    name: {e.name}")
        lines.append(f"    abbr: {e.abbr}")
        lines.append(f"    type: {'Options' if e.options else 'Numerical'}")
        lines.append(f"    min: {e.lo}")
        lines.append(f"    max: {e.hi}")
        lines.append(f"    default_value: {e.default}")
        lines.append("    is_flag: true")
        if e.options:
            lines.append("    options:")
            for opt in e.options:
                lines.append(f"    - {opt}")
        else:
            lines.append(f"    flag: {e.flag}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
