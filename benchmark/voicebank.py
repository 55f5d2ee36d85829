"""The default inputs of a cell (harness.py, part 1): the voicebank a
cell renders from, built in the run's temporary directory from the
vendored recording and its ``.goofy`` only: every alias is
``voice/src.wav`` and ``voice/src_features.goofy`` under the alias's own
name (a hard link where the filesystem allows, else a copy), and every
alias has the recording's own oto entry (offset and consonant)."""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

VOICE = Path(__file__).resolve().parent / "voice"
SOURCE_WAV = VOICE / "src.wav"
SOURCE_GOOFY = VOICE / "src_features.goofy"


def _place(src: Path, dst: Path) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


class Voicebank:
    """``root`` holds ``<alias>.wav`` and ``<alias>_features.goofy`` for
    each of the configuration's ``aliases``; ``oto`` is every alias's
    ``offset_ms`` and ``consonant_ms``."""

    def __init__(self, spec: dict):
        self.aliases = [f"v{i:03d}" for i in range(spec["aliases"])]
        self.oto = {"offset_ms": spec["offset_ms"],
                    "consonant_ms": spec["consonant_ms"]}
        self.root = Path(tempfile.mkdtemp(prefix="bench_voicebank_"))
        for a in self.aliases:
            _place(SOURCE_WAV, self.wav(a))
            _place(SOURCE_GOOFY, self.goofy(a))

    def wav(self, alias: str) -> Path:
        return self.root / f"{alias}.wav"

    def goofy(self, alias: str) -> Path:
        return self.root / f"{alias}_features.goofy"

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def build(config: dict) -> Voicebank:
    """The configuration's voicebank (its ``voicebank`` sizes)."""
    return Voicebank(config["voicebank"])
