"""The stand-in's inputs: a pool of recordings with nothing beside them,
each the vendored voice under its own name."""
from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np

from benchmark.voicebank import SOURCE_WAV


class Pool:
    def __init__(self, spec: dict):
        from scipy.io import wavfile

        self.sample_rate = wavfile.read(SOURCE_WAV)[0]
        self.root = Path(tempfile.mkdtemp(prefix="bench_pool_"))
        self.recordings = [f"r{i:02d}" for i in range(spec["recordings"])]
        for name in self.recordings:
            shutil.copyfile(SOURCE_WAV, self.root / f"{name}.wav")
        self._samples: dict = {}

    def samples(self, name: str) -> np.ndarray:
        """The recording's int16 samples."""
        from scipy.io import wavfile

        if name not in self._samples:
            self._samples[name] = wavfile.read(self.root / f"{name}.wav")[1]
        return self._samples[name]

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def build(config: dict) -> Pool:
    return Pool(config["pool"])
