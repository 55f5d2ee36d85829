"""The per-note deployment's entry: UTAU's 13-argument resampler call,
``goofer_tpu_torch.cli.main`` in one warm process.  The CLI writes float
audio through the WAV codec, which rounds half away from zero, and every
note draws its noise from the key 0."""
from __future__ import annotations


class Entry:
    # whether a request is a phrase, which the planner may render through
    # length buckets
    PHRASES = False
    QUANTIZE = "codec"

    def __init__(self, config: dict, bank):
        from goofer_tpu_torch import cli

        self.cli = cli
        self.bank = bank

    def call(self, notes: list, paths: list) -> bool:
        ok = True
        for n, p in zip(notes, paths):
            ok &= self.cli.main([str(self.bank.wav(n["alias"])), str(p),
                                 *n["args"]]) == 0
        return ok

    @staticmethod
    def noise_key(index: int):
        return 0
