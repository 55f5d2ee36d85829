"""The batched deployment's entry: ``render_phrase_to_wavs(notes, paths,
pcm16=True)``, one request a phrase.  The render quantizes on the card,
rounding half to even, and note ``i`` of a phrase draws its noise from
the key (0, i)."""
from __future__ import annotations


class Entry:
    # whether a request is a phrase, which the planner may render through
    # length buckets
    PHRASES = True
    QUANTIZE = "device"

    def __init__(self, config: dict, bank):
        from goofer_tpu_torch.sampler import phrase

        self.phrase = phrase
        self.bank = bank
        self.n_fft = config["n_fft"]
        self.hop = config["hop"]

    def call(self, notes: list, paths: list) -> bool:
        specs = [self.phrase.NoteSpec(str(self.bank.wav(n["alias"])),
                                      *n["args"]) for n in notes]
        self.phrase.render_phrase_to_wavs(specs, [str(p) for p in paths],
                                          n_fft=self.n_fft, hop=self.hop,
                                          pcm16=True)
        return True

    @staticmethod
    def noise_key(index: int):
        return (0, index)
