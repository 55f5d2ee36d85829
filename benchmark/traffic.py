"""The default generator of requests (harness.py, part 2): a traffic mix
is a data file of parameters (``traffic/<name>.json``) that this module
reads, and the notes are drawn from ``--seed``.

Every note is fresh: its arguments (and so the phrase planner's memo
key) differ from every other note of the run, warm-up included; a draw
that repeats one is drawn again.  Warm-up notes come from their own
stream and cover every length step.

A note's pitch bend is OpenUtau's default note preset: a portamento
from the previous note's pitch, and on notes long enough for its
auto-vibrato the preset's vibrato, both given in the mix's
``pitch_bend`` in OpenUtau's own units (ticks of its 480 a beat, shares
of the note).
"""
from __future__ import annotations

import numpy as np

from benchmark import pitchbend

NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")
# the streams drawn from one seed; the harness draws CHECK and SAMPLE,
# every generator WARMUP and WINDOW
WARMUP, WINDOW, CHECK, SAMPLE = 0, 1, 2, 4


def note_name(midi: int) -> str:
    return f"{NAMES[midi % 12]}{midi // 12 - 1}"


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream]))


class Traffic:
    """Requests of one mix: each a list of ``notes_per_request`` notes, a
    note a dict of its alias, its 11 UTAU arguments after the two paths
    (as strings, as the CLI takes them) and its audio length in ms."""

    def __init__(self, spec: dict, aliases: list, oto: dict, seed: int):
        self.spec = spec
        self.aliases = list(aliases)
        self.oto = oto
        lo, hi, step = spec["length_ms"]
        self.lengths = list(range(lo, hi + 1, step))
        self.seed = seed
        self.seen: set = set()
        self.prev_midi = None

    def _bend(self, midi: int, prev: int, length: int) -> str:
        """The pitch-bend string of a note of ``length`` ms whose note-on
        lies at its consonant's end, after a note of MIDI ``prev``."""
        pb = self.spec["pitch_bend"]
        tempo = float(self.spec["fixed"]["tempo"].lstrip("!"))
        tick = 60000.0 / (tempo * pb["ticks_per_beat"])
        on = self.oto["consonant_ms"]
        port = pb["portamento_ticks"]
        vib = None
        v = pb["vibrato"]
        if length >= v["min_note_ticks"] * tick:
            span = length * v["length_share"]
            vib = (on + length - span, on + length, v["period_ms"],
                   v["depth_cents"], span * v["in_share"],
                   span * v["out_share"])
        return pitchbend.encode(pitchbend.curve(
            on + length, tempo, 100.0 * (prev - midi),
            (on + port["start"] * tick, port["length"] * tick), vib))

    def _note(self, g: np.random.Generator, alias: str, length: int):
        s = self.spec
        lo, hi = s["pitch_midi"]
        midi = int(g.integers(lo, hi + 1))
        prev = midi if self.prev_midi is None else self.prev_midi
        self.prev_midi = midi
        t = int(g.integers(s["t_flag"][0], s["t_flag"][1] + 1))
        fx = s["fixed"]
        cons = self.oto["consonant_ms"]
        args = [note_name(midi), str(fx["velocity"]),
                f"{s['flags']}t{t}", str(self.oto["offset_ms"]), str(length),
                str(cons), str(fx["cutoff"]), str(fx["volume"]),
                str(fx["modulation"]), fx["tempo"],
                self._bend(midi, prev, length)]
        return {"alias": alias, "args": args, "audio_ms": cons + length}

    def _fresh(self, g, alias, length):
        while True:
            note = self._note(g, alias, length)
            key = (note["alias"], tuple(note["args"]))
            if key not in self.seen:
                self.seen.add(key)
                return note

    def _request(self, g, lengths=None):
        n = self.spec["notes_per_request"]
        out = []
        for i in range(n):
            alias = self.aliases[int(g.integers(len(self.aliases)))]
            length = (lengths[i] if lengths is not None and i < len(lengths)
                      else self.lengths[int(g.integers(len(self.lengths)))])
            out.append(self._fresh(g, alias, length))
        return out

    def warmup(self) -> list:
        """``warmup_requests`` requests from the warm-up stream; their
        first notes take every length step once, in an order drawn from
        the seed, and the rest are drawn as the window's."""
        g = rng(self.seed, WARMUP)
        lengths = [self.lengths[i] for i in g.permutation(len(self.lengths))]
        per = self.spec["notes_per_request"]
        reqs = [self._request(g, lengths[r * per:(r + 1) * per])
                for r in range(self.spec["warmup_requests"])]
        if {int(n["args"][4]) for q in reqs for n in q} != set(self.lengths):
            raise ValueError("the warm-up does not cover every length step: "
                             "raise warmup_requests")
        return reqs

    def window(self):
        """The window's requests, without end."""
        g = rng(self.seed, WINDOW)
        self.prev_midi = None
        while True:
            yield self._request(g)


def generator(mix: dict, inputs, seed: int) -> Traffic:
    """The mix's notes over the voicebank ``inputs``."""
    return Traffic(mix, inputs.aliases, inputs.oto, seed)
