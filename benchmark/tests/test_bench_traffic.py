"""The traffic: drawn from the seed, the same for the same seed, and fresh
(no two notes of a run share the phrase planner's memo key, and none
repeats a warm-up note); the pitch-bend encoder round-trips through the
frozen decoder."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from benchmark import harness, pitchbend, traffic
from benchmark.reference.sampler.pitchstring import pitch_string_to_cents

CELLS = ("song.heavy_fresh", "note.heavy_fresh")
SEEDS = (0, 7, 2**31 + 12345, -3)


def requests(workload: str, seed: int, window: int):
    _, config, mix = harness.cell_parts(harness.load_spec(), workload)
    vb = config["voicebank"]
    aliases = [f"v{i:03d}" for i in range(vb["aliases"])]
    oto = {"offset_ms": vb["offset_ms"], "consonant_ms": vb["consonant_ms"]}
    gen = traffic.Traffic(mix, aliases, oto, seed)
    warm = gen.warmup()
    return mix, oto, warm, list(itertools.islice(gen.window(), window))


def memo_key(note: dict) -> tuple:
    # goofer_tpu_torch/sampler/phrase.py keys its plan memo on the
    # source's decoded features (one per alias) and every argument
    return (note["alias"], *note["args"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(workload, seed):
    a = requests(workload, seed, 4)
    b = requests(workload, seed, 4)
    assert a[2:] == b[2:]
    c = requests(workload, seed + 1, 4)
    assert a[3] != c[3]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_every_note_fresh(workload, seed):
    mix, _, warm, window = requests(workload, seed, 12)
    warm_keys = [memo_key(n) for r in warm for n in r]
    keys = [memo_key(n) for r in window for n in r]
    assert len(set(warm_keys)) == len(warm_keys)
    assert len(set(keys)) == len(keys)
    assert not set(keys) & set(warm_keys)
    assert all(len(r) == mix["notes_per_request"] for r in window)


@pytest.mark.parametrize("workload", CELLS)
def test_warmup_covers_every_length(workload):
    mix, _, warm, _ = requests(workload, 5, 0)
    lo, hi, step = mix["length_ms"]
    assert {int(n["args"][4]) for r in warm for n in r} == set(
        range(lo, hi + 1, step))


@pytest.mark.parametrize("workload", CELLS)
def test_notes_follow_the_mix(workload):
    mix, oto, _, window = requests(workload, 11, 40)
    flags = mix["flags"]
    lo, hi = mix["pitch_midi"]
    pb = mix["pitch_bend"]
    tick = 60000.0 / (120 * pb["ticks_per_beat"])
    bend_end = (oto["consonant_ms"]
                + (pb["portamento_ticks"]["start"]
                   + pb["portamento_ticks"]["length"]) * tick)
    vibrato = set()
    for n in (n for r in window for n in r):
        pitch, vel, fl, off, length, con, cut, vol, mod, tempo, pb_s = \
            n["args"]
        assert fl.startswith(flags)
        t = int(fl[len(flags) + 1:])
        assert mix["t_flag"][0] <= t <= mix["t_flag"][1]
        assert (vel, cut, vol, mod, tempo) == ("100", "0", "100", "0", "!120")
        assert (int(off), int(con)) == (oto["offset_ms"], oto["consonant_ms"])
        assert n["audio_ms"] == int(con) + int(length)
        from benchmark.reference.sampler.flags import note_to_midi

        assert lo <= note_to_midi(pitch) <= hi
        cents = pitch_string_to_cents(pb_s)
        dur = n["audio_ms"]
        assert len(cents) == int(np.ceil(dur / pitchbend.tick_ms(120))) + 1
        assert cents[-1] == 0
        # after the portamento only the vibrato bends, and only on notes
        # of the preset's auto-vibrato length or more
        after = cents[int(np.ceil(bend_end / pitchbend.tick_ms(120))):]
        long_note = int(length) >= pb["vibrato"]["min_note_ticks"] * tick
        assert bool(np.any(after != 0)) == long_note
        assert np.abs(after).max() <= pb["vibrato"]["depth_cents"]
        vibrato.add(long_note)
    assert vibrato == {True, False}


@pytest.mark.parametrize("values", [
    [0], [5, -5, 2047, -2048], [0] * 40, [3, 3, 3, 7, 7, -1, -1, -1, -1],
    list(range(-300, 300, 7))])
def test_pitchbend_round_trips(values):
    s = pitchbend.encode(values)
    assert pitch_string_to_cents(s).astype(int).tolist() == values


def test_pitchbend_curve_round_trips():
    c = pitchbend.curve(1200.0, 120.0, -700.0, (158.3, 83.3),
                        (500.0, 1200.0, 175.0, 25.0, 70.0, 70.0))
    assert c[0] == -700 and abs(c).max() <= 700
    assert pitch_string_to_cents(pitchbend.encode(c)).astype(int).tolist() \
        == c.tolist()


def test_pitchbend_refuses_values_outside_12_bits():
    with pytest.raises(ValueError):
        pitchbend.encode([2048])
