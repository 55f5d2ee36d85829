"""The note render's two cells read as they did before a configuration
could name its own parts (harness.py): for seeds 0, 1 and 7 the same
warm-up requests and first five window requests, the same notes drawn
by the check stream and the same selection compared, frozen as digests
taken with the harness from before that change; and the same four
numbers judged.

The digests were taken there by ``selection`` as below, with the three
lines that name the parts written as that harness had them (it had no
``part``, and its Runner read each note's noise key from the entry):

    bank = voicebank.Voicebank(config["voicebank"])        # inputs
    gen = traffic.Traffic(mix, bank.aliases, bank.oto, seed)
    runner = harness.Runner(ZeroWavs(), mix, seed, config["sample_rate"],
                            out)                            # no gen

with ``ZeroWavs.noise_key = staticmethod(lambda index: 0)`` and
``bank.close()`` in the ``finally``.
"""
from __future__ import annotations

import hashlib
import itertools
import json

import pytest

from benchmark import check, control, harness, traffic, voicebank
from benchmark.tests.tiny import cpu_env, tiny_cell

# (workload, seed, window requests sent): sha256 of the canonical JSON
# of ``selection``; the longer runs keep more notes than are compared,
# so the sample stream chooses among them
DIGESTS = {
    ("song.heavy_fresh", 0, 5):
        "cd91a83a4c596f948704974f0751fac70dd403dbb39c53ab92bfb2910f211cee",
    ("song.heavy_fresh", 0, 15):
        "69a62c1f35a80a550d85b997e25bb3177dd2af7238192ed85f991a28dbb309e4",
    ("song.heavy_fresh", 1, 5):
        "e6212bc866c9aec1dfbe4e18cc1c90380dadab86d815a25b98228a163ce22e70",
    ("song.heavy_fresh", 1, 15):
        "bcef0e6f7dbc267c45da9a7402df71491fe48e122f5acdfaf722e2739d5dca2a",
    ("song.heavy_fresh", 7, 5):
        "a464ec4195d75ec90a1d8b2237a3587fbb680b53d240629437bca91e209c8f55",
    ("song.heavy_fresh", 7, 15):
        "65ddb9d0d81ab53a72a825e4188ddabd3e32e5a86ecafd5f01fcbef117d03cce",
    ("note.heavy_fresh", 0, 5):
        "28ed57c1ce06d7d84a6181303403a8062b30c40f313530608bd5f3861974ee72",
    ("note.heavy_fresh", 0, 600):
        "0de4b45b8757ea41ff54091516dbe565be06d9ea05f35ff970891db9594806e8",
    ("note.heavy_fresh", 1, 5):
        "1cad343c8c77c34dc3211fbb11554cddf04ab32d6e18534027e50e14668948e7",
    ("note.heavy_fresh", 1, 600):
        "dd7599a2ace2bfee069117d1ab39c12e763e6c95902d0bd3ecf13cb0bbb0bf6d",
    ("note.heavy_fresh", 7, 5):
        "a066a31c0d86862f47e1a827373aa4630a26f0e8ab5e02fa68e907200b6cfa65",
    ("note.heavy_fresh", 7, 600):
        "da5b013f6ad0c3a0ac8f6a48211e12b38444eff97747a7670cc8095063021137",
}


class ZeroWavs:
    """Stands in for the program: each note's WAV, silent, 10 samples a
    ms of its audio, so the longest note has the largest file."""

    def call(self, notes, paths):
        for n, p in zip(notes, paths):
            p.write_bytes(b"\0" * (harness.WAV_HEADER + 20 * n["audio_ms"]))
        return True


def selection(workload: str, seed: int, n_window: int, out) -> dict:
    """What a run of ``workload`` sends and keeps: the warm-up, the first
    five window requests, the kept (drawn) files of ``n_window`` window
    requests, the longest and those compared, through the harness's own
    parts and Runner."""
    _, config, mix = harness.cell_parts(harness.load_spec(), workload)
    inputs = harness.part("inputs", config.get("inputs"),
                          voicebank).build(config)
    try:
        gen = harness.part("generators", mix.get("generator"),
                           traffic).generator(mix, inputs, seed)
        runner = harness.Runner(ZeroWavs(), mix, seed, config["sample_rate"],
                                out, gen)
        warm = gen.warmup()
        for r in warm:
            assert runner.send(r)[1]
        window = list(itertools.islice(gen.window(), n_window))
        for r in window:
            assert runner.send(r, keep=True)[1]
        return {"warmup": warm, "window": window[:5],
                "kept": [r["path"].name for r in runner.kept],
                "longest": runner.longest["path"].name,
                "compared": [r["path"].name
                             for r in runner.compared(seed)]}
    finally:
        inputs.close()


@pytest.mark.parametrize("workload,seed,n_window", sorted(DIGESTS))
def test_requests_and_checked_notes_as_before(workload, seed, n_window,
                                              tmp_path):
    doc = selection(workload, seed, n_window, tmp_path)
    got = hashlib.sha256(json.dumps(doc, sort_keys=True).encode())
    assert got.hexdigest() == DIGESTS[workload, seed, n_window]


@pytest.mark.parametrize("workload", ("song.heavy_fresh",
                                      "note.heavy_fresh"))
def test_tiny_cell_judges_the_four_numbers(workload, tmp_path, monkeypatch):
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, workload)
    r = harness.run_cell(workload, 2**31 + 31, 0.0, False, spec=s, mix=mix)
    assert r["correct"] is True, r["checks"]
    assert list(r["checks"]) == ["failed", "length_gap", "rms_gap",
                                 "p999_gap"]


@pytest.mark.parametrize("workload", ("song.heavy_fresh",
                                      "note.heavy_fresh"))
def test_tiny_cell_control_is_not_correct(workload, tmp_path, monkeypatch):
    """control.py through the note render's default parts, on the CPU:
    the bfloat16 reference in the program's place fails the limits."""
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, workload)
    r = control.control(workload, 2**31 + 37, "cpu", spec=s, mix=mix)
    assert r["correct"] is False, r["checks"]
    assert list(r["checks"]) == ["failed", "length_gap", "rms_gap",
                                 "p999_gap"]
    assert r["checks"]["rms_gap"]["value"] > r["checks"]["rms_gap"]["limit"]


def test_judge_takes_the_limits_numbers():
    ok, checks = check.judge({"gap": 0.5, "failed": 0},
                             {"failed": 0, "gap": 1.0})
    assert ok and list(checks) == ["failed", "gap"]
    assert check.judge({"gap": 1.5, "failed": 0},
                       {"failed": 0, "gap": 1.0})[0] is False
    for numbers, limits in (({"gap": 0.5}, {"gap": 1.0}),
                            ({"gap": 0.5, "failed": 0}, {"failed": 0}),
                            ({"failed": 0}, {"failed": 0, "gap": 1.0})):
        with pytest.raises(ValueError):
            check.judge(numbers, limits)
