#!/usr/bin/env python3
"""Where the HTTP server's phrase render starts to pay, on one CUDA card.

    python3 tools/torch_server_burst.py [--sizes 1 2 3 4 5 6] [--reps 9]

For each burst size k it renders the first k notes of chip_smoke.py's
server burst (voice source, scale notes, plain ``t`` flags and the heavy
11-flag stack in turns, 60 + 250-550 ms) through the server's two paths,
in turns, WAVs written as the server writes them:

* per note: ``BurstBatcher._render_one`` for each request (the CLI's
  render, ``GooferResampler``);
* phrase: ``BurstBatcher._render_batched`` (``render_phrase(pcm16=True,
  bucket=True)``).

It prints the card line, one line per size (median wall ms of each path
over --reps runs after 2 warm ones, the device synchronized around each)
and one JSON line.  ``BurstBatcher.MIN_PHRASE`` is the smallest k from
which the phrase path is faster at every size measured.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from goofer_tpu_torch import config  # noqa: E402
from goofer_tpu_torch.sampler import server  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 3, 4, 5,
                                                             6])
    ap.add_argument("--reps", type=int, default=9)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_server_burst: CUDA is not available", file=sys.stderr)
        return 1
    os.environ[config.DEVICE_ENV] = "cuda"
    print(smoke.card_line())
    batcher = server.BurstBatcher()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        voice = REPO / "tests" / "golden" / "voice"
        shutil.copy(voice / "src.wav", tmp / "voice.wav")
        shutil.copy(voice / "src_features.goofy",
                    tmp / "voice_features.goofy")
        server.warmup(str(tmp))
        for k in opts.sizes:
            args = smoke.burst_args(tmp / "voice.wav", tmp, k, f"k{k}_")

            def per_note():
                for a in args:
                    batcher._render_one(server._Request(a))

            def batched():
                batcher._render_batched([server._Request(a) for a in args])

            # in turns, each measured with the other's state warm
            note_ms = [smoke._median_ms(per_note, opts.reps)]
            phrase_ms = [smoke._median_ms(batched, opts.reps)]
            phrase_ms.append(smoke._median_ms(batched, opts.reps))
            note_ms.append(smoke._median_ms(per_note, opts.reps))
            row = {"notes": k, "per_note_ms": note_ms,
                   "phrase_ms": phrase_ms,
                   "audio_s": sum((60 + 250 + 20 * j) / 1000.0
                                  for j in range(k))}
            rows.append(row)
            print(f"burst of {k}: per note {note_ms[0]:.3f} / "
                  f"{note_ms[1]:.3f} ms, phrase {phrase_ms[0]:.3f} / "
                  f"{phrase_ms[1]:.3f} ms ({row['audio_s']:.2f} s of audio)",
                  flush=True)
    faster = [r["notes"] for r in rows
              if max(r["phrase_ms"]) < min(r["per_note_ms"])]
    min_phrase = next((k for k in sorted(r["notes"] for r in rows)
                       if all(j in faster for j in opts.sizes if j >= k)),
                      None)
    print(json.dumps({"server_burst": rows, "min_phrase": min_phrase}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
