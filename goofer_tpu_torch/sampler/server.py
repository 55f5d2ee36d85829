"""HTTP resampler server, port 8572 (ref: SillySampler.py:1187-1224).

Port of goofer_tpu/sampler/server.py.  POST body = the resampler argument
string (two .wav paths + the last 11 fields); GET returns 200.  Errors
return 500 with a traceback body, like the reference.  Requests are
served from a thread pool, and every render runs on
``config.get_device()``: CUDA unless $GOOFER_TPU_TORCH_DEVICE names
another device.

An editor exporting a track fires one POST per note in a burst; requests
arriving within a short window merge into ONE batched phrase render
(sampler/phrase.render_phrase), which launches each hand kernel once per
pass for the whole burst.  Bursts below ``MIN_PHRASE`` notes and SE1
(editor) requests keep the per-request path; a failed phrase render is
logged, counted in ``fallback_count`` and falls back to per-note
rendering, so that error bodies stay per request.

What goofer_tpu does here for XLA and the port does not: it pads a burst
to a ladder of batch sizes so that compiled graphs are reused, and warms
a ladder of universal fallback graphs.  Eager PyTorch takes any batch
size, and padded rows would be wasted device work; the warm-up here
builds the kernels and renders one note and one burst.
"""
from __future__ import annotations

import logging
import re
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from socketserver import ThreadingMixIn

from goofer_tpu_torch import config

log = logging.getLogger("goofer_tpu_torch")


def split_arguments(input_string: str) -> list:
    """Split a POST body into [in.wav, out.wav, *last 11 fields]
    (ref: SillySampler.py:1187-1194)."""
    otherargs = input_string.split(" ")[-11:]
    file_path_strings = " ".join(input_string.split(" ")[:-11])
    parts = re.findall(r"([^\s]+\.wav)", file_path_strings)
    if len(parts) < 2:
        raise ValueError("Missing .wav file paths in POST string")
    return [parts[0], parts[1]] + otherargs


class ThreadedHTTPServer(ThreadingMixIn, HTTPServer):
    # a track export connects once per note, all at once: the default
    # listen backlog of 5 resets connections of a 16-note burst
    request_queue_size = 128


class _Request:
    __slots__ = ("args", "done", "error")

    def __init__(self, args):
        self.args = args
        self.done = threading.Event()
        self.error = None


class BurstBatcher:
    """Merge POSTs arriving within ``WINDOW_S`` into one batched phrase
    render.  Thread-safe; the batcher thread starts lazily."""

    WINDOW_S = 0.025
    MAX_BATCH = 64
    # the smallest burst that takes the phrase render: from 4 notes on it
    # beat the per-note renders at every size measured, below it tied or
    # lost (tools/torch_server_burst.py on an NVIDIA H100 80GB HBM3 at a
    # 700 W limit; PERF.md section 5)
    MIN_PHRASE = 4

    def __init__(self):
        self._cond = threading.Condition()
        self._pending: list[_Request] = []
        self._thread = None
        # observability: the size of each dispatched batch, and how many
        # phrase renders failed and fell back to per-note rendering
        self.batch_sizes: list[int] = []
        self.fallback_count = 0

    def submit(self, args) -> None:
        """Enqueue a 13-arg render; blocks until it completes.  Raises
        the per-request error, if any."""
        req = _Request(args)
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="goofer-burst-batcher")
                self._thread.start()
            self._pending.append(req)
            self._cond.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error

    # ------------------------------------------------------------------

    def _loop(self):
        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
            # collect the burst: one POST per note arrives within ms
            time.sleep(self.WINDOW_S)
            with self._cond:
                batch = self._pending[: self.MAX_BATCH]
                del self._pending[: len(batch)]
            if batch:
                self._render(batch)

    def _render(self, batch):
        self.batch_sizes.append(len(batch))
        if len(batch) >= self.MIN_PHRASE:
            try:
                self._render_batched(batch)
                return
            except Exception:
                # per-note fallback keeps error bodies per request; the
                # count and the log keep a phrase-path bug from hiding
                # behind it
                self.fallback_count += 1
                log.exception(
                    "burst phrase render failed for %d notes; "
                    "falling back to per-note rendering", len(batch))
        for req in batch:
            self._render_one(req)

    def _render_one(self, req):
        from goofer_tpu_torch.sampler.resampler import GooferResampler

        try:
            GooferResampler(*req.args)
        except Exception as e:
            req.error = e
        finally:
            req.done.set()

    def _render_batched(self, batch):
        from goofer_tpu_torch.sampler.phrase import NoteSpec, render_phrase
        from goofer_tpu_torch.sampler.resampler import acquire_features
        from goofer_tpu_torch.utils.audio_io import write_wav

        notes = [NoteSpec(r.args[0], *r.args[2:]) for r in batch]
        # bucket=True: notes of nearby lengths share one batched pass
        # (the bucketed render equals the exact one)
        outs = render_phrase(notes, pcm16=True, bucket=True)
        device = config.get_device()
        for req, out in zip(batch, outs):
            try:
                # memoized by the render's own planning
                sr = acquire_features(Path(req.args[0]),
                                      config.SAMPLER_N_FFT,
                                      config.SAMPLER_HOP, device)[4]
                write_wav(req.args[1], out, sr)
            except Exception as e:
                req.error = e
            finally:
                req.done.set()


_batcher = BurstBatcher()


class RequestHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()

    def do_POST(self):
        from goofer_tpu_torch.editor.gui import available_interactive_hook
        from goofer_tpu_torch.sampler.flags import NoteParams
        from goofer_tpu_torch.sampler.resampler import GooferResampler

        content_length = int(self.headers["Content-Length"])
        body = self.rfile.read(content_length).decode("utf-8")
        try:
            args = split_arguments(body)
            # SE1 opens the blocking editor when a display exists, the
            # CLI's contract (ref: SillySampler.py:581-611); those
            # requests keep the direct per-request path.  Everything else
            # merges into burst batches.
            params = NoteParams.from_args(*args[2:])
            if params.use_editor:
                GooferResampler(*args,
                                editor_hook=available_interactive_hook())
            else:
                _batcher.submit(args)
        except Exception:
            trcbk = traceback.format_exc()
            self.send_response(500)
            self.send_header("Content-type", "text/plain")
            self.end_headers()
            self.wfile.write(f"An error occurred.\n{trcbk}".encode("utf-8"))
            return
        self.send_response(200)
        self.end_headers()


def warmup(tmp: str) -> None:
    """Build the kernels and render one note and one burst in ``tmp``:
    the build (one nvcc per kernel) and the first calls of cuFFT and
    cuDNN would otherwise land on an editor's first note.  The note's
    synthetic source has no cache, so it runs the analysis too."""
    import os

    import numpy as np

    from goofer_tpu_torch.ops.cuda import (
        _build,
        burg_kernel,
        cascade_kernel,
        lpc_roots_kernel,
        pulse_kernel,
        viterbi_kernel,
    )
    from goofer_tpu_torch.sampler.phrase import NoteSpec, render_phrase
    from goofer_tpu_torch.sampler.resampler import GooferResampler
    from goofer_tpu_torch.utils.audio_io import write_wav

    if config.get_device().type == "cuda":
        _build.build_all([
            pulse_kernel.KERNEL, cascade_kernel.KERNEL, viterbi_kernel.KERNEL,
            lpc_roots_kernel.KERNEL, burg_kernel.KERNEL])
    sr = 44100
    src = os.path.join(tmp, "w.wav")
    t = np.arange(int(0.4 * sr)) / sr
    y = 0.3 * np.sign(np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    write_wav(src, y, sr)
    GooferResampler(src, os.path.join(tmp, "out.wav"), "C4", 100, "", 0,
                    300, 60, 0, 100, 0, "!120", "AA")
    render_phrase([NoteSpec(src, "C4", length=250 + 17 * i, consonant=60,
                            flags=f"t{10 + i}") for i in range(4)],
                  pcm16=True, bucket=True)


def _background_warmup():
    """``warmup`` in a daemon thread; a failure only means the first
    request pays for it."""
    import tempfile

    try:
        with tempfile.TemporaryDirectory(prefix="goofer_warmup_") as tmp:
            warmup(tmp)
        print("Warmup done: kernels built, a note and a burst rendered.",
              flush=True)
    except Exception:
        print(f"Warmup failed (the first request will pay for it):\n"
              f"{traceback.format_exc()}", flush=True)


def run(port: int = config.SERVER_PORT, warmup: bool = True):
    """Serve until interrupted.  Raises at once if the render device is
    not available (CUDA without $GOOFER_TPU_TORCH_DEVICE=cpu)."""
    device = config.get_device()
    httpd = ThreadedHTTPServer(("", port), RequestHandler)
    if warmup:
        threading.Thread(target=_background_warmup, daemon=True).start()
    print(f"Starting HTTP server on port {port} ({device})...")
    httpd.serve_forever()
