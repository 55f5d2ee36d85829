"""SillySampler-compatible CLI (ref: SillySampler.py:1226-1275).

Port of goofer_tpu/cli.py.  Four modes, selected as the reference does:

* no arguments: the HTTP resampler server on :8572 (sampler/server.py);
* every argument a ``.goofy``: the voicing editor's batch mode
  (editor/gui.py:edit_goofy_files), one window per file;
* one argument, an existing folder or audio file (WAV, FLAC, AIFF or
  MP3): extract and cache the features of every audio file under it;
* 13 arguments: render one note (a source without a ``.goofy`` cache is
  analysed first and the cache saved beside it), one ``request`` of
  utils/profiling.py; ``SE1`` opens the voicing editor mid-render when a
  display exists.

All run on CUDA unless $GOOFER_TPU_TORCH_DEVICE names another device;
without CUDA they fail rather than falling back.  A render logs how many
times this process launched each hand kernel (0 on the CPU, where the
plain versions run).
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path

from goofer_tpu_torch import config
from goofer_tpu_torch.ops.cuda import launch_counts
from goofer_tpu_torch.utils import profiling

log = logging.getLogger("goofer_tpu_torch")

HELP_STRING = (
    "Usage:\n"
    "  python -m goofer_tpu_torch.cli                          "
    "(HTTP server on :8572)\n"
    "  python -m goofer_tpu_torch.cli in.wav out.wav pitch velocity flags\n"
    "           offset(ms) length(ms) consonant(ms) cutoff(ms)\n"
    "           volume(%) modulation(%) !tempo pitch_string\n"
    "  python -m goofer_tpu_torch.cli <folder or audio file>   "
    "(extract features)\n"
    "  python -m goofer_tpu_torch.cli a.goofy [b.goofy ...]    "
    "(voicing editor)\n\n"
    "Example:\n"
    "  python -m goofer_tpu_torch.cli in.wav out.wav C4 100 g0 0 1000 0 "
    "700 100 0 !120 AA"
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    log.info("goofer_tpu_torch SillySampler %s (surface-compatible with %s)",
             config.VERSION, config.REFERENCE_CLI_VERSION)
    if not argv:
        from goofer_tpu_torch.sampler import server

        try:
            server.run()
        except TypeError:
            log.info(HELP_STRING)
        except Exception:
            log.exception("Server failed")
            return 1
        return 0
    log.info("Args: %s (count=%d)", argv, len(argv))
    if all(Path(a).suffix.lower() == ".goofy" for a in argv):
        from goofer_tpu_torch.editor import gui

        try:
            gui.edit_goofy_files(argv)
        except Exception:
            log.exception("Failed to edit")
            return 1
        return 0
    if len(argv) == 1 and Path(argv[0]).exists():
        from goofer_tpu_torch.sampler.batch_extract import (
            extract_features_recursive,
        )

        log.info("Scanning folder: %s", argv[0])
        try:
            extract_features_recursive(Path(argv[0]))
        except Exception:
            log.exception("Failed to extract features")
            return 1
        log.info("Done extracting features.")
        return 0
    if len(argv) < 13:
        log.error("Argument parsing failed: expected 13 arguments but got "
                  "%d", len(argv))
        log.error(HELP_STRING)
        return 1
    from goofer_tpu_torch.editor import gui
    from goofer_tpu_torch.sampler.resampler import GooferResampler

    with profiling.request(notes=1):
        try:
            # SE1 blocks on the voicing editor mid-render like the
            # reference (SillySampler.py:581-611) whenever a display is
            # available
            GooferResampler(*argv[:13],
                            editor_hook=gui.available_interactive_hook())
        except Exception:
            log.exception("Failed to render")
            return 1
        if log.isEnabledFor(logging.INFO):
            log.info("Kernel launches: %s", ", ".join(
                f"{name} {n}" for name, n in launch_counts().items()))
    return 0


if __name__ == "__main__":
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    sys.exit(main())
