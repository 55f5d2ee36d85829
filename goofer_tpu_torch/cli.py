"""SillySampler-compatible CLI, 13-argument render mode
(ref: SillySampler.py:1226-1275).

Port of goofer_tpu/cli.py.  The render runs on CUDA unless
$GOOFER_TPU_TORCH_DEVICE names another device; without CUDA it fails
rather than falling back.  The other modes of the JAX CLI (HTTP server,
voicing-editor batch, folder feature extraction) are not ported yet and
exit with rc 1.
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path

from goofer_tpu_torch import config

log = logging.getLogger("goofer_tpu_torch")

HELP_STRING = (
    "Usage:\n"
    "  python -m goofer_tpu_torch.cli in.wav out.wav pitch velocity flags\n"
    "           offset(ms) length(ms) consonant(ms) cutoff(ms)\n"
    "           volume(%) modulation(%) !tempo pitch_string\n\n"
    "Example:\n"
    "  python -m goofer_tpu_torch.cli in.wav out.wav C4 100 g0 0 1000 0 "
    "700 100 0 !120 AA"
)


def _unported_mode(argv) -> str | None:
    if not argv:
        return "HTTP server mode"
    if all(Path(a).suffix.lower() == ".goofy" for a in argv):
        return "voicing-editor mode"
    if (len(argv) == 1 and Path(argv[0]).exists()
            and Path(argv[0]).suffix.lower() != ".goofy"):
        return "folder feature extraction"
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    log.info("goofer_tpu_torch SillySampler %s (surface-compatible with %s)",
             config.VERSION, config.REFERENCE_CLI_VERSION)
    mode = _unported_mode(argv)
    if mode is not None:
        log.error("%s is not yet ported to goofer_tpu_torch; use "
                  "goofer_tpu.cli", mode)
        return 1
    log.info("Args: %s (count=%d)", argv, len(argv))
    if len(argv) < 13:
        log.error("Argument parsing failed: expected 13 arguments but got "
                  "%d", len(argv))
        log.error(HELP_STRING)
        return 1
    from goofer_tpu_torch.sampler.resampler import GooferResampler

    try:
        GooferResampler(*argv[:13])
    except Exception:
        log.exception("Failed to render")
        return 1
    return 0


if __name__ == "__main__":
    logging.basicConfig(format="%(message)s", level=logging.INFO)
    sys.exit(main())
