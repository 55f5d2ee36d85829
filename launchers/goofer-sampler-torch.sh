#!/bin/sh
# OpenUtau/UTAU resampler launcher for the PyTorch/CUDA port: forwards all
# arguments to the goofer_tpu_torch CLI, which renders on the CUDA card
# (point OpenUtau's resampler path at this script).  The checkout this
# script lives in goes first on PYTHONPATH, so it runs from any directory.
ROOT="$(cd "$(dirname "$0")/.." && pwd)"
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
export PYTHONPATH
exec python3 -m goofer_tpu_torch.cli "$@"
