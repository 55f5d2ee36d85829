@echo off
rem OpenUtau/UTAU resampler launcher (Windows) for the PyTorch/CUDA port:
rem forwards argv to the goofer_tpu_torch CLI, which renders on the CUDA
rem card.  The checkout this script lives in goes first on PYTHONPATH.
setlocal
set "PYTHONPATH=%~dp0..;%PYTHONPATH%"
python -m goofer_tpu_torch.cli %*
