"""Entries (harness.py, part 4): ``entries/<name>.py``, named by a
configuration's ``entry``, calls the program as its users do.

It defines ``Entry(config, inputs)`` with:

- ``call(request, paths) -> bool``: the timed call; ``paths[j]`` is
  where item ``j``'s file lies, the WAV a note renders to or the file a
  preparing generator wrote for it;
- optionally ``outputs(request, paths)``, untimed: for each item its
  output file and the seconds of audio it produced or consumed, as
  ``(path, seconds)``, or None where it left nothing.  An item with no
  output or no audio fails its request.  Without it each item's output
  is its WAV, and the WAV's size gives the audio.

The default comparer (``check.py``) also reads ``PHRASES``, ``QUANTIZE``
and ``noise_key(index)``.
"""
