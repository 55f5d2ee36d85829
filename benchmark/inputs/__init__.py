"""Inputs on disk (harness.py, part 1): ``inputs/<name>.py``, named by a
configuration's ``inputs``, builds what a run reads before its set-up.

It defines ``build(config) -> inputs``: an object with ``close()``, which
removes what it built.  The cell's entry and generator are given it.
Where a configuration names none, ``benchmark/voicebank.py`` builds the
note render's voicebank.
"""
