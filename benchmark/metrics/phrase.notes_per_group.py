"""The phrase layer (``sampler/phrase.py:render_group``), read inside the
program: notes per ``phrase.group`` span, one batched pass, in the device
stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    prog = progtrace.stretch(t)
    if prog is None:
        return None
    calls, _, notes = prog["delta"].spans.get("phrase.group", (0, 0, 0))
    return notes / calls if calls else None
