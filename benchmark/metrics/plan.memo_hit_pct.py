"""The phrase plan memo (``sampler/phrase.py:_plan_memo``), read inside
the program: its ``plan.memo.hit`` counter over hits and misses, in
percent, in the device stretch (progtrace.py).  Fresh traffic reads 0."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    prog = progtrace.stretch(t)
    if prog is None:
        return None
    c = prog["delta"].counters
    hit, miss = c.get("plan.memo.hit", 0), c.get("plan.memo.miss", 0)
    if hit + miss == 0:
        return None
    return 100.0 * hit / (hit + miss)
