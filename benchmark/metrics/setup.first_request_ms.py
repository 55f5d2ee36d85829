"""Set-up the program owns: ms of the process's first request, a warm-up
request that loads the kernels and warms the device
(``setup.first_request`` of ``utils/profiling.py``, recorded whether
spans are on or not), read from the program's totals after the device
stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    prog = progtrace.stretch(t)
    if prog is None:
        return None
    calls, ns, _ = prog["total"].spans.get("setup.first_request", (0, 0, 0))
    return ns / 1e6 if calls else None
