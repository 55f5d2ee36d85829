"""The hand kernels behind the op layer (``ops/pulse.py``'s pulse passes,
``ops/scan_iir.py:cascade``, ``ops/filters.py``'s blurs): the sum of
each op-level call's least time over the sum of the device time its call
launched, in percent.

Each call into a kernel wrapper, looked up where the op module looks it
up, opens a ``bench.op.<kind>`` range in the attributed stretch; every
device kernel launched inside counts toward it, whatever implements the
op.  The least time is max(bytes / 3.35 TB/s, float32 operations / 67
TFLOP/s) counted from the call's shapes (yardstick.py), each input read
once and each output written once; a pulse pass's operations follow its
own onsets, counted after the stretch from its inputs with the frozen
onset tables.
"""
from __future__ import annotations

from benchmark import yardstick

HOOKS = (("goofer_tpu_torch.ops.pulse", "pulse_accumulate", "pulse"),
         ("goofer_tpu_torch.ops.scan_iir", "one_pole_cascade", "cascade"),
         ("goofer_tpu_torch.ops.filters", "gaussian_blur", "blur"))


def install(t):
    import importlib

    import torch

    t.op_calls = []

    for module, attr, kind in HOOKS:
        owner = importlib.import_module(module)
        fn = getattr(owner, attr)

        def wrapper(*args, _fn=fn, _kind=kind, **kwargs):
            if not t.rec.ranges:
                return _fn(*args, **kwargs)
            t.op_calls.append((_kind, args))
            with torch.profiler.record_function(f"bench.op.{_kind}"):
                return _fn(*args, **kwargs)

        t.rec.patch(owner, attr, wrapper)


def _work(kind, args):
    if kind == "pulse":
        from benchmark.reference.ops.pulse import pulse_pass_tables

        f0, gate, *rest = args
        max_overlap, min_spacing = rest[-2:]
        tables = pulse_pass_tables(f0, gate, *rest[:-2], min_spacing)
        pairs, onsets = yardstick.live_pulse_work(tables, max_overlap)
        return yardstick.pulse_work(f0.shape[0], f0.shape[1],
                                    gate is not None, pairs, onsets)
    if kind == "cascade":
        x, alpha, order = args[:3]
        alpha_rows = x.shape[0] if alpha.ndim == 2 else 1
        return yardstick.cascade_work(x.shape[0], x.shape[1], alpha_rows,
                                      max(1, int(order)))
    x, taps = args[:2]
    return yardstick.blur_work(x.numel(), len(taps))


def read(t):
    calls = getattr(t, "op_calls", None)
    device_s = sum((t.attributed or {}).get("op_device_s", {}).values())
    if not calls or device_s <= 0:
        return None
    bound = sum(yardstick.bound_s(*_work(kind, args)) for kind, args in calls)
    return 100.0 * bound / device_s
