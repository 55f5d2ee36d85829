"""Issuing work to several devices from one process.

The mesh layer (parallel/), the phrase renderer and the batched
extraction cut a batch's rows into contiguous shards (``shard_bounds``)
and run each shard on a slot's device (``run_on_slots``).  This module
imports only torch, so that the analysis and sampler layers can split a
batch without loading the render stack that parallel/ builds on.
"""
from __future__ import annotations

import contextlib
import contextvars
from concurrent.futures import ThreadPoolExecutor

import torch


def shard_bounds(n: int, parts: int) -> list:
    """``parts`` contiguous (lo, hi) ranges covering range(n), sizes
    differing by at most one (the first n % parts one longer); ranges past
    n are empty."""
    q, r = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def device_scope(dev: torch.device):
    """``torch.cuda.device(dev)`` for a card; nothing for another device."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def run_on_slots(slots: list, tasks: list) -> list:
    """Run ``tasks[i]``, a list of zero-argument callables, on device
    ``slots[i]``; returns each slot's list of results.

    One worker per distinct device that has tasks runs its slots' tasks
    in slot order under device_scope; with one such device (a single
    card, or a mesh that repeats it) that worker is the caller's thread.
    Slots that share a device share its stream, and eager launches hold
    the interpreter lock, so threads for them would only add switching.
    Every worker is joined, then the first exception raised in any worker
    is raised here: a failed shard is never skipped.  A worker thread
    runs in a copy of the caller's context, so its spans join the
    caller's request (utils/profiling.py)."""
    results = [[] for _ in slots]
    by_device: dict = {}
    for i, t in enumerate(tasks):
        if t:
            by_device.setdefault(slots[i], []).append(i)

    def work(dev, idx):
        with device_scope(dev):
            for i in idx:
                results[i] = [task() for task in tasks[i]]

    if len(by_device) <= 1:
        for dev, idx in by_device.items():
            work(dev, idx)
        return results
    with ThreadPoolExecutor(max_workers=len(by_device)) as pool:
        futures = [pool.submit(contextvars.copy_context().run, work, dev,
                               idx)
                   for dev, idx in by_device.items()]
    for future in futures:
        future.result()
    return results


def synchronize(devices) -> None:
    """Wait for every card among ``devices``, each once."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
