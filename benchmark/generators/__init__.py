"""Requests (harness.py, parts 2 and 3): ``generators/<name>.py``, named
by a traffic mix's ``generator``, draws a run's requests from its seed.

It defines ``generator(mix, inputs, seed)``, whose result has:

- ``warmup()``: the set-up's requests, drawn from the seed's
  ``traffic.WARMUP`` stream;
- ``window()``: the window's requests without end, drawn from
  ``traffic.WINDOW``;
- optionally ``prepare(request, paths)``: writes the file that item
  ``j`` of ``request`` reads at ``paths[j]``, a folder of the request's
  own, before the request's clock starts; the harness removes the folder
  once the request has been checked.

A request is a list of items.  No request repeats an earlier one of the
run, warm-up included.  Where a mix names none, ``benchmark/traffic.py``
draws fresh notes.
"""
