"""The comparison (harness.py, part 5): ``comparers/<name>.py``, named by
a configuration's ``comparer``, judges the kept outputs once the window
has closed; it may use the card.

It defines ``worst(records, inputs, config, entry, device) -> dict``:
the worst of each of its numbers over ``records``, each a kept item
(``item``, its ``request``, its ``index`` there, ``audio_s``, the output
at ``path`` and, where the generator prepared the request, what the item
read at ``input``); ``entry`` is the cell's entry class.  The
configuration's ``limits`` hold each number and ``failed``, and no
other.

It also defines ``control(records, inputs, config, entry, device) ->
dict``, which ``control.py`` runs and the benchmark's runs never do: its
plain reference computed one precision below the configuration's writes
each record's output at ``path``, in the program's place, and ``worst``
judges it; the control has to come out as not correct.

Where a configuration names none, ``benchmark/check.py`` compares notes
with the plain reference.
"""
