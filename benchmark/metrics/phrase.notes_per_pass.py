"""The phrase layer (``sampler/phrase.py:render_group``): notes per
batched pass."""


def read(t):
    passes = t.rec.calls["render_group"]
    if not passes:
        return None
    return t.rec.notes["render_group"] / passes
