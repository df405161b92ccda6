"""Faults planted in the program's timed path, to show that the
comparison catches each kind a cell can have.

Each fault is a context manager that replaces one function of
``repro_torch`` for as long as it is entered and restores it after:

* ``state_unchanged`` (fit): every round's grad/hess taken at the base
  margin, as if no round had updated the margin;
* ``half_batch`` (fit): the histograms and leaf sums over the first half
  of the rows only, the leaves the mean of that half; (score): the second
  half of each request's rows left unscored;
* ``grid_frozen`` (fit): the first grid proposed kept for every later
  round, as if the proposal were not re-drawn;
* ``answer_altered`` (fit): one leaf of every fourth tree changed by 1 %
  where growth returns it; (score): one margin of each request changed
  by 1 % where the forest sum returns it.

There is one card, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import torch

FIT = ("state_unchanged", "half_batch", "grid_frozen",
       "answer_altered")
SCORE = ("half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(module, name, wrap):
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _half(gh: torch.Tensor) -> torch.Tensor:
    out = gh.clone()
    out[gh.shape[0] // 2:] = 0
    return out


def _bump(value: torch.Tensor) -> torch.Tensor:
    return value * 1.01 + 1e-3


@contextlib.contextmanager
def planted(kind: str, name: str):
    """Plant fault ``name`` in the path of a ``kind`` of cell ('fit' or
    'score')."""
    from repro_torch.core import boosting, proposal, tree
    from repro_torch.kernels import ops

    with contextlib.ExitStack() as stack:
        if kind == "fit" and name == "state_unchanged":
            def wrap(orig):
                def grad_hess(margin, y, objective):
                    base = boosting._base_score(y, objective)
                    return orig(torch.full_like(margin, base), y, objective)
                return grad_hess
            stack.enter_context(_patched(boosting, "grad_hess", wrap))
        elif kind == "fit" and name == "half_batch":
            stack.enter_context(_patched(
                ops, "hist_levels", lambda orig: lambda b, n, gh, s, **kw:
                orig(b, n, _half(gh), s, **kw)))
            stack.enter_context(_patched(
                ops, "leaf_sums", lambda orig: lambda node, gh, *a, **kw:
                orig(node, _half(gh), *a, **kw)))
        elif kind == "fit" and name == "grid_frozen":
            first: list = []

            def wrap(orig):
                def propose(*a, **kw):
                    if not first:
                        first.append(orig(*a, **kw))
                    return first[0]
                return propose
            stack.enter_context(_patched(proposal, "propose", wrap))
        elif kind == "fit" and name == "answer_altered":
            calls = [0]

            def wrap(orig):
                def build_tree(*a, **kw):
                    out = orig(*a, **kw)
                    calls[0] += 1
                    if calls[0] % 4:
                        return out
                    t = out[0]
                    leaf = t.leaf_value.clone()
                    leaf[0] = _bump(leaf[0])
                    return (t._replace(leaf_value=leaf), *out[1:])
                return build_tree
            stack.enter_context(_patched(tree, "build_tree", wrap))
        elif kind == "score" and name == "half_batch":
            def wrap(orig):
                def forest_sum(values, *a, **kw):
                    n = values.shape[0]
                    out = orig(values[:n // 2], *a, **kw)
                    return torch.cat([out, out.new_zeros(n - n // 2)])
                return forest_sum
            stack.enter_context(_patched(ops, "forest_sum", wrap))
        elif kind == "score" and name == "answer_altered":
            def wrap(orig):
                def forest_sum(*a, **kw):
                    out = orig(*a, **kw)
                    out[out.shape[0] // 3] = _bump(out[out.shape[0] // 3])
                    return out
                return forest_sum
            stack.enter_context(_patched(ops, "forest_sum", wrap))
        else:
            raise ValueError(f"no fault {name!r} for a {kind!r} cell")
        yield
