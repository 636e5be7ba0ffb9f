"""Nested parameter trees (dicts with sorted keys, lists, tuples) flattened
to a list of tensors and rebuilt — what the reference gets from JAX's
pytrees.

The recursion is in module-level functions on purpose: a nested recursive
closure refers to itself through its cell, so a closure that also held the
leaves would keep every tensor it saw alive until the garbage collector
ran (at full width, a whole set of gradients per training step).
"""
from __future__ import annotations

import functools


def _walk(t, out: list):
    if isinstance(t, dict):
        return {k: _walk(t[k], out) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(x, out) for x in t)
    out.append(t)
    return len(out) - 1


def _fill(skeleton, vals):
    if isinstance(skeleton, dict):
        return {k: _fill(v, vals) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(x, vals) for x in skeleton)
    return vals[skeleton]


def flatten(tree):
    """``(leaves, rebuild)``: the tree's leaves in a fixed order (dict keys
    sorted) and a function that builds a tree of the same structure from a
    list of new leaves."""
    leaves: list = []
    skeleton = _walk(tree, leaves)
    return leaves, functools.partial(_fill, skeleton)


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree):
    ls, rebuild = flatten(tree)
    return rebuild([fn(x) for x in ls])
