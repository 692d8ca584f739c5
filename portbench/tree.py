"""Parameter trees: nested dicts of tensors, addressed by a path of keys,
the form both the program and the reference hold a model's weights in."""

from __future__ import annotations


def get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def put(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def leaves(tree, prefix=()):
    """(path, tensor) of every leaf, keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]
