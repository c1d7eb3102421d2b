"""Nested-container helpers: the port's stand-in for ``jax.tree_util``.

State is plain nested containers of tensors: dicts, lists, tuples and
NamedTuples (``TrainState``, ``AdamWState``).  Flattening follows JAX's
rules exactly — NamedTuple fields in declaration order, dict keys sorted,
``None`` an empty subtree — and ``keystr`` renders the same path strings
(``.params['layers']['attn']['wq']``, ``.opt.step``), so snapshot
manifests written by either framework carry identical keys in identical
order.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Tuple

_PATH_TOKEN = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """-> [(path suffix, child)] or None when ``x`` is a leaf."""
    if _is_namedtuple(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, dict):
        return [(f"[{k!r}]", x[k]) for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(x)]
    return None


def flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """-> [(keystr path, leaf)] in ``jax.tree_util`` flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for suffix, child in kids:
        out.extend(flatten_with_keys(child, prefix + suffix))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return type(tree)(tree_map(fn, c, *(r[i] for r in rest))
                      for i, c in enumerate(tree))


def unflatten_like(tree, values: dict):
    """Rebuild ``tree``'s structure with leaf ``k`` taken from ``values[k]``
    (keys are keystr paths).  Raises KeyError for a missing path."""
    return _build(tree, "", values)


def _build(node, prefix: str, values: dict):
    # module-level, not a closure: a recursive nested function is a
    # reference cycle that would keep ``values`` (whole states) alive
    # until the cycle collector runs
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        if prefix not in values:
            raise KeyError(f"missing leaf {prefix}")
        return values[prefix]
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, f), f"{prefix}.{f}", values)
                            for f in node._fields))
    if isinstance(node, dict):
        return {k: _build(node[k], f"{prefix}[{k!r}]", values)
                for k in sorted(node)}
    return type(node)(_build(c, f"{prefix}[{i}]", values)
                      for i, c in enumerate(node))


def parse_keystr(path: str) -> List[str]:
    """``.opt.m['embed']`` -> ['opt', 'm', 'embed'] (attribute names, dict
    keys and list indices alike, as strings)."""
    parts, pos = [], 0
    for m in _PATH_TOKEN.finditer(path):
        if m.start() != pos:
            raise ValueError(f"bad key path {path!r}")
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(path):
        raise ValueError(f"bad key path {path!r}")
    return parts
