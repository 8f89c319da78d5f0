"""Nested-dict pytrees with the JAX package's leaf paths.

The checkpoint format addresses every leaf by its ``jax.tree_util.
keystr`` path (``['layers']['attn']['wq']``), and a checkpoint written
by one package restores in the other only if both spell paths the same
way. These helpers reproduce that flattening for the trees the port
uses — dicts (keys visited in sorted order, as JAX does), named tuples
(``.field``, as for the optimizer's ``QMoment``), lists and tuples
(``[0]``), ``None`` as an empty subtree, anything else a leaf.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

from repro_torch.api.errors import RestoreError


def _named(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _named(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    return [(f"[{i}]", v) for i, v in enumerate(node)]


def _rebuild(node, children):
    """A container of ``node``'s type holding ``children`` (in order)."""
    if _named(node):
        return type(node)(*children)
    return type(node)(children)


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf), ...]`` in JAX's flattening order."""
    out: List[Tuple[str, Any]] = []

    def rec(node, prefix: str) -> None:
        if node is None:
            return
        if _is_node(node):
            for key, child in _children(node):
                rec(child, prefix + key)
        else:
            out.append((prefix, node))

    rec(tree, "")
    return out


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (and of ``rest``, which
    share its structure), keeping the container types."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def fill_like(template, by_path: Dict[str, Any]):
    """Rebuild a tree with ``template``'s structure from a path->leaf
    map (the checkpoint's view of an entry)."""
    def rec(node, prefix: str):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(node[k], prefix + f"[{k!r}]") for k in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [rec(v, prefix + key)
                                   for key, v in _children(node)])
        if prefix not in by_path:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return by_path[prefix]
    return rec(template, "")


# keystr renders dict keys with repr(), which picks double quotes when
# the key itself contains a single quote — accept both forms
_DICT_KEY = re.compile(
    r"\[(?:'((?:[^'\\]|\\.)*)'|\"((?:[^\"\\]|\\.)*)\")\]")


def tree_from_paths(by_path: Dict[str, Any]) -> Any:
    """Rebuild a nested dict from keystr paths, no template required.

    Inverse of ``flatten_with_paths`` for dict-only trees (paths like
    ``['queue']['0']['prompt']``). State whose *structure* is data — the
    serving scheduler's request queue, whose shape differs checkpoint to
    checkpoint — restores through this instead of ``fill_like``. The
    path "" (a bare leaf) returns the leaf itself."""
    if list(by_path) == [""]:
        return by_path[""]
    out: Dict[str, Any] = {}
    for path, leaf in by_path.items():
        keys = []
        pos = 0
        for m in _DICT_KEY.finditer(path):
            if m.start() != pos:
                break
            k = m.group(1) if m.group(1) is not None else m.group(2)
            keys.append(k.replace("\\'", "'").replace('\\"', '"')
                         .replace("\\\\", "\\"))
            pos = m.end()
        if pos != len(path) or not keys:
            raise RestoreError(f"non-dict path {path!r}; use fill_like with "
                               "a structural template instead")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out
