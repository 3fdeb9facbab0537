"""The JAX package's leaves of the port's parameter and state trees.

The JAX package stacks a model's layers: its ``params["layers"]`` is a dict
of ``[n_layers, ...]`` arrays, one leaf each, walked by ``lax.scan``.  The
port keeps the layers as a list of per-layer dicts.  What works leaf by leaf
in the JAX package must see the stacked leaf, not one layer's tensor:
AdamW's decoupled decay (``ndim >= 2``: a stacked norm scale ``[L, D]`` is
decayed), the one scale a leaf of gradient compression, and the keys and
shapes of a checkpoint.

``leaves(tree)`` lists the JAX leaves of a port tree as :class:`Leaf`
``(key, parts, stacked)``: ``key`` is the JAX package's path joined by
``SEP`` (a dict key as itself, a NamedTuple field as ``.name``, a list
index as its number, the spelling of ``jax.tree_util`` paths), and a
stacked leaf's ``parts`` are its layers' tensors in order.  A list whose
items are all dicts is a stack of layers (``layers``, each entry of
``macros``), except under the key ``tail`` (``UNSTACKED``): the JAX
package keeps a block pattern's remainder layers an unstacked list, so its
leaves are ``tail/0/mixer/w_lin``, a tail's norm scale is 1-D and AdamW
does not decay it.  Any other list or tuple is indexed.
``map_leaves(fn, tree)`` rebuilds the tree with ``fn(leaf)``'s parts in
place of each leaf's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["SEP", "UNSTACKED", "Leaf", "leaves", "map_leaves"]

SEP = "/"
UNSTACKED = ("tail",)  # keys whose list of layer dicts is indexed


class Leaf(NamedTuple):
    key: str
    parts: List[Any]  # tensors or arrays; one unless stacked
    stacked: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        one = tuple(self.parts[0].shape)
        return (len(self.parts),) + one if self.stacked else one

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_stack(x, path: Tuple[str, ...]) -> bool:
    return (isinstance(x, list) and len(x) > 0
            and all(isinstance(v, dict) for v in x)
            and not (path and path[-1] in UNSTACKED))


def _walk(tree, path: Tuple[str, ...], out: Dict[str, List[Any]],
          stacked: Dict[str, bool], in_stack: bool) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, path + (str(k),), out, stacked, in_stack)
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            _walk(v, path + ("." + f,), out, stacked, in_stack)
    elif _is_stack(tree, path):
        if in_stack:
            raise ValueError(f"nested layer stacks at {SEP.join(path)}")
        for layer in tree:
            _walk(layer, path, out, stacked, True)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out, stacked, in_stack)
    else:
        key = SEP.join(path)
        out.setdefault(key, []).append(tree)
        stacked[key] = in_stack


def leaves(tree) -> List[Leaf]:
    """The JAX leaves of ``tree``, in the order of its dicts."""
    out: Dict[str, List[Any]] = {}
    stacked: Dict[str, bool] = {}
    _walk(tree, (), out, stacked, False)
    return [Leaf(k, v, stacked[k]) for k, v in out.items()]


def _rebuild(tree, path: Tuple[str, ...], new: Dict[str, List[Any]],
             layer: Optional[int]):
    if isinstance(tree, dict):
        return {k: _rebuild(v, path + (str(k),), new, layer)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_rebuild(v, path + ("." + f,), new, layer)
                            for f, v in zip(tree._fields, tree)])
    if _is_stack(tree, path):
        return [_rebuild(v, path, new, i) for i, v in enumerate(tree)]
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, path + (str(i),), new, layer)
                          for i, v in enumerate(tree))
    parts = new[SEP.join(path)]
    return parts[0 if layer is None else layer]


def map_leaves(fn: Callable[[Leaf], List[Any]], tree):
    """``tree`` with each JAX leaf's parts replaced by ``fn(leaf)`` (a list
    of as many parts)."""
    new = {}
    for leaf in leaves(tree):
        parts = list(fn(leaf))
        if len(parts) != len(leaf.parts):
            raise ValueError(f"{leaf.key}: {len(parts)} parts for "
                             f"{len(leaf.parts)}")
        new[leaf.key] = parts
    return _rebuild(tree, (), new, None)
