"""Tree helpers (port of ``repro/utils.py``: ``tree_cast``, ``global_norm``,
``all_finite``) and the leaf grouping that the optimizer state uses.

A tree is a tensor, or a dict, list or tuple of trees.  Dicts are walked in
sorted key order, as ``jax.tree_util`` flattens them, so sums over leaves
run in the reference's order.

``LeafGroups`` lays a parameter tree out as the reference stacks it.  The
reference keeps each leaf of ``params["blocks"]`` (and an encoder-decoder's
``params["enc_blocks"]``) stacked over the layers
(one (L, ...) array per leaf name and block-pattern position); the port
keeps a list of per-layer dicts.  A group is one leaf name: the leaf of
every layer at one pattern position for a block leaf, the one leaf
otherwise.  Each group lives in one flat buffer, and the
per-layer tensors are views of it, so a whole group is one tensor for the
optimizer (the LAMB trust ratio is taken over it, as over a stacked leaf)
and one launch for a kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

Path = Tuple[str, ...]


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves, called in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating leaf to ``dtype``.  A leaf already in ``dtype``
    is returned as it is (no copy)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, in fp32: the sum of each leaf's sum of
    squares, added leaf by leaf in flatten order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack([f.to(flags[0].device) for f in flags]).all()


class LeafGroups:
    """The grouping of a parameter tree's leaves by name (see the module
    docstring).  ``paths`` are in the reference's flatten order.  A block
    leaf's path starts with its list's key, "blocks" (or an
    encoder-decoder's "enc_blocks"), and names no layer; for a decoder
    ``cfg`` whose block pattern has P > 1 positions (gemma2's local and
    global layers: 2) it names the position, ``("blocks", "1", "mixer",
    "wq")``, since the reference stacks each position's layers apart:
    layer i is block i // P at position i % P.  (Positions sort as the
    reference's tuple while there are at most 10: jamba's 8 are the
    most.)  The encoder's layers are grouped over ``cfg.enc_block_pattern``
    in the same way (whisper's 12 ``enc_blocks/0/mixer/wq`` are one group
    and one LAMB trust ratio).  Without ``cfg`` (BERT, or a tree that is
    no model) the blocks are one position."""

    LISTS = ("blocks", "enc_blocks")

    def __init__(self, tree: dict, cfg=None):
        # a decoder's tree (transformer.init_model: ... "final_norm",
        # "lm_head") is stacked by the reference per pattern position (a
        # tuple of dicts), BERT's in one dict; a decoder's list of one
        # position has its leaves named under position 0
        # ("blocks/0/mixer/wq", "enc_blocks/0/mixer/wq")
        self._named_position = "final_norm" in tree
        self.positions: Dict[str, int] = {}
        self._n_layers: Dict[str, int] = {}
        for key in self.LISTS:
            if key not in tree:
                continue
            if cfg is None or cfg.is_encoder_only:
                self.positions[key] = 1
            else:
                self.positions[key] = len(cfg.enc_block_pattern
                                          if key == "enc_blocks"
                                          else cfg.block_pattern)
        self.shapes: Dict[Path, torch.Size] = {}
        self.layers: Dict[Path, int] = {}     # 0 for a leaf outside blocks
        for path, leaf in _walk(tree, ()):
            if path[0] in self.positions:
                continue
            self.shapes[path] = leaf.shape
            self.layers[path] = 0
        for key, positions in self.positions.items():
            layers = tree[key]
            if len(layers) % positions:
                raise ValueError(f"{len(layers)} {key} layers do not tile a "
                                 f"{positions}-position block pattern")
            self._n_layers[key] = len(layers)
            for i, layer in enumerate(layers):
                for path, leaf in _walk(layer, self._prefix(key,
                                                            i % positions)):
                    if self.shapes.setdefault(path, leaf.shape) != \
                            leaf.shape:
                        raise ValueError(f"{path}: layers differ in shape")
                    self.layers[path] = len(layers) // positions
        self.paths: List[Path] = sorted(self.shapes)

    def _prefix(self, key: str, pos: int) -> Path:
        return (key,) if self.positions[key] == 1 else (key, str(pos))

    def _split(self, path: Path) -> Tuple[int, Path]:
        """(position, the leaf's path inside its layer) of a block path."""
        if self.positions[path[0]] == 1:
            return 0, path[1:]
        return int(path[1]), path[2:]

    def name(self, path: Path) -> str:
        """The reference's key path of a group's (stacked) leaf, as its
        checkpoints name it: ``blocks/mixer/wq`` for BERT,
        ``blocks/<position>/mixer/wq`` for a decoder (and
        ``enc_blocks/<position>/...`` for an encoder-decoder's encoder),
        ``embed/tok`` outside the blocks."""
        if self.layers[path] and self._named_position and \
                self.positions[path[0]] == 1:
            path = (path[0], "0") + path[1:]
        return "/".join(path)

    def numel(self, path: Path) -> int:
        return math.prod(self.shapes[path]) * max(self.layers[path], 1)

    def flatten(self, tree: dict, dtype=torch.float32
                ) -> Dict[Path, torch.Tensor]:
        """One new flat buffer per group holding the tree's values."""
        out = {}
        for path in self.paths:
            leaves = self._leaves(tree, path)
            out[path] = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
        return out

    def tree(self, flats: Dict[Path, torch.Tensor]) -> dict:
        """The parameter tree whose leaves are views of ``flats``."""
        out: dict = {key: [{} for _ in range(n)]
                     for key, n in self._n_layers.items() if n}
        for path in self.paths:
            flat, shape = flats[path], self.shapes[path]
            if self.layers[path]:
                key, positions = path[0], self.positions[path[0]]
                pos, leaf = self._split(path)
                per = flat.view(self.layers[path], -1)
                for i in range(self.layers[path]):
                    _set(out[key][i * positions + pos], leaf,
                         per[i].view(shape))
            else:
                _set(out, path, flat.view(shape))
        return out

    def stacked(self, flats: Dict[Path, torch.Tensor]
                ) -> Dict[Path, torch.Tensor]:
        """Each group as the reference's leaf: (L, *shape) for a block leaf,
        else the leaf's shape (views)."""
        return {p: flats[p].view((self.layers[p],) + tuple(self.shapes[p])
                                 if self.layers[p] else self.shapes[p])
                for p in self.paths}

    def _leaves(self, tree: dict, path: Path) -> List[torch.Tensor]:
        if self.layers[path]:
            pos, leaf = self._split(path)
            return [_get(layer, leaf) for layer in
                    tree[path[0]][pos::self.positions[path[0]]]]
        return [_get(tree, path)]


def _walk(tree, prefix: Path):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree: dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
