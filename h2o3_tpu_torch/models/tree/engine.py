"""Dense heap-order tree storage and ensemble scoring of the port
(h2o3_tpu/models/tree/engine.py: TreeArrays, stack_trees, predict_ensemble).

Node 0 is the root and the children of node i are 2i+1 and 2i+2; every
node carries the value a row takes when it stops there. Scoring is a
fixed-depth gather walk in plain PyTorch: the JAX package scores in XLA
with no Pallas kernel, so there is none to port here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Trees walked together in one batch of gathers; bounds the (trees, rows)
# temporaries at large row counts.
_TREE_BATCH = 16


@dataclass
class TreeArrays:
    """One ensemble's trees as stacked tensors in heap node order."""
    col: torch.Tensor        # (T, nodes) int32, -1 = leaf
    thr: torch.Tensor        # (T, nodes) f32: numeric split goes right if x > thr
    na_left: torch.Tensor    # (T, nodes) bool
    value: torch.Tensor      # (T, nodes) f32
    depth: int
    cover: torch.Tensor | None = None     # (T, nodes) f32 training weight
    # categorical SET splits: per-node go-right bitset over level ids, the
    # JAX package's uint32 words held in int64, and the categorical columns
    catbits: torch.Tensor | None = None   # (T, nodes, W) int64
    col_is_cat: np.ndarray | None = None  # (C,) bool, host metadata

    @property
    def ntrees(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "TreeArrays":
        mv = (lambda t: None if t is None else t.to(device))  # noqa: E731
        return TreeArrays(col=mv(self.col), thr=mv(self.thr),
                          na_left=mv(self.na_left), value=mv(self.value),
                          depth=self.depth, cover=mv(self.cover),
                          catbits=mv(self.catbits),
                          col_is_cat=self.col_is_cat)


def stack_trees(tree_list, depth) -> TreeArrays:
    """Stack per-tree (col, thr, nal, val[, cover]) tensors into one
    ensemble."""
    cover = None
    if len(tree_list[0]) >= 5:
        cover = torch.stack([t[4] for t in tree_list])
    return TreeArrays(col=torch.stack([t[0] for t in tree_list]),
                      thr=torch.stack([t[1] for t in tree_list]),
                      na_left=torch.stack([t[2] for t in tree_list]),
                      value=torch.stack([t[3] for t in tree_list]),
                      depth=depth, cover=cover)


def _leaf_values(XT, col, thr, nal, val, catbits, iscat, depth):
    """Walk a batch of trees; returns each tree's value per row (Tb, n)."""
    Tb = col.shape[0]
    n = XT.shape[1]
    dev = XT.device
    tix = torch.arange(Tb, device=dev)[:, None]
    node = torch.zeros((Tb, n), dtype=torch.int64, device=dev)
    nb = None if catbits is None else catbits.shape[-1] * 32
    for _ in range(depth):
        c = col[tix, node].long()
        leafish = c < 0
        cc = c.clamp(min=0)
        x = torch.gather(XT, 0, cc)
        isna = torch.isnan(x)
        right = x > thr[tix, node]
        if catbits is not None:
            code = torch.nan_to_num(x).clamp(0, nb - 1).long()
            word = catbits[tix, node, code // 32]
            bit = (word >> (code % 32)) & 1
            right = torch.where(iscat[cc], bit == 1, right)
        right = torch.where(isna, ~nal[tix, node], right)
        child = 2 * node + 1 + right.long()
        node = torch.where(leafish, node, child)
    return val[tix, node]


def predict_ensemble(X: torch.Tensor, trees: TreeArrays,
                     weights=None) -> torch.Tensor:
    """sum_t weight_t * value[t, leaf_t(row)] for X (n, C) f32 NaN-NA.
    Categorical SET-split nodes route by bitset membership of the level id.
    Trees are summed in order, like the JAX package's scan."""
    dev = X.device
    T = trees.ntrees
    tw = (torch.as_tensor(weights, dtype=torch.float32, device=dev)
          if weights is not None else torch.ones(T, device=dev))
    has_cat = (trees.catbits is not None and trees.col_is_cat is not None
               and bool(np.any(np.asarray(trees.col_is_cat))))
    iscat = (torch.as_tensor(np.asarray(trees.col_is_cat, bool), device=dev)
             if has_cat else None)
    XT = X.t().contiguous()
    out = torch.zeros(X.shape[0], dtype=torch.float32, device=dev)
    for t0 in range(0, T, _TREE_BATCH):
        sl = slice(t0, min(T, t0 + _TREE_BATCH))
        vals = _leaf_values(XT, trees.col[sl], trees.thr[sl],
                            trees.na_left[sl], trees.value[sl],
                            trees.catbits[sl] if has_cat else None, iscat,
                            trees.depth)
        for k in range(vals.shape[0]):
            out = out + tw[t0 + k] * vals[k]
    return out
