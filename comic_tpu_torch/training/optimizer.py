"""Optimizer: TF1 Adam or SGD + freezing + CNN gradient multiplier +
per-leaf clipping; counterpart of comic_tpu/training/optimizer.py
(reference model_base.py:834-883 and :387-401 create_train_op).

comic_tpu composes an optax chain:

    [zero frozen grads] -> [cnn multiplier] -> [per-leaf clip] ->
        masked(tf1_adam -> scale_by_learning_rate)   (or sgd, momentum 0.9)

``Optimizer`` computes the same update for the trainable leaves. A frozen
leaf (a freeze scope, and BatchNorm moving statistics always) is set to
``requires_grad=False``: autograd computes no gradient for it, so the
frozen CNN of the decoder stage runs no conv backward (comic_tpu's
stop_gradient), and it has no moments and no update (optax.masked).
``state_dict`` writes, and ``load_state_dict`` reads, the nested dict that
flax writes for that optax chain, so a full checkpoint resumes in either
package.
"""

from __future__ import annotations

import re
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import params as bridge

Params = Dict[str, Any]
Path = Tuple[str, ...]


def path_string(path: Sequence[str]) -> str:
    """('encoder', 'cnn', 'Conv2d_1a_7x7', 'weights') ->
    'encoder/cnn/Conv2d_1a_7x7/weights'."""
    return "/".join(str(p) for p in path)


def tree_items(tree: Params, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of a nested dict, depth first in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_get(tree: Params, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _map_paths(fn: Callable[[Path, Any], Any], tree: Params,
               prefix: Path = ()) -> Params:
    return {k: (_map_paths(fn, v, prefix + (k,)) if isinstance(v, dict)
                else fn(prefix + (k,), v)) for k, v in tree.items()}


def _normalize_scopes(scopes: Optional[str]) -> List[str]:
    """Reference scopes like 'Model/encoder/cnn' -> root-less paths."""
    out = []
    for sc in (scopes or "").split(","):
        sc = sc.strip()
        if sc.startswith("Model/"):
            sc = sc[len("Model/"):]
        if sc and sc != "Model":
            out.append(sc)
    return out


# BatchNorm moving statistics are buffers, never trainable variables
# (model_base.py:72-76): even cnn_finetune (freeze_scopes='') keeps them.
_ALWAYS_FROZEN = re.compile(r"moving_(mean|variance)")


def trainable_mask(params: Params, freeze_scopes: Optional[str]) -> Params:
    """True where trainable: frozen are the paths a freeze scope matches by
    regex search (reference filter_variables, model_base.py:834-848) and
    the BatchNorm moving statistics."""
    pats = [re.compile(sc) for sc in _normalize_scopes(freeze_scopes)]

    def leaf(path, _):
        s = path_string(path)
        return not (_ALWAYS_FROZEN.search(s) or any(p.search(s)
                                                      for p in pats))

    return _map_paths(leaf, params)


def scope_mask(params: Params, include: str) -> Params:
    """True for leaves under paths matching ``include`` (regex search)."""
    pat = re.compile(include)
    return _map_paths(lambda path, _: bool(pat.search(path_string(path))),
                      params)


def masked_l2_loss(params: Params, mask: Params, decay: float
                   ) -> torch.Tensor:
    """decay * sum ||v||^2 / 2 over the trainable leaves
    (model_base.py:367-381, ops.py:184-190)."""
    leaves = [v for path, v in tree_items(params) if tree_get(mask, path)]
    if decay <= 0 or not leaves:
        return torch.zeros(())
    return decay * sum(0.5 * v.float().square().sum() for v in leaves)


def set_trainable(params: Params, mask: Params) -> None:
    """requires_grad on the trainable leaves only (in place)."""
    for path, v in tree_items(params):
        v.requires_grad_(bool(tree_get(mask, path)))


class Optimizer:
    """comic_tpu's ``build_optimizer`` chain over the trainable leaves of a
    parameter tree; ``step(params)`` applies one update from their
    ``.grad`` in place and clears it.

    Adam is tf.train.AdamOptimizer's (model_base.py:858-867): epsilon is
    added to the square root of the RAW second moment and both bias
    corrections fold into the step size,
    ``lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v)+eps)``. The learning rate
    of update n (from 0) is ``learning_rate(n)``, as optax's
    scale_by_learning_rate counts.
    """

    def __init__(self, params: Params, learning_rate: Callable[[int], float],
                 *, optimiser: str = "adam", adam_epsilon: float = 1e-2,
                 beta1: float = 0.9, freeze_scopes: Optional[str] = None,
                 cnn_grad_multiplier: float = 1.0,
                 clip_gradient_norm: float = 0.0,
                 cnn_scope: str = "encoder/cnn"):
        if optimiser not in ("adam", "sgd"):
            raise ValueError("Unknown optimiser.")
        self.optimiser = optimiser
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = beta1, 0.999, adam_epsilon
        self.multiplier = cnn_grad_multiplier
        self.clip = clip_gradient_norm or 0.0
        self.mask = trainable_mask(params, freeze_scopes)
        self.paths = [p for p, m in tree_items(self.mask) if m]
        self.all_trainable = len(self.paths) == sum(1 for _ in
                                                    tree_items(self.mask))
        cnn = scope_mask(params, cnn_scope)
        self._cnn_idx = [i for i, p in enumerate(self.paths)
                         if tree_get(cnn, p)]
        self.count = 0
        zeros = [torch.zeros_like(tree_get(params, p)) for p in self.paths]
        self.moments: Dict[str, List[torch.Tensor]] = (
            {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros]}
            if optimiser == "adam" else {"trace": zeros})

    @torch.no_grad()
    def step(self, params: Params) -> None:
        leaves = [tree_get(params, p) for p in self.paths]
        grads = [v.grad if v.grad is not None else torch.zeros_like(v)
                 for v in leaves]
        if self.multiplier != 1.0:
            for i in self._cnn_idx:
                grads[i] = grads[i] * self.multiplier
        if self.clip > 0:
            # tf.clip_by_norm of EACH gradient (slim create_train_op), not
            # a global-norm clip
            norms = torch.stack([g.square().sum() for g in grads]).sqrt()
            scales = (self.clip / norms.clamp(min=1e-20)).clamp(max=1.0)
            grads = torch._foreach_mul(grads, list(scales.unbind()))
        lr = self.learning_rate(self.count)
        self.count += 1
        if self.optimiser == "adam":
            mu, nu = self.moments["mu"], self.moments["nu"]
            # b * m + (1 - b) * g, each product rounded, as optax does
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads,
                                                       1.0 - self.b1))
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - self.b2))
            c = np.float32(self.count)
            scale = (np.sqrt(np.float32(1.0) - np.float32(self.b2) ** c)
                     / (np.float32(1.0) - np.float32(self.b1) ** c))
            updates = torch._foreach_mul(mu, float(scale))
            denom = torch._foreach_sqrt(nu)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(updates, denom)
        else:  # optax.sgd(momentum=0.9): trace = g + 0.9 * trace
            trace = self.moments["trace"]
            torch._foreach_mul_(trace, 0.9)
            torch._foreach_add_(trace, grads)
            updates = trace
        torch._foreach_add_(leaves, torch._foreach_mul(updates, -lr))
        for v in leaves:
            v.grad = None

    # --- the optax state, in the layout flax writes for it -----------------

    def _moment_tree(self, params: Params, values: List[torch.Tensor]
                     ) -> Params:
        """The params-shaped tree of one moment, {} (optax.MaskedNode) at
        the frozen leaves, in comic_tpu's layout as numpy."""
        by_path = dict(zip(self.paths, values))
        tree = _map_paths(lambda path, _: by_path.get(path, {}), params)
        return bridge.to_jax_tree(tree)

    def state_dict(self, params: Params) -> Params:
        count = np.asarray(self.count, np.int32)
        if self.optimiser == "adam":
            first = {"count": count,
                     "mu": self._moment_tree(params, self.moments["mu"]),
                     "nu": self._moment_tree(params, self.moments["nu"])}
        else:
            first = {"trace": self._moment_tree(params,
                                                self.moments["trace"])}
        inner: Params = {"0": first, "1": {"count": count}}
        if not self.all_trainable:
            inner = {"inner_state": inner}
        chain: List[Params] = []
        if not self.all_trainable:
            chain.append({})  # zero the frozen grads: optax.EmptyState
        if self.multiplier != 1.0:
            chain.append({})
        if self.clip > 0:
            chain.append({})
        chain.append(inner)
        return {str(i): s for i, s in enumerate(chain)}

    def load_state_dict(self, state: Params, params: Params) -> None:
        """Take the counts and moments of ``state`` (a flax state dict of
        the same chain, e.g. from comic_tpu) onto the card or CPU of
        ``params``. Raises ValueError on a different chain or shapes."""
        _check_structure(state, self.state_dict(params))
        inner = state[str(len(state) - 1)]
        if not self.all_trainable:
            inner = inner["inner_state"]
        counts = {int(inner["1"]["count"])}
        if self.optimiser == "adam":
            counts.add(int(inner["0"]["count"]))
        if len(counts) != 1:
            raise ValueError(f"optimizer counts differ: {sorted(counts)}")
        self.count = counts.pop()
        device = tree_get(params, self.paths[0]).device
        for name in self.moments:
            tree = bridge.from_jax_tree(inner["0"][name], device=device)
            self.moments[name] = [tree_get(tree, p).float().contiguous()
                                  for p in self.paths]


def _check_structure(got, want, path: str = "") -> None:
    """Raise unless ``got`` has ``want``'s nested keys and leaf shapes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(
                f"optimizer state differs at '{path or '/'}': keys "
                f"{sorted(got) if isinstance(got, dict) else type(got)} vs "
                f"{sorted(want)}")
        for k in want:
            _check_structure(got[k], want[k], f"{path}/{k}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"optimizer state leaf {path} has shape "
                         f"{np.shape(got)}, expected {np.shape(want)}")
