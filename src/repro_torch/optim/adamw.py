"""AdamW with f32 master weights, functional over the port's parameter
trees (nested dicts of tensors).

State per parameter leaf: ``m`` and ``v``, the f32 moments, and
``master``, an f32 copy of the parameter (a copy even when the parameter
is f32, never an alias), each laid out as its parameter (a K-major leaf
stays K-major in every tree).  ``update`` returns new trees and leaves its
inputs as they were.  Trees are matched by path (``map_trees``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.models.params import (in_layout_of, map_tree, map_trees,
                                       tree_leaves)


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32 0-d: updates taken
    m: Any
    v: Any
    master: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at update ``count`` (int32 0-d tensor)."""
        lr = self.learning_rate
        if callable(lr):
            return lr(count)
        return torch.full((), lr, dtype=torch.float32, device=count.device)

    def init(self, params) -> AdamWState:
        def zeros(_p, p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32,
                              device=tree_leaves(params)[0].device),
            m=map_tree(zeros, params), v=map_tree(zeros, params),
            master=map_tree(lambda _p, p: torch.empty_like(
                p, dtype=torch.float32).copy_(p.detach()), params))

    def abstract_state(self, abstract_params) -> AdamWState:
        """Shapes, strides and dtypes only (``meta`` tensors): a restore
        template."""
        def f32(_p, p):
            return torch.empty_like(p, dtype=torch.float32, device="meta")
        return AdamWState(
            count=torch.empty((), dtype=torch.int32, device="meta"),
            m=map_tree(f32, abstract_params), v=map_tree(f32, abstract_params),
            master=map_tree(f32, abstract_params))

    def update(self, grads, state: AdamWState, params):
        """-> (new_params, new_state, metrics {"grad_norm", "lr"})."""
        count = state.count + 1
        gnorm = global_norm(grads)
        scale = None
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        lr = self.lr(count)

        def leaf(p, g, mm, vv, master):
            # b1 mm + (1 - b1) g;  b2 vv + ((1 - b2) g) g;  (mm / c1) /
            # (sqrt(vv / c2) + eps) (+ wd master);  master - lr step: the
            # same operations in the same order, each temporary reused in
            # place, so that two leaf-sized temporaries at most are live
            # beside the new state (a 525 M-element embedding's f32 is 2.1 GB)
            g = g.float()
            if scale is not None:
                g = g * scale
            mm = torch.mul(mm, b1).add_(torch.mul(g, 1 - b1))
            t = torch.mul(g, 1 - b2).mul_(g)
            del g
            vv = torch.mul(vv, b2).add_(t)
            del t
            den = torch.div(vv, c2).sqrt_().add_(self.eps)
            step = torch.div(mm, c1).div_(den)
            del den
            if self.weight_decay and master.ndim >= 2:  # no decay on norms/bias
                step.add_(master * self.weight_decay)
            master = torch.sub(master, step.mul_(lr))
            # in the parameter's layout, whatever the gradient's
            mm, vv, master = (in_layout_of(p, t) for t in (mm, vv, master))
            return in_layout_of(p, master, p.dtype), mm, vv, master

        new_p, m, v, master = map_trees(leaf, params, grads, state.m, state.v,
                                        state.master)
        return new_p, AdamWState(count, m, v, master), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))
