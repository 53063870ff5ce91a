"""The train step and the training loop.

``make_train_step`` builds the step function: gradients by autograd
(accumulated in f32 over microbatches), optional int8 gradient compression
with error feedback, AdamW with f32 masters.  It is functional over
``TrainState`` as the reference's is: the state passed in is left as it
was.  ``Trainer`` drives it over the data pipeline with checkpoints, a
straggler deadline, and one host transfer for the logged losses.  Every
family trains; a vlm or audio batch carries its extra inputs
(``image_embeds`` / ``encoder_embeds``) beside the tokens and labels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core.device import DeviceLike
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import Model
from repro_torch.models.params import map_tree, map_trees, tree_leaves
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.profiling import annotate
from repro_torch.train.loss import lm_loss


class TrainState(NamedTuple):
    step: torch.Tensor                        # int32 0-d
    params: Any
    opt: AdamWState
    compression: Optional[comp.CompressionState]


def init_train_state(model: Model, optimizer: AdamW, seed: int = 0,
                     use_compression: bool = False,
                     device: DeviceLike = None, mesh=None,
                     rules=None) -> TrainState:
    """A fresh state; with ``mesh`` (else the ambient one) every leaf is
    made on the mesh, leaf by leaf, placed by :func:`state_shardings`."""
    params = model.init(seed, device=device, mesh=mesh, rules=rules)
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        step = sh.distribute(step, leaf.device_mesh,
                             (Replicate(),) * leaf.device_mesh.ndim)
    return TrainState(
        step=step, params=params, opt=optimizer.init(params),
        compression=comp.init_state(params) if use_compression else None)


def state_shardings(mesh, rules, model: Model,
                    use_compression: bool = False) -> TrainState:
    """The :class:`~repro_torch.distributed.sharding.Layout` of every leaf
    of a train state: params, the AdamW moments and masters and the
    compression residual by the rules (FSDP under ``rules_for_mesh``'s
    default), step and count replicated."""
    ps = sh.param_placements(mesh, rules, model.template)
    rep = sh.Layout.of(mesh, ())
    return TrainState(
        step=rep, params=ps,
        opt=AdamWState(count=rep, m=ps, v=ps, master=ps),
        compression=comp.CompressionState(residual=ps) if use_compression
        else None)


def place_state(state: TrainState, layouts: TrainState) -> TrainState:
    """``state`` with every leaf on its layout (a no-op for leaves already
    there; a plain or differently placed state is re-sharded)."""
    def tree(x, lay):
        return None if x is None else sh.distribute_tree(x, lay)
    return TrainState(
        step=tree(state.step, layouts.step),
        params=tree(state.params, layouts.params),
        opt=AdamWState(*(tree(getattr(state.opt, f), getattr(layouts.opt, f))
                         for f in AdamWState._fields)),
        compression=None if state.compression is None else
        comp.CompressionState(residual=tree(state.compression.residual,
                                            layouts.compression.residual)))


def abstract_train_state(model: Model, optimizer: AdamW,
                         use_compression: bool = False) -> TrainState:
    """Shapes, strides and dtypes of a train state (``meta`` tensors): the
    template ``Checkpointer.restore`` fills.  A ``kmajor`` leaf is laid
    out K-major here too, in the params and in every tree shaped like
    them."""
    def leaf(_p, spec):
        t = torch.empty(spec.shape[::-1] if spec.kmajor else spec.shape,
                        dtype=getattr(torch, spec.dtype or model.cfg.dtype),
                        device="meta")
        return t.t() if spec.kmajor else t
    ap = map_tree(leaf, model.template)
    return TrainState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        params=ap, opt=optimizer.abstract_state(ap),
        compression=comp.abstract_state(ap) if use_compression else None)


def _value_and_grad(model: Model, params, batch):
    """(loss, metrics, grads): the loss of ``params`` on ``batch`` and its
    gradient, one leaf per parameter in the parameter's dtype."""
    live = map_tree(lambda _p, p: p.detach().requires_grad_(), params)
    loss, metrics = lm_loss(model, live, batch)
    it = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_tree(lambda _p, _x: next(it), live))


def make_train_step(model: Model, optimizer: AdamW, *,
                    microbatches: int = 1,
                    use_compression: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``microbatches`` > 1 splits the batch along dim 0 and sums the
    microbatches' gradients in f32 (each divided by their number); the
    metrics are then the loss and the optimizer's, as the reference's."""

    def compute_grads(params, batch):
        if microbatches == 1:
            return _value_and_grad(model, params, batch)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} "
                             "microbatches")
        size = b // microbatches
        acc = loss = None
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            l, _, grads = _value_and_grad(model, params, mb)
            if acc is None:
                acc = map_tree(lambda _p, p: torch.zeros_like(
                    p, dtype=torch.float32), params)
                loss = torch.zeros((), dtype=torch.float32, device=l.device)
            acc, = map_trees(lambda a, g: (a + g.float() / microbatches,),
                             acc, grads)
            loss = loss + l / microbatches
        return loss, {}, acc

    def train_step(state: TrainState, batch) -> tuple:
        loss, metrics, grads = compute_grads(state.params, batch)
        new_comp = state.compression
        if use_compression:
            grads, new_comp = comp.compress_grads(grads, state.compression)
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params)
        return (TrainState(state.step + 1, new_params, new_opt, new_comp),
                {"loss": loss, **metrics, **opt_metrics})

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, cache):
        with torch.no_grad():
            return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(params, tokens, cache, offset):
        with torch.no_grad():
            return model.decode_step(params, tokens, cache, offset)
    return decode_step


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    microbatches: int = 1
    use_compression: bool = False
    step_deadline_s: Optional[float] = None   # straggler watchdog


class Trainer:
    """Runs the train step over ``data_iter(step)`` (a ``TokenPipeline``).

    With ``mesh`` (else the ambient ``distributed.use_mesh`` one) the state
    is placed by :func:`state_shardings` under ``rules`` (default
    ``rules_for_mesh(mesh)``: FSDP over ``data``, tensor parallel over
    ``model``), each batch is split over the data axes, and the step runs
    under the activation policy."""

    def __init__(self, model: Model, optimizer: AdamW, data_iter,
                 cfg: TrainerConfig, checkpointer=None, mesh=None,
                 rules=None):
        self.model = model
        self.optimizer = optimizer
        self.data_iter = data_iter
        self.cfg = cfg
        self.checkpointer = checkpointer
        if mesh is None:
            mesh, rules = dctx.current_mesh(), rules or dctx.current_rules()
        self.mesh = mesh
        self.rules = None
        self.layouts = None
        if mesh is not None:
            self.rules = rules or sh.rules_for_mesh(mesh)
            self.layouts = state_shardings(mesh, self.rules, model,
                                           cfg.use_compression)
        self._step = make_train_step(model, optimizer,
                                     microbatches=cfg.microbatches,
                                     use_compression=cfg.use_compression)
        #: each step's wall (s) of the last ``run``, under ``step_deadline_s``
        self.step_walls = []

    def run(self, state: TrainState, start_step: int = 0):
        """Run to ``total_steps``; returns (state, history [(step, loss)]).
        Data keyed by step makes a restart replay the same run exactly.

        Logged losses stay on the device while the loop runs; one transfer
        at the end reads them all, so logging never stalls the queue.  Only
        ``step_deadline_s`` syncs each step (to measure its wall), and a
        checkpoint reads the state back to the host."""
        logged_steps, logged_losses = [], []
        self.step_walls = []
        if self.mesh is not None:
            state = place_state(state, self.layouts)
        for step_idx in range(start_step, self.cfg.total_steps):
            batch = self.data_iter(step_idx)
            t0 = time.perf_counter()
            with annotate("train.step"), self._on_mesh():
                if self.mesh is not None:
                    batch = sh.distribute_tree(batch, sh.batch_shardings(
                        self.mesh, self.rules, batch))
                state, metrics = self._step(state, batch)
            if self.cfg.step_deadline_s is not None:
                if metrics["loss"].is_cuda:
                    # deliberate sync: the watchdog times the finished step
                    # analysis: allow(TP001)
                    torch.cuda.synchronize(metrics["loss"].device)
                dt = time.perf_counter() - t0
                self.step_walls.append(dt)
                if dt > self.cfg.step_deadline_s:
                    # surfaced for the launcher, which decides what to do
                    metrics = dict(metrics, straggler_flag=dt)
            if (step_idx + 1) % self.cfg.log_every == 0:
                logged_steps.append(step_idx + 1)
                logged_losses.append(metrics["loss"])
            if (self.checkpointer is not None
                    and (step_idx + 1) % self.cfg.checkpoint_every == 0):
                self.checkpointer.save(step_idx + 1, state)
        # the run's ONE device-to-host transfer: every logged loss at once
        # analysis: allow(TP001)
        losses = (torch.stack([sh.full(x) for x in logged_losses]).cpu()
                  .tolist() if logged_losses else [])
        return state, list(zip(logged_steps, losses))

    def _on_mesh(self):
        """The step's activation policy on the mesh (nothing without)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return dctx.activation_policy(self.mesh, self.rules)
