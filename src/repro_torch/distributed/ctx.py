"""Ambient activation-sharding policy and mesh topology.

Model code stays mesh-agnostic: it calls ``constrain(x, kind)`` at the
reference's pins (the residual stream after each block, the logits, the
MoE dispatch buffer); the policy (mesh + rules) is installed by the engine
or trainer around the model call, and the call is the identity when no
policy is installed or ``x`` is a plain tensor, so the single-device path
pays one thread-local read.  On a DTensor it redistributes to the policy's
placements.

:func:`use_mesh` installs an ambient ``(mesh, rules)`` pair that
mesh-aware consumers (``serve.Engine``, ``Model.init``, ``Trainer``) pick
up through :func:`current_mesh` / :func:`current_rules` when they are not
handed one.

:func:`activation_policy` also lets plain tensors made inside the model
(``torch.arange`` positions, masks) meet DTensors as replicated values
(DTensor's ``implicit_replication``): every rank makes the same ones.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

_TLS = threading.local()


def _sh():
    # imported on use: the models import this module, and the rules' module
    # imports the models' param templates
    from repro_torch.distributed import sharding
    return sharding


class ActivationPolicy:
    def __init__(self, mesh, rules):
        self.mesh = mesh
        self.rules = rules

    def spec_for(self, kind: str, rank: int, batch_size: int
                 ) -> Optional[tuple]:
        sh = _sh()
        r = self.rules
        ba = r.batch_axes
        bspec = (sh._entry(ba) if batch_size % sh.axis_size(self.mesh, ba) == 0
                 else None)
        seq = r.sequence_axis
        if kind == "hidden":        # (B, S, D)
            return (bspec, seq, None)
        if kind == "tokens":        # (B, S)
            return (bspec, seq)
        if kind == "logits":        # (B, S, V) or (B, V)
            ta = r.tensor_axis
            if rank == 3:
                # under SP the tensor axis is on the sequence dim already
                return (bspec, seq, None if seq == ta else ta)
            return (bspec, ta)
        if kind == "batch_only":    # (B, ...)
            return (bspec,) + (None,) * (rank - 1)
        if kind == "moe_dispatch":  # (B, E, C, D): experts on the tensor axis
            return (bspec, r.tensor_axis, None, None)
        return None


def set_policy(policy: Optional[ActivationPolicy]):
    _TLS.policy = policy


def get_policy() -> Optional[ActivationPolicy]:
    return getattr(_TLS, "policy", None)


@contextlib.contextmanager
def activation_policy(mesh, rules):
    """Run model code on ``mesh``: ``constrain`` pins to ``rules``, and
    plain tensors meet DTensors as replicated."""
    old = get_policy()
    set_policy(ActivationPolicy(mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        set_policy(old)


def set_mesh(mesh, rules=None):
    _TLS.mesh = mesh
    _TLS.rules = rules


def current_mesh():
    """The ambient mesh installed by :func:`use_mesh` (None: one device)."""
    return getattr(_TLS, "mesh", None)


def current_rules():
    """The ambient :class:`ShardingRules` installed by :func:`use_mesh`."""
    return getattr(_TLS, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh, rules=None):
    """Install ``(mesh, rules)`` as the ambient topology.

    Derives ``rules`` with ``rules_for_mesh`` when omitted, and installs
    the matching activation policy.  ``use_mesh(None)`` clears the ambient
    topology for the scope: inside an outer ``use_mesh(mesh)`` it restores
    single-device behaviour (e.g. to build an unsharded engine to compare
    with)."""
    old = (current_mesh(), current_rules())
    if mesh is None:
        old_policy = get_policy()
        set_mesh(None, None)
        set_policy(None)
        try:
            yield None
        finally:
            set_mesh(*old)
            set_policy(old_policy)
        return
    rules = rules or _sh().rules_for_mesh(mesh)
    set_mesh(mesh, rules)
    try:
        with activation_policy(mesh, rules):
            yield rules
    finally:
        set_mesh(*old)


def constrain(x, kind: str):
    """Pin ``x`` to the policy's layout: identity with no policy or for a
    plain tensor, else ``x.redistribute`` (nothing when it is there)."""
    pol = get_policy()
    if pol is None or not isinstance(x, DTensor):
        return x
    spec = pol.spec_for(kind, x.dim(), x.shape[0])
    if spec is None:
        return x
    sh = _sh()
    placements = sh.placements_for(pol.mesh, spec)
    if sh.same_layout(pol.mesh, x.placements, placements):
        return x
    return x.redistribute(pol.mesh, placements)
