"""What crosses from the JAX reference into the port: config, instance,
state, model parameters and optimizer state.

A test carries the solver configuration (the ``dataclasses.asdict`` of a
reference ``SolverConfig``), the instance (the reference's
``SparseKP``/``DenseKP`` as numpy arrays, or numpy bytes through
``host_array_source``), solver state (numpy arrays: multipliers,
histograms, finalize carries), the LM stack's parameter tree (numpy
arrays; the reference draws its weights from ``jax.random``, which torch
cannot reproduce) and the optimizer's ``OptState`` into the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .types import DenseKP, SolverConfig, SparseKP

_DTYPES = {"float32": torch.float32}


def config_from_reference(fields: dict) -> SolverConfig:
    """A port ``SolverConfig`` from ``dataclasses.asdict`` of a reference one.

    ``dtype`` maps by name; ``use_kernels`` is dropped (the device picks
    the implementation). Every other field crosses as it is; an unknown
    field or an unsupported value raises ``ValueError``.
    """
    ported = {f.name for f in dataclasses.fields(SolverConfig)}
    kw = {}
    for name, value in fields.items():
        if name == "use_kernels":
            continue
        if name == "dtype":
            dname = np.dtype(getattr(value, "dtype", value)).name
            if dname not in _DTYPES:
                raise ValueError(f"dtype {dname} is not supported")
            kw["dtype"] = _DTYPES[dname]
        elif name in ported:
            kw[name] = value
        else:
            raise ValueError(f"unknown reference SolverConfig field {name!r}")
    return SolverConfig(**kw)


def instance_from_reference(kp, device="cpu"):
    """A port ``SparseKP``/``DenseKP`` on ``device`` from a reference one
    (any array type numpy can read): p, b, budgets as float32, sets as
    bool, caps as int64."""
    f32 = {f: torch.tensor(np.array(getattr(kp, f), np.float32)).to(device)
           for f in ("p", "b", "budgets")}
    if hasattr(kp, "sets"):
        return DenseKP(**f32,
                       sets=torch.tensor(np.array(kp.sets, bool)).to(device),
                       caps=torch.tensor(np.array(kp.caps, np.int64)).to(device))
    return SparseKP(**f32)


class SolverState(NamedTuple):
    """Solver state on a device; every field may be None."""

    lam: Optional[torch.Tensor]
    dprev: Optional[torch.Tensor]
    hist: Optional[torch.Tensor]
    top: Optional[torch.Tensor]
    fin: Optional[tuple]


def state_from_reference(device, lam=None, dprev=None, hist=None, top=None,
                         fin=None) -> SolverState:
    """Reference numpy state as float32 tensors on ``device``.

    ``lam``/``dprev`` (K,), ``hist`` (K, E+1), ``top`` (K,), ``fin`` the
    finalize carry (r, primal, dual_sum, lo, hi[, cons_hist, gain_hist]).
    Start the port's finalize from a converged ``lam`` with
    ``solve_streaming_host(src, cfg.replace(max_iters=0), lam0=state.lam)``.
    """
    def put(a):
        if a is None:
            return None
        return torch.tensor(np.array(a, np.float32)).to(device)

    fin_t = None if fin is None else tuple(put(a) for a in fin)
    return SolverState(put(lam), put(dprev), put(hist), put(top), fin_t)


_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf_to_torch(a, device):
    a = np.asarray(a)
    name = a.dtype.name
    if name not in _PARAM_DTYPES:
        raise ValueError(f"parameter dtype {name} is not supported")
    if name == "bfloat16":       # numpy has no bfloat16 of its own: carry the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _carry_tree(ref, want, path, device):
    """``ref`` (numpy leaves) as tensors on ``device``, checked leaf for
    leaf against the tree ``want`` (meta tensors: the port's layout)."""
    if isinstance(want, dict):
        if not isinstance(ref, dict) or sorted(ref) != sorted(want):
            raise ValueError(f"{path or 'params'}: keys "
                             f"{sorted(ref) if isinstance(ref, dict) else ref!r}, "
                             f"expected {sorted(want)}")
        return {k: _carry_tree(ref[k], want[k], f"{path}/{k}", device) for k in want}
    if isinstance(want, list):
        if not isinstance(ref, (list, tuple)) or len(ref) != len(want):
            raise ValueError(f"{path}: expected a list of {len(want)}")
        return [_carry_tree(r, w, f"{path}/{i}", device)
                for i, (r, w) in enumerate(zip(ref, want))]
    t = _leaf_to_torch(ref, device)
    if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(want.shape)} {want.dtype}")
    return t


def params_from_reference(tree, cfg, device="cpu"):
    """The port's LM parameter tree on ``device`` from the reference's
    (``jax.tree.map(np.asarray, params)``): the same nesting, values and
    dtypes. Raises ``ValueError`` where a key, shape or dtype differs from
    the port's own layout for ``cfg`` (``models.model.init`` on the meta
    device)."""
    from ..models import model

    return _carry_tree(tree, model.init(cfg, None, device="meta"), "", device)


def opt_state_from_reference(state, cfg, device="cpu"):
    """The port's ``optim.OptState`` on ``device`` from the reference's
    (``jax.tree.map(np.asarray, opt_state)``): ``step`` an int32 scalar,
    ``mu``, ``nu`` and ``err`` (None without compression) float32 trees of
    the parameters' layout for ``cfg``. Raises ``ValueError`` where a key,
    shape or dtype differs from ``optim.init_opt_state`` of the port's own
    layout (on the meta device)."""
    from ..models import model
    from ..optim import OptConfig, OptState, init_opt_state

    want = init_opt_state(model.init(cfg, None, device="meta"),
                          OptConfig(compress_grads=state.err is not None))
    step = np.asarray(state.step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: {step.shape} {step.dtype}, expected () int32")
    trees = {f: None if getattr(want, f) is None else
             _carry_tree(getattr(state, f), getattr(want, f), f, device)
             for f in ("mu", "nu", "err")}
    return OptState(step=torch.from_numpy(step.copy()).to(device), **trees)
