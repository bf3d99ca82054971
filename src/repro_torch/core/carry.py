"""What crosses from the JAX reference into the port: config, instance,
state and model parameters.

A test carries the solver configuration (the ``dataclasses.asdict`` of a
reference ``SolverConfig``), the instance (the reference's
``SparseKP``/``DenseKP`` as numpy arrays, or numpy bytes through
``host_array_source``), solver state (numpy arrays: multipliers,
histograms, finalize carries) and the LM stack's parameter tree (numpy
arrays; the reference draws its weights from ``jax.random``, which torch
cannot reproduce) into the port.
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


def params_from_reference(tree, cfg, device="cpu"):
    """The port's LM parameter tree on ``device`` from the reference's
    (``jax.tree.map(np.asarray, params)``): the same nesting, values and
    dtypes. Raises ``ValueError`` where a key, shape or dtype differs from
    the port's own layout for ``cfg`` (``models.model.init`` on the meta
    device)."""
    from ..models import model

    def carry(ref, want, path):
        if isinstance(want, dict):
            if not isinstance(ref, dict) or sorted(ref) != sorted(want):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(ref) if isinstance(ref, dict) else ref!r}, "
                                 f"expected {sorted(want)}")
            return {k: carry(ref[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(ref, (list, tuple)) or len(ref) != len(want):
                raise ValueError(f"{path}: expected a list of {len(want)}")
            return [carry(r, w, f"{path}/{i}") for i, (r, w) in enumerate(zip(ref, want))]
        t = _leaf_to_torch(ref, device)
        if tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(want.shape)} {want.dtype}")
        return t

    return carry(tree, model.init(cfg, None, device="meta"), "")
