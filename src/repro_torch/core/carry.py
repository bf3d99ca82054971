"""What crosses from the JAX reference into the port: config, instance
and state.

The system has no weights. A test carries the solver configuration (the
``dataclasses.asdict`` of a reference ``SolverConfig``), the instance (the
reference's ``SparseKP``/``DenseKP`` as numpy arrays, or numpy bytes
through ``host_array_source``) and solver state (numpy arrays:
multipliers, histograms, finalize carries) into the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .types import DenseKP, SolverConfig, SparseKP

# Reference fields the port does not carry: their reference defaults, and
# the ROADMAP item that ports them. Any other value raises.
_UNPORTED = {
    "partial_fraction": (1.0, "A8 (straggler mask)"),
}
_DTYPES = {"float32": torch.float32}


def config_from_reference(fields: dict) -> SolverConfig:
    """A port ``SolverConfig`` from ``dataclasses.asdict`` of a reference one.

    ``dtype`` maps by name; ``use_kernels`` is dropped (the device picks
    the implementation). Fields the port does not carry must hold the
    reference's default, and ported fields a supported value; otherwise
    this raises (``NotImplementedError`` naming the ROADMAP item for an
    unported option).
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
        elif name in _UNPORTED:
            default, item = _UNPORTED[name]
            if value != default:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet: ROADMAP {item}")
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
