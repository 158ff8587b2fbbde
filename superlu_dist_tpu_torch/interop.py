"""Carry state across from the reference package, as plain arrays.

The tests feed identical plans and identical factors to both packages.
Pickle cannot carry them (unpickling a reference plan imports the
reference package, which this package never does), so the carrier is
plain data: nested dicts of numpy arrays, lists and scalars, one dict
per dataclass keyed by field name, enum members by name.

    plan_from_arrays(d)                 -> FactorPlan
    lu_from_arrays(plan, panels, dtype, device=None)
                                        -> ops.batched.StagedLU
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from . import options as options_mod
from .device import resolve_device
from .ops import batched
from .plan.frontal import FrontalPlan
from .plan.plan import FactorPlan
from .plan.supernodes import SupernodePartition
from .plan.symbolic import SymbolicFactorization


def _options_from(d: dict) -> options_mod.Options:
    kw = {}
    defaults = options_mod.Options()
    for name, val in d.items():
        if not hasattr(defaults, name):
            continue
        cur = getattr(defaults, name)
        if isinstance(cur, enum.Enum) and isinstance(val, str):
            val = type(cur)[val]
        elif isinstance(cur, tuple) and val is not None:
            val = tuple(val)
        kw[name] = val
    return options_mod.Options(**kw)


def _arrs(lst):
    return [np.asarray(a) for a in lst]


def plan_from_arrays(d: dict, device=None) -> FactorPlan:
    """A FactorPlan from the reference plan's fields as plain data."""
    fd = d["frontal"]
    sd = fd["sym"]
    pd = sd["part"]
    part = SupernodePartition(
        nsuper=int(pd["nsuper"]), xsup=np.asarray(pd["xsup"]),
        supno=np.asarray(pd["supno"]), sparent=np.asarray(pd["sparent"]),
        levels=np.asarray(pd["levels"]))
    sym = SymbolicFactorization(part=part, struct=_arrs(sd["struct"]),
                                children=_arrs(sd["children"]))
    frontal = FrontalPlan(
        sym=sym, n=int(fd["n"]),
        w=np.asarray(fd["w"]), r=np.asarray(fd["r"]),
        m=np.asarray(fd["m"]), wb=np.asarray(fd["wb"]),
        mb=np.asarray(fd["mb"]), I=_arrs(fd["I"]),
        a_src=_arrs(fd["a_src"]), a_lr=_arrs(fd["a_lr"]),
        a_lc=_arrs(fd["a_lc"]), ea_map=_arrs(fd["ea_map"]),
        level_supernodes=_arrs(fd["level_supernodes"]),
        factor_flops=float(fd["factor_flops"]))
    return FactorPlan(
        n=int(d["n"]), options=_options_from(d["options"]),
        equed=str(d["equed"]),
        row_scale=np.asarray(d["row_scale"]),
        col_scale=np.asarray(d["col_scale"]),
        perm_r=np.asarray(d["perm_r"]), perm_c=np.asarray(d["perm_c"]),
        post=np.asarray(d["post"]),
        final_row=np.asarray(d["final_row"]),
        final_col=np.asarray(d["final_col"]),
        coo_rows=np.asarray(d["coo_rows"]),
        coo_cols=np.asarray(d["coo_cols"]),
        frontal=frontal, anorm=float(d["anorm"]),
        true_factor_flops=float(d.get("true_factor_flops", 0.0)),
        device=None if device is None else str(device))


def lu_from_arrays(plan: FactorPlan, panels, dtype,
                   device=None, tiny_pivots: int = 0
                   ) -> batched.StagedLU:
    """The port's factor handle from the reference's factors as numpy:
    either per-group (L, U, Li, Ui) local flats (StagedLU.panels) or
    the four whole-slab flats of a DeviceLU, sliced per group at the
    schedule's offsets.  `device` resolves as in gssvx: None is the
    CUDA card (NoCudaDeviceError without one); pass "cpu" for the
    host."""
    dtype = np.dtype(dtype)
    sched = batched.get_schedule(plan)
    if isinstance(panels[0], np.ndarray):       # DeviceLU flats
        L, U, Li, Ui = panels
        panels = []
        for g in sched.groups:
            sz = (g.n_loc * g.mb * g.wb, g.n_loc * g.wb * g.mb,
                  g.n_loc * g.wb * g.wb, g.n_loc * g.wb * g.wb)
            panels.append((L[g.L_off:g.L_off + sz[0]],
                           U[g.U_off:g.U_off + sz[1]],
                           Li[g.Li_off:g.Li_off + sz[2]],
                           Ui[g.Ui_off:g.Ui_off + sz[3]]))
    dev = resolve_device(device)
    out = [tuple(torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
                 for a in p)
           for p in panels]
    return batched.StagedLU(plan=plan, schedule=sched, dtype=dtype,
                            panels=out, tiny_pivots=int(tiny_pivots))
