"""Struct-of-arrays factor-graph core (device-side L4 layer, SURVEY.md §7)."""

from . import factor_defs  # noqa: F401  (registers factor kernels)
from .core import (FactorBatch, FactorGraph, VariableBlock, MANIFOLDS,
                   check_autodiff_factor, manifold_dof,
                   register_autodiff_factor, retract)
from .initialize import chordal_init, spanning_tree_init
from .marginalize import marginalize

__all__ = [
    "FactorBatch",
    "FactorGraph",
    "VariableBlock",
    "MANIFOLDS",
    "manifold_dof",
    "retract",
    "register_autodiff_factor",
    "check_autodiff_factor",
    "chordal_init",
    "spanning_tree_init",
    "marginalize",
]
