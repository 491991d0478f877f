"""Symmetries and spaces (host-side numpy): the abelian groups of the main path.

The counterpart of ``cyten_tpu/symmetries/`` for trivial, U(1) and Z_N symmetries and
their products. Fermions, anyons, SU(2)/SU(N) and fusion trees come with the
fusion-tree slice.
"""

from .core import (
    BaseSymmetry, BraidChiralityUnspecifiedError, BraidingStyle, FusionStyle, Sector,
    SectorArray, Symmetry, SymmetryError, SymmetryFactor,
)
from .groups import U1, ZN, AbelianGroup, Group, NoSymmetry
from .spaces import (
    AbelianLegPipe, ElementarySpace, Leg, LegPipe, Space, TensorProduct, swap_gate,
    twist_gate,
)

# premade instances (cheap constructors only)
no_symmetry = NoSymmetry().as_Symmetry()
z2_symmetry = ZN(N=2).as_Symmetry()
z3_symmetry = ZN(N=3).as_Symmetry()
z4_symmetry = ZN(N=4).as_Symmetry()
u1_symmetry = U1().as_Symmetry()

__all__ = [
    'BaseSymmetry', 'BraidChiralityUnspecifiedError', 'BraidingStyle', 'FusionStyle',
    'Sector', 'SectorArray', 'Symmetry', 'SymmetryError', 'SymmetryFactor',
    'Group', 'AbelianGroup', 'NoSymmetry', 'U1', 'ZN',
    'Leg', 'LegPipe', 'Space', 'ElementarySpace', 'TensorProduct', 'AbelianLegPipe',
    'swap_gate', 'twist_gate',
    'no_symmetry', 'z2_symmetry', 'z3_symmetry', 'z4_symmetry', 'u1_symmetry',
]
