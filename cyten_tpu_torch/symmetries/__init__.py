"""Symmetries, spaces and fusion trees (host-side numpy).

The counterpart of ``cyten_tpu/symmetries/`` for trivial, U(1), Z_N and SU(2)
symmetries, fermion parity and number (``fermions.py``), the anyonic categories of
``anyons.py``, and their products. SU(N) comes with a later slice.
"""

from .core import (
    BaseSymmetry, BraidChiralityUnspecifiedError, BraidingStyle, FusionStyle, Sector,
    SectorArray, Symmetry, SymmetryError, SymmetryFactor,
)
from .groups import SU2, U1, ZN, AbelianGroup, Group, NoSymmetry
from .fermions import FermionNumber, FermionParity
from .anyons import (
    FibonacciAnyonCategory, IsingAnyonCategory, QuantumDoubleZNAnyonCategory,
    SU2_kAnyonCategory, SU3_3AnyonCategory, ToricCodeCategory, ZNAnyonCategory,
    ZNAnyonCategory2,
)
from .spaces import (
    AbelianLegPipe, ElementarySpace, Leg, LegPipe, Space, TensorProduct, swap_gate,
    twist_gate,
)
from .trees import FusionTree, fusion_trees

# premade instances (cheap constructors only)
no_symmetry = NoSymmetry().as_Symmetry()
z2_symmetry = ZN(N=2).as_Symmetry()
z3_symmetry = ZN(N=3).as_Symmetry()
z4_symmetry = ZN(N=4).as_Symmetry()
u1_symmetry = U1().as_Symmetry()
su2_symmetry = SU2().as_Symmetry()
fermion_number = FermionNumber().as_Symmetry()
fermion_parity = FermionParity().as_Symmetry()
semion_category = ZNAnyonCategory2(2, 0).as_Symmetry()
toric_code_category = ToricCodeCategory().as_Symmetry()
double_semion_category = ZNAnyonCategory2(2, 0) * ZNAnyonCategory2(2, 1)
fibonacci_anyon_category = FibonacciAnyonCategory(handedness='left').as_Symmetry()
ising_anyon_category = IsingAnyonCategory(nu=1).as_Symmetry()

__all__ = [
    'BaseSymmetry', 'BraidChiralityUnspecifiedError', 'BraidingStyle', 'FusionStyle',
    'Sector', 'SectorArray', 'Symmetry', 'SymmetryError', 'SymmetryFactor',
    'Group', 'AbelianGroup', 'NoSymmetry', 'U1', 'ZN', 'SU2',
    'FermionNumber', 'FermionParity',
    'ZNAnyonCategory', 'ZNAnyonCategory2', 'QuantumDoubleZNAnyonCategory',
    'ToricCodeCategory', 'FibonacciAnyonCategory', 'IsingAnyonCategory',
    'SU2_kAnyonCategory', 'SU3_3AnyonCategory',
    'Leg', 'LegPipe', 'Space', 'ElementarySpace', 'TensorProduct', 'AbelianLegPipe',
    'swap_gate', 'twist_gate', 'FusionTree', 'fusion_trees',
    'no_symmetry', 'z2_symmetry', 'z3_symmetry', 'z4_symmetry', 'u1_symmetry',
    'su2_symmetry', 'fermion_number', 'fermion_parity', 'semion_category', 'toric_code_category', 'double_semion_category',
    'fibonacci_anyon_category', 'ising_anyon_category',
]
