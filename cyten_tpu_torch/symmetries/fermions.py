"""Fermionic graded symmetries: parity and particle number (host-side numpy).

The port's own copy of ``cyten_tpu/symmetries/fermions.py``: ``FermionParity`` (Z_2
fusion) and ``FermionNumber`` (U(1) fusion), each with a fermionic braid,
``R^{ab} = -1`` iff both sectors are odd; the C symbols, swap gates and twists follow.
Their trivial F and B symbols let dense blocks stand for fermionic tensors
(``can_be_dropped``), while every braid of two odd legs takes its sign.

Several fermion species must not be modelled as a product of several fermionic
factors (they would braid as mutual bosons): use one fermionic factor, plus U(1) or
Z_N factors for each conserved species number.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Dtype
from ..tools.misc import as_immutable_array
from .core import (
    _ONE_2D, _ONE_2D_F, _ONE_4D, _ONE_4D_F, BraidingStyle, FusionStyle, Sector,
    SectorArray, SymmetryFactor,
)

__all__ = ['FermionParity', 'FermionNumber']


class _FermionicBase(SymmetryFactor):
    """Shared trivial-fusion-category data for the fermionic factors."""

    fusion_tensor_dtype = Dtype.float64

    def sector_dim(self, a) -> int:
        return 1

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return _ONE_4D

    def frobenius_schur(self, a) -> int:
        return 1

    def qdim(self, a) -> float:
        return 1

    def sqrt_qdim(self, a) -> float:
        return 1

    def inv_sqrt_qdim(self, a) -> float:
        return 1

    def _b_symbol(self, a, b, c) -> np.ndarray:
        return _ONE_2D

    def _parity(self, a: Sector) -> np.ndarray:
        """1 for odd sectors, 0 for even (elementwise)."""
        raise NotImplementedError

    def _r_symbol(self, a, b, c) -> np.ndarray:
        # -1 iff both a and b are odd
        return 1 - 2 * self._parity(a) * self._parity(b)

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        # F = 1 ->  C = R^{ec}_d · conj(R^{ac}_f)
        C = (1 - 2 * self._parity(e) * self._parity(c)) \
            * (1 - 2 * self._parity(c) * self._parity(a))
        return C[None, None, None, :]

    def _fusion_tensor(self, a, b, c, Z_a, Z_b) -> np.ndarray:
        return _ONE_4D_F

    def swap_gate(self, a, b) -> np.ndarray:
        sign = 1 - 2 * self._parity(a) * self._parity(b)
        return sign * _ONE_4D_F

    def topological_twist(self, a):
        return 1 - 2 * int(self._parity(a)[0])

    def Z_iso(self, a) -> np.ndarray:
        return _ONE_2D_F


class FermionParity(_FermionicBase):
    """Fermionic parity grading: sectors ``[0]`` (even) and ``[1]`` (odd), Z_2 fusion."""

    even = as_immutable_array(np.array([0], dtype=int))
    odd = as_immutable_array(np.array([1], dtype=int))

    def __init__(self, descriptive_name: str | None = None):
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.single, braiding_style=BraidingStyle.fermionic,
            trivial_sector=np.array([0], dtype=int), group_name='FermionParity',
            num_sectors=2, has_complex_topological_data=False,
            descriptive_name=descriptive_name)

    def _parity(self, a: Sector) -> np.ndarray:
        return a

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < 2

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < 2)))

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        return ((a + b) % 2)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a, b):
        return (a + b) % 2

    def _multiple_fusion_broadcast(self, *sectors):
        return sum(sectors) % 2

    def dual_sector(self, a: Sector) -> Sector:
        return a

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return sectors

    def all_sectors(self) -> SectorArray:
        return np.arange(2, dtype=int)[:, None]

    def sector_str(self, a: Sector) -> str:
        return 'even' if a[0] == 0 else 'odd'

    def __repr__(self):
        name = '' if self.descriptive_name is None else f'"{self.descriptive_name}"'
        return f'FermionParity({name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, FermionParity)


class FermionNumber(_FermionicBase):
    """Conserved fermionic particle number: U(1) fusion with fermionic braiding."""

    def __init__(self, descriptive_name: str | None = None):
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.single, braiding_style=BraidingStyle.fermionic,
            trivial_sector=np.array([0], dtype=int), group_name='FermionNumber',
            num_sectors=np.inf, has_complex_topological_data=False,
            descriptive_name=descriptive_name)

    def _parity(self, a: Sector) -> np.ndarray:
        return np.mod(a, 2)

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,)

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return len(shape) == 2 and shape[1] == 1

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        return (a + b)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a, b):
        return a + b

    def _multiple_fusion_broadcast(self, *sectors):
        return sum(sectors)

    def dual_sector(self, a: Sector) -> Sector:
        return -a

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return -sectors

    def __repr__(self):
        name = '' if self.descriptive_name is None else f'"{self.descriptive_name}"'
        return f'FermionNumber({name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, FermionNumber)
