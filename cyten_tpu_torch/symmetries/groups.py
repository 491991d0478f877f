"""Group symmetries: trivial, U(1), Z_N and SU(2) (a copy of that part of
``cyten_tpu/symmetries/groups.py``; SU(N) comes with a later slice).
"""

from __future__ import annotations


import numpy as np

from ..dtypes import Dtype
from ..tools.misc import as_immutable_array
from . import su2_data
from .core import (
    _ONE_1D, _ONE_2D, _ONE_2D_F, _ONE_4D, _ONE_4D_F, BraidingStyle, FusionStyle, Sector,
    SectorArray, Symmetry, SymmetryError, SymmetryFactor,
)

__all__ = ['Group', 'AbelianGroup', 'NoSymmetry', 'U1', 'ZN', 'SU2']


class Group(SymmetryFactor):
    """Base for symmetries described by a compact group: bosonic braiding, trivial twists."""

    def __init__(self, fusion_style: FusionStyle, trivial_sector: Sector, group_name: str,
                 num_sectors: int | float, has_complex_topological_data: bool,
                 descriptive_name: str | None = None):
        SymmetryFactor.__init__(
            self, fusion_style=fusion_style, braiding_style=BraidingStyle.bosonic,
            trivial_sector=trivial_sector, group_name=group_name, num_sectors=num_sectors,
            has_complex_topological_data=has_complex_topological_data,
            descriptive_name=descriptive_name)

    def swap_gate(self, a: Sector, b: Sector) -> np.ndarray:
        """Group braiding is the plain flip: X[b,a,b*,a*] = δ_{b,b*} δ_{a,a*}."""
        d_a, d_b = self.sector_dim(a), self.sector_dim(b)
        eye = np.einsum('bq,ap->baqp', np.eye(d_b), np.eye(d_a))
        return eye

    def qdim(self, a: Sector) -> float:
        return self.sector_dim(a)

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return self.batch_sector_dim(a)

    def topological_twist(self, a: Sector) -> complex:
        return +1


class AbelianGroup(Group):
    """Base for abelian groups: 1D sectors, unique fusion, trivial topological data."""

    fusion_tensor_dtype = Dtype.float64

    def __init__(self, trivial_sector: Sector, group_name: str, num_sectors: int | float,
                 descriptive_name: str | None = None):
        Group.__init__(self, fusion_style=FusionStyle.single,
                       trivial_sector=trivial_sector, group_name=group_name,
                       num_sectors=num_sectors, has_complex_topological_data=False,
                       descriptive_name=descriptive_name)

    def sector_str(self, a: Sector) -> str:
        return str(a[0]) if len(a) == 1 else str(a)

    def sector_dim(self, a: Sector) -> int:
        return 1

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return _ONE_4D

    def frobenius_schur(self, a: Sector) -> int:
        return 1

    def qdim(self, a: Sector) -> float:
        return 1

    def sqrt_qdim(self, a: Sector) -> float:
        return 1

    def inv_sqrt_qdim(self, a: Sector) -> float:
        return 1

    def _b_symbol(self, a, b, c) -> np.ndarray:
        return _ONE_2D

    def _r_symbol(self, a, b, c) -> np.ndarray:
        return _ONE_1D

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return _ONE_4D

    def _fusion_tensor(self, a, b, c, Z_a: bool, Z_b: bool) -> np.ndarray:
        return _ONE_4D_F

    def Z_iso(self, a: Sector) -> np.ndarray:
        return _ONE_2D_F


class NoSymmetry(AbelianGroup):
    """Trivial symmetry: a single sector ``[0]``."""

    def __init__(self):
        AbelianGroup.__init__(self, trivial_sector=np.array([0], dtype=int),
                              group_name='no_symmetry', num_sectors=1)

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and a[0] == 0

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return len(shape) == 2 and shape[1] == 1 and np.all(sectors == 0)

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        return a[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a: SectorArray, b: SectorArray) -> SectorArray:
        return a

    def _multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        return sectors[0]

    def dual_sector(self, a: Sector) -> Sector:
        return a

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return sectors

    def all_sectors(self) -> SectorArray:
        return self.trivial_sector[np.newaxis, :]

    def sector_str(self, a: Sector) -> str:
        return '.'

    def __repr__(self):
        return 'NoSymmetry()'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, NoSymmetry)


class U1(AbelianGroup):
    """U(1) symmetry; sectors are single integer charges."""

    def __init__(self, descriptive_name: str | None = None):
        AbelianGroup.__init__(self, trivial_sector=np.array([0], dtype=int),
                              group_name='U(1)', num_sectors=np.inf,
                              descriptive_name=descriptive_name)

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,)

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return len(shape) == 2 and shape[1] == 1

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        return (a + b)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a: SectorArray, b: SectorArray) -> SectorArray:
        return a + b

    def _multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        return sum(sectors)

    def dual_sector(self, a: Sector) -> Sector:
        return -a

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return -sectors

    def __repr__(self):
        name = '' if self.descriptive_name is None else f'"{self.descriptive_name}"'
        return f'U1({name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, U1)


class ZN(AbelianGroup):
    """Z_N cyclic group; sectors are single integers mod N."""

    def __init__(self, N: int, descriptive_name: str | None = None):
        if not isinstance(N, (int, np.integer)) or N < 1:
            raise ValueError(f'invalid N: {N}')
        self.N = int(N)
        subscripts = str.maketrans('0123456789', '₀₁₂₃₄₅₆₇₈₉')
        AbelianGroup.__init__(self, trivial_sector=np.array([0], dtype=int),
                              group_name=f'Z{str(N).translate(subscripts)}',
                              num_sectors=self.N, descriptive_name=descriptive_name)

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < self.N

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(0 <= sectors)) and bool(np.all(sectors < self.N)))

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        return ((a + b) % self.N)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a: SectorArray, b: SectorArray) -> SectorArray:
        return (a + b) % self.N

    def _multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        return sum(sectors) % self.N

    def dual_sector(self, a: Sector) -> Sector:
        return (-a) % self.N

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return (-sectors) % self.N

    def all_sectors(self) -> SectorArray:
        return np.arange(self.N, dtype=int)[:, None]

    def __repr__(self):
        name = '' if self.descriptive_name is None else f', "{self.descriptive_name}"'
        return f'ZN({self.N}{name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, ZN) and other.N == self.N

    def _init_args(self) -> dict:
        return {'N': self.N}


class SU2(Group):
    """SU(2) symmetry. Sectors ``[jj]`` with ``jj = 2 * j`` a non-negative integer.

    Topological data comes from exact CG / 6j arithmetic in :mod:`.su2_data`.
    """

    fusion_tensor_dtype = Dtype.float64
    spin_zero = as_immutable_array(np.array([0], dtype=int))
    spin_half = as_immutable_array(np.array([1], dtype=int))
    spin_one = as_immutable_array(np.array([2], dtype=int))

    def __init__(self, descriptive_name: str | None = None):
        Group.__init__(self, fusion_style=FusionStyle.multiple_unique,
                       trivial_sector=np.array([0], dtype=int), group_name='SU(2)',
                       num_sectors=np.inf, has_complex_topological_data=False,
                       descriptive_name=descriptive_name)

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and a[0] >= 0

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return len(shape) == 2 and shape[1] == 1 and bool(np.all(sectors >= 0))

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        lo = abs(int(a[0]) - int(b[0]))
        hi = int(a[0]) + int(b[0])
        return np.arange(lo, hi + 2, 2)[:, np.newaxis]

    def can_fuse_to(self, a: Sector, b: Sector, c: Sector) -> bool:
        return bool((c[0] <= a[0] + b[0]) and (a[0] <= b[0] + c[0])
                    and (b[0] <= c[0] + a[0]) and ((a[0] + b[0] + c[0]) % 2 == 0))

    def sector_dim(self, a: Sector) -> int:
        return int(a[0]) + 1

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        if len(a) == 0:
            return np.zeros([0], dtype=int)
        return a[:, 0] + 1

    def sector_str(self, a: Sector) -> str:
        jj = int(a[0])
        return f'{jj} (J={jj // 2 if jj % 2 == 0 else f"{jj}/2"})'

    def __repr__(self):
        name = '' if self.descriptive_name is None else f'"{self.descriptive_name}"'
        return f'SU2({name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, SU2)

    def dual_sector(self, a: Sector) -> Sector:
        return a  # self-dual

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        return sectors

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return su2_data.f_symbol(int(a[0]), int(b[0]), int(c[0]), int(d[0]),
                                 int(e[0]), int(f[0]))

    def frobenius_schur(self, a: Sector) -> int:
        return 1 - 2 * (int(a[0]) % 2)

    def qdim(self, a: Sector) -> float:
        return int(a[0]) + 1

    def _r_symbol(self, a, b, c) -> np.ndarray:
        # (-1)^{j_a + j_b - j_c}: +1 for even integer sum, -1 for odd
        return 1 - (a + b - c) % 4

    def _fusion_tensor(self, a, b, c, Z_a: bool, Z_b: bool) -> np.ndarray:
        X = su2_data.fusion_tensor(int(a[0]), int(b[0]), int(c[0]))
        if Z_a:
            # compose Z below leg a: [μ, m_a, m_b, m_c] x [m_a, m_ā*] -> move to axis 1
            X = np.moveaxis(np.tensordot(X, self.Z_iso(self.dual_sector(a)), (1, 0)), -1, 1)
        if Z_b:
            X = np.moveaxis(np.tensordot(X, self.Z_iso(self.dual_sector(b)), (2, 0)), -1, 2)
        return X

    def Z_iso(self, a: Sector) -> np.ndarray:
        return su2_data.Z_iso(int(a[0]))
