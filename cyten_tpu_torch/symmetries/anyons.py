"""Anyonic fusion categories (host-side numpy).

The port's own copy of ``cyten_tpu/symmetries/anyons.py``: Z_N anyons (two
gauges), the quantum double of Z_N and the toric code, Fibonacci, Ising, SU(2)_k
and SU(3)_3. The categories are data: F, R, C and B symbols, fusion rules,
quantum dimensions, Frobenius-Schur indicators and twists, all numpy.

The C symbols are not tabulated when a category is made; they derive from F and R
through the categorical fallback of :class:`~cyten_tpu_torch.symmetries.core.BaseSymmetry`
and are memoized on first use. SU(2)_k symbols are evaluated directly from the
q-deformed Racah sum (real-valued via sin ratios).
"""

from __future__ import annotations

import math
from typing import Literal

import numpy as np

from ..tools.misc import as_immutable_array
from .core import (
    _ONE_1D, _ONE_4D, BraidingStyle, FusionStyle, Sector, SectorArray, SymmetryFactor,
)

__all__ = [
    'ZNAnyonCategory', 'ZNAnyonCategory2', 'QuantumDoubleZNAnyonCategory',
    'ToricCodeCategory', 'FibonacciAnyonCategory', 'IsingAnyonCategory',
    'SU2_kAnyonCategory', 'SU3_3AnyonCategory',
]


class _AbelianAnyonBase(SymmetryFactor):
    """Shared structure for anyon categories with Z_N (or Z_N x Z_N) fusion."""

    def sector_dim(self, a) -> int:
        return 1

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def qdim(self, a) -> float:
        return 1

    def frobenius_schur(self, a) -> int:
        return 1

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return _ONE_4D


class ZNAnyonCategory(_AbelianAnyonBase):
    r"""Abelian anyons :math:`Z_N^{(n)}`: Z_N fusion with R-phases ``exp(2πi n ab / N)``.

    ``n = 0`` is the plain Z_N group (use :class:`~cyten_tpu_torch.symmetries.groups.ZN` then);
    ``(N, -n)`` gives the mirror-image (opposite handedness) category.
    """

    def __init__(self, N: int, n: int, descriptive_name: str | None = None):
        assert isinstance(N, (int, np.integer)) and N > 1
        self.N = int(N)
        self.n = int(n) % self.N
        self._phase = np.exp(2j * np.pi * self.n / self.N)
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.single, braiding_style=BraidingStyle.anyonic,
            trivial_sector=np.array([0], dtype=int),
            group_name=f'Z_{N}^({n}) anyons', num_sectors=self.N,
            has_complex_topological_data=self.n > 0, descriptive_name=descriptive_name)

    def _init_args(self):
        return {'N': self.N, 'n': self.n}

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < self.N

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < self.N)))

    def fusion_outcomes(self, a, b) -> SectorArray:
        return ((a + b) % self.N)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a, b):
        return (a + b) % self.N

    def _multiple_fusion_broadcast(self, *sectors):
        return sum(sectors) % self.N

    def dual_sector(self, a):
        return (-a) % self.N

    def dual_sectors(self, sectors):
        return (-sectors) % self.N

    def _r_symbol(self, a, b, c) -> np.ndarray:
        return self._phase ** (a * b)

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return self._phase ** (b[0] * c[0]) * _ONE_4D

    def all_sectors(self) -> SectorArray:
        return np.arange(self.N, dtype=int)[:, None]

    def __repr__(self):
        name = '' if self.descriptive_name is None else f', "{self.descriptive_name}"'
        return f'ZNAnyonCategory({self.N}, {self.n}{name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, ZNAnyonCategory) and (other.N, other.n) == (self.N, self.n)


class ZNAnyonCategory2(_AbelianAnyonBase):
    r"""Abelian anyons :math:`Z_N^{(n + 1/2)}` (N even): half-integer spin structure.

    R-phases ``exp(2πi (n + 1/2) ab / N)``; F symbols pick up signs
    ``(-1)^{a ⌊(b+c)/N⌋}`` and the Frobenius-Schur indicator alternates.
    """

    def __init__(self, N: int, n: int, descriptive_name: str | None = None):
        assert isinstance(N, (int, np.integer)) and N > 1 and N % 2 == 0
        self.N = int(N)
        self.n = int(n) % self.N
        self._phase = np.exp(2j * np.pi * (self.n + 0.5) / self.N)
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.single, braiding_style=BraidingStyle.anyonic,
            trivial_sector=np.array([0], dtype=int),
            group_name=f'Z_{N}^({n}+1/2) anyons', num_sectors=self.N,
            has_complex_topological_data=True, descriptive_name=descriptive_name)

    def _init_args(self):
        return {'N': self.N, 'n': self.n}

    is_valid_sector = ZNAnyonCategory.is_valid_sector
    are_valid_sectors = ZNAnyonCategory.are_valid_sectors
    fusion_outcomes = ZNAnyonCategory.fusion_outcomes
    fusion_outcomes_broadcast = ZNAnyonCategory.fusion_outcomes_broadcast
    _multiple_fusion_broadcast = ZNAnyonCategory._multiple_fusion_broadcast
    dual_sector = ZNAnyonCategory.dual_sector
    dual_sectors = ZNAnyonCategory.dual_sectors
    all_sectors = ZNAnyonCategory.all_sectors

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return (-1) ** (int(a[0]) * ((int(b[0]) + int(c[0])) // self.N)) * _ONE_4D

    def frobenius_schur(self, a) -> int:
        return (-1) ** int(a[0])

    def _r_symbol(self, a, b, c) -> np.ndarray:
        return self._phase ** (a * b) * _ONE_1D

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return self._phase ** (b[0] * c[0]) * _ONE_4D

    def __repr__(self):
        name = '' if self.descriptive_name is None else f', "{self.descriptive_name}"'
        return f'ZNAnyonCategory2({self.N}, {self.n}{name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, ZNAnyonCategory2) and (other.N, other.n) == (self.N, self.n)


class QuantumDoubleZNAnyonCategory(_AbelianAnyonBase):
    r"""Drinfeld double :math:`D(Z_N)`: sectors ``[charge, flux]``, Z_N x Z_N fusion.

    Mutual statistics between charge and flux: ``R^{ab} = exp(2πi a_0 b_1 / N)`` — this is
    *not* a product of two :class:`ZNAnyonCategory`.
    """

    def __init__(self, N: int, descriptive_name: str | None = None):
        assert isinstance(N, (int, np.integer)) and N > 1
        self.N = int(N)
        self._phase = np.exp(2j * np.pi / self.N)
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.single, braiding_style=BraidingStyle.anyonic,
            trivial_sector=np.array([0, 0], dtype=int), group_name=f'D(Z_{N})',
            num_sectors=self.N ** 2, has_complex_topological_data=self.N > 2,
            descriptive_name=descriptive_name)

    def _init_args(self):
        return {'N': self.N}

    def is_valid_sector(self, a: Sector) -> bool:
        return (getattr(a, 'shape', ()) == (2,) and bool(np.all(a >= 0))
                and bool(np.all(a < self.N)))

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 2
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < self.N)))

    def fusion_outcomes(self, a, b) -> SectorArray:
        return ((a + b) % self.N)[np.newaxis, :]

    def fusion_outcomes_broadcast(self, a, b):
        return (a + b) % self.N

    def _multiple_fusion_broadcast(self, *sectors):
        return sum(sectors) % self.N

    def dual_sector(self, a):
        return (-a) % self.N

    def dual_sectors(self, sectors):
        return (-sectors) % self.N

    def _r_symbol(self, a, b, c) -> np.ndarray:
        return self._phase ** (a[0:1] * b[1:2])

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        return self._phase ** (b[0] * c[1]) * _ONE_4D

    def all_sectors(self) -> SectorArray:
        x = np.arange(self.N, dtype=int)
        return np.stack(np.meshgrid(x, x, indexing='ij'), axis=-1).reshape(-1, 2)[:, ::-1]

    def __repr__(self):
        name = '' if self.descriptive_name is None else f', "{self.descriptive_name}"'
        return f'QuantumDoubleZNAnyonCategory({self.N}{name})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, QuantumDoubleZNAnyonCategory) and other.N == self.N


class ToricCodeCategory(QuantumDoubleZNAnyonCategory):
    """Toric code anyons = D(Z_2). Sectors: vacuum [0,0], e [0,1], m [1,0], f [1,1]."""

    vacuum = as_immutable_array(np.array([0, 0], dtype=int))
    electric_charge = as_immutable_array(np.array([0, 1], dtype=int))
    magnetic_flux = as_immutable_array(np.array([1, 0], dtype=int))
    fermion = as_immutable_array(np.array([1, 1], dtype=int))

    def __init__(self, descriptive_name: str | None = None):
        super().__init__(2, descriptive_name)

    def _init_args(self):
        return {}

    def __repr__(self):
        name = '' if self.descriptive_name is None else f'"{self.descriptive_name}"'
        return f'ToricCodeCategory({name})'


class FibonacciAnyonCategory(SymmetryFactor):
    """Fibonacci anyons: sectors vacuum ``[0]`` and tau ``[1]``, ``τ x τ = 1 + τ``.

    `handedness` conjugates the R symbols (needed for doubled / string-net models).
    """

    _phi = 0.5 * (1 + math.sqrt(5))
    vacuum = as_immutable_array(np.array([0], dtype=int))
    tau = as_immutable_array(np.array([1], dtype=int))

    def __init__(self, handedness: Literal['left', 'right'] = 'left'):
        assert handedness in ('left', 'right')
        self.handedness = handedness
        phi = self._phi
        # F^{τττ}_τ in the basis (e, f) ∈ {1, τ}²; unitary and symmetric
        self._f_tau = {(0, 0): phi ** -1, (0, 1): phi ** -0.5,
                       (1, 0): phi ** -0.5, (1, 1): -phi ** -1}
        r_1, r_tau = np.exp(-4j * np.pi / 5), np.exp(3j * np.pi / 5)
        if handedness == 'right':
            r_1, r_tau = r_1.conj(), r_tau.conj()
        self._r_tau = {0: r_1, 1: r_tau}
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.multiple_unique,
            braiding_style=BraidingStyle.anyonic, trivial_sector=np.array([0], dtype=int),
            group_name='FibonacciAnyons', num_sectors=2,
            has_complex_topological_data=True, descriptive_name=None)

    def _init_args(self):
        return {'handedness': self.handedness}

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < 2

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < 2)))

    def fusion_outcomes(self, a, b) -> SectorArray:
        if a[0] == 0 or b[0] == 0:
            return ((a + b) % 2)[np.newaxis, :]  # fusion with vacuum
        return np.array([[0], [1]])  # τ x τ = 1 + τ

    def sector_str(self, a) -> str:
        return 'vac' if a[0] == 0 else 'tau'

    def dual_sector(self, a):
        return a

    def dual_sectors(self, sectors):
        return sectors

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        if a[0] and b[0] and c[0] and d[0]:
            return self._f_tau[(int(e[0]), int(f[0]))] * _ONE_4D
        return _ONE_4D

    def frobenius_schur(self, a) -> int:
        return 1

    def qdim(self, a) -> float:
        return self._phi if a[0] else 1.0

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return np.where(a[:, 0] == 1, self._phi, 1.0)

    def _r_symbol(self, a, b, c) -> np.ndarray:
        if a[0] and b[0]:
            return self._r_tau[int(c[0])] * _ONE_1D
        return _ONE_1D

    def all_sectors(self) -> SectorArray:
        return np.arange(2, dtype=int)[:, None]

    def __repr__(self):
        return f'FibonacciAnyonCategory(handedness={self.handedness!r})'

    def _is_equivalent_factor(self, other) -> bool:
        return (isinstance(other, FibonacciAnyonCategory)
                and other.handedness == self.handedness)


class IsingAnyonCategory(SymmetryFactor):
    """Ising anyons: vacuum ``[0]``, sigma ``[1]``, fermion psi ``[2]``; σ x σ = 1 + ψ.

    `nu` (odd, mod 16) selects one of the 8 distinct Ising models (Kitaev's 16-fold way);
    ``-nu`` is the opposite handedness.
    """

    vacuum = as_immutable_array(np.array([0], dtype=int))
    sigma = as_immutable_array(np.array([1], dtype=int))
    psi = as_immutable_array(np.array([2], dtype=int))

    def __init__(self, nu: int = 1):
        assert nu % 2 == 1
        self.nu = nu % 16
        kappa = int((-1) ** ((self.nu ** 2 - 1) // 8))  # FS indicator of sigma
        self._kappa = kappa
        self._r_table = {
            # (a, b, c) -> R^{ab}_c, for the nontrivial braids
            (1, 1, 0): kappa * np.exp(-1j * self.nu * np.pi / 8),
            (1, 1, 2): kappa * np.exp(3j * self.nu * np.pi / 8),
            (1, 2, 1): (-1j) ** self.nu,
            (2, 1, 1): (-1j) ** self.nu,
            (2, 2, 0): -1.0,
        }
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.multiple_unique,
            braiding_style=BraidingStyle.anyonic, trivial_sector=np.array([0], dtype=int),
            group_name='IsingAnyons', num_sectors=3,
            has_complex_topological_data=True, descriptive_name=None)

    def _init_args(self):
        return {'nu': self.nu}

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < 3

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < 3)))

    def fusion_outcomes(self, a, b) -> SectorArray:
        ia, ib = int(a[0]), int(b[0])
        if ia == 0:
            return b[np.newaxis, :]
        if ib == 0:
            return a[np.newaxis, :]
        if ia == 1 and ib == 1:
            return np.array([[0], [2]])  # σ x σ = 1 + ψ
        if ia == 2 and ib == 2:
            return np.array([[0]])  # ψ x ψ = 1
        return np.array([[1]])  # σ x ψ = σ

    def sector_str(self, a) -> str:
        return ('vac', 'sigma', 'psi')[int(a[0])]

    def dual_sector(self, a):
        return a

    def dual_sectors(self, sectors):
        return sectors

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        abcd = (int(a[0]), int(b[0]), int(c[0]), int(d[0]))
        if abcd == (1, 1, 1, 1):
            # basis (e, f) ∈ {1, ψ}²: κ/√2 * [[1, 1], [1, -1]]
            sign = -1 if (e[0] and f[0]) else 1
            return sign * self._kappa / math.sqrt(2) * _ONE_4D
        if abcd in ((2, 1, 2, 1), (1, 2, 1, 2)):
            return -1 * _ONE_4D
        return _ONE_4D

    def frobenius_schur(self, a) -> int:
        return self._kappa if a[0] == 1 else 1

    def qdim(self, a) -> float:
        return math.sqrt(2) if a[0] == 1 else 1.0

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return np.where(a[:, 0] == 1, math.sqrt(2), 1.0)

    def _r_symbol(self, a, b, c) -> np.ndarray:
        val = self._r_table.get((int(a[0]), int(b[0]), int(c[0])), 1.0)
        return val * _ONE_1D

    def all_sectors(self) -> SectorArray:
        return np.arange(3, dtype=int)[:, None]

    def __repr__(self):
        return f'IsingAnyonCategory(nu={self.nu})'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, IsingAnyonCategory) and other.nu == self.nu


class SU2_kAnyonCategory(SymmetryFactor):
    """:math:`SU(2)_k` anyons: spins 0, 1/2, ..., k/2 with truncated fusion.

    Sectors ``[jj]`` with ``jj = 2j ∈ {0, ..., k}``. Topological data from q-deformed
    Racah sums at ``q = exp(2πi / (k+2))``, evaluated lazily (real-valued via sin ratios)
    and memoized — the reference precomputes a symmetric-key table instead
    (cyten/symmetries/_symmetries.py:2999-3011).
    """

    spin_zero = as_immutable_array(np.array([0], dtype=int))
    spin_half = as_immutable_array(np.array([1], dtype=int))

    def __init__(self, k: int, handedness: Literal['left', 'right'] = 'left'):
        assert isinstance(k, (int, np.integer)) and k >= 1
        assert handedness in ('left', 'right')
        self.k = int(k)
        self.handedness = handedness
        self._q = np.exp(2j * np.pi / (self.k + 2))
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.multiple_unique,
            braiding_style=BraidingStyle.anyonic, trivial_sector=np.array([0], dtype=int),
            group_name=f'SU(2)_{k} anyons', num_sectors=self.k + 1,
            has_complex_topological_data=True, descriptive_name=None)
        if k >= 2:
            self.spin_one = as_immutable_array(np.array([2], dtype=int))

    def _init_args(self):
        return {'k': self.k, 'handedness': self.handedness}

    # --- q-arithmetic (real) ---

    def _nq(self, n: int) -> float:
        """q-integer [n]_q = sin(nπ/(k+2)) / sin(π/(k+2))."""
        s = math.pi / (self.k + 2)
        return math.sin(n * s) / math.sin(s)

    def _nq_fac(self, n: int) -> float:
        key = ('nqf', n)
        res = self._cache.get(key)
        if res is None:
            res = 1.0
            for i in range(1, n + 1):
                res *= self._nq(i)
            self._cache[key] = res
        return res

    def _delta(self, jj1: int, jj2: int, jj3: int) -> float:
        res = (self._nq_fac((-jj1 + jj2 + jj3) // 2) * self._nq_fac((jj1 - jj2 + jj3) // 2)
               * self._nq_fac((jj1 + jj2 - jj3) // 2)
               / self._nq_fac((jj1 + jj2 + jj3) // 2 + 1))
        return math.sqrt(res)

    def _qj6(self, jj1: int, jj2: int, jj12: int, jj3: int, jj: int, jj23: int) -> float:
        """q-deformed 6j symbol via the Racah sum (0 if any triangle fails)."""
        for t in ((jj1, jj2, jj12), (jj1, jj, jj23), (jj3, jj2, jj23), (jj3, jj, jj12)):
            if t[0] > t[1] + t[2] or t[0] < abs(t[1] - t[2]) or sum(t) % 2:
                return 0.0
        start = max(jj1 + jj2 + jj12, jj12 + jj3 + jj, jj2 + jj3 + jj23,
                    jj1 + jj23 + jj) // 2
        stop = min(jj1 + jj2 + jj3 + jj, jj1 + jj12 + jj3 + jj23,
                   jj2 + jj12 + jj + jj23) // 2
        res = 0.0
        for z in range(start, stop + 1):
            denom = (self._nq_fac(z - (jj1 + jj2 + jj12) // 2)
                     * self._nq_fac(z - (jj12 + jj3 + jj) // 2)
                     * self._nq_fac(z - (jj2 + jj3 + jj23) // 2)
                     * self._nq_fac(z - (jj1 + jj23 + jj) // 2)
                     * self._nq_fac((jj1 + jj2 + jj3 + jj) // 2 - z)
                     * self._nq_fac((jj1 + jj12 + jj3 + jj23) // 2 - z)
                     * self._nq_fac((jj2 + jj12 + jj + jj23) // 2 - z))
            res += (-1) ** z * self._nq_fac(z + 1) / denom
        return res * (self._delta(jj1, jj2, jj12) * self._delta(jj12, jj3, jj)
                      * self._delta(jj2, jj3, jj23) * self._delta(jj1, jj23, jj))

    # --- category interface ---

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] <= self.k

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors <= self.k)))

    def fusion_outcomes(self, a, b) -> SectorArray:
        hi = min(int(a[0]) + int(b[0]), 2 * self.k - int(a[0]) - int(b[0]))
        return np.arange(abs(int(a[0]) - int(b[0])), hi + 2, 2)[:, np.newaxis]

    def sector_str(self, a) -> str:
        jj = int(a[0])
        return f'{jj} (j={jj // 2 if jj % 2 == 0 else f"{jj}/2"})'

    def dual_sector(self, a):
        return a

    def dual_sectors(self, sectors):
        return sectors

    def _n_symbol(self, a, b, c) -> int:
        return 1

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        val = math.sqrt(abs(self._nq(int(e[0]) + 1) * self._nq(int(f[0]) + 1)))
        val *= (-1) ** ((int(a[0]) + int(b[0]) + int(c[0]) + int(d[0])) // 2)
        val *= self._qj6(int(a[0]), int(b[0]), int(f[0]), int(c[0]), int(d[0]), int(e[0]))
        return val * _ONE_4D

    def frobenius_schur(self, a) -> int:
        return -1 if int(a[0]) % 2 else 1

    def qdim(self, a) -> float:
        return self._nq(int(a[0]) + 1)

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        s = math.pi / (self.k + 2)
        return np.sin((a[:, 0] + 1) * s) / math.sin(s)

    def _r_symbol(self, a, b, c) -> np.ndarray:
        jj1, jj2, jj = int(a[0]), int(b[0]), int(c[0])
        if jj1 == 0 or jj2 == 0:
            return _ONE_1D
        val = (-1.0) ** ((jj - jj1 - jj2) // 2)
        val = val * self._q ** ((jj * (jj + 2) - jj1 * (jj1 + 2) - jj2 * (jj2 + 2)) / 8)
        if self.handedness == 'right':
            val = np.conj(val)
        return val * _ONE_1D

    def all_sectors(self) -> SectorArray:
        return np.arange(self.k + 1, dtype=int)[:, None]

    def __repr__(self):
        return f'SU2_kAnyonCategory({self.k}, {self.handedness!r})'

    def _is_equivalent_factor(self, other) -> bool:
        return (isinstance(other, SU2_kAnyonCategory) and other.k == self.k
                and other.handedness == self.handedness)


class SU3_3AnyonCategory(SymmetryFactor):
    r""":math:`SU(3)_3` anyons — the standard example with fusion multiplicity N > 1.

    Sectors ``[j]``, j = 0..3, denote the anyons 1, 8, 10, :math:`\bar{10}`;
    ``8 x 8 = 1 + 2·8 + 10 + 10̄``.
    """

    one_irrep = as_immutable_array(np.array([0], dtype=int))
    eight_irrep = as_immutable_array(np.array([1], dtype=int))
    ten_irrep = as_immutable_array(np.array([2], dtype=int))
    ten_bar_irrep = as_immutable_array(np.array([3], dtype=int))

    def __init__(self):
        SymmetryFactor.__init__(
            self, fusion_style=FusionStyle.general, braiding_style=BraidingStyle.anyonic,
            trivial_sector=np.array([0], dtype=int), group_name='SU(3)_3 anyons',
            num_sectors=4, has_complex_topological_data=True, descriptive_name=None)
        # the 8 ⊗ 8 ⊗ 8 → 8 recoupling matrix in the 7-dim basis
        # (e or f) ∈ {1; 8μν: μν = 00,01,10,11; 10; 10̄}
        F8 = np.zeros((7, 7))
        F8[0, 0] = F8[5, 5] = F8[6, 5] = F8[5, 6] = F8[6, 6] = 1 / 3
        F8[0, 5] = F8[0, 6] = F8[5, 0] = F8[6, 0] = -1 / 3
        F8[0, 1] = F8[1, 0] = F8[0, 4] = F8[4, 0] = 3 ** -0.5
        F8[2, 2] = F8[3, 2] = F8[2, 3] = F8[3, 3] = F8[1, 4] = F8[4, 1] = 0.5
        F8[2, 6] = F8[6, 3] = F8[3, 5] = F8[5, 2] = 0.5
        F8[2, 5] = F8[5, 3] = F8[3, 6] = F8[6, 2] = -0.5
        F8[1, 1] = F8[4, 4] = -0.5
        F8[1, 5] = F8[1, 6] = F8[5, 1] = F8[6, 1] = 12 ** -0.5
        F8[4, 5] = F8[4, 6] = F8[5, 4] = F8[6, 4] = 12 ** -0.5
        self._F8 = as_immutable_array(F8)
        self._f2 = as_immutable_array(np.array([[-0.5, -(3 ** 0.5) / 2],
                                                [3 ** 0.5 / 2, -0.5]]))

    def _init_args(self):
        return {}

    def is_valid_sector(self, a: Sector) -> bool:
        return getattr(a, 'shape', ()) == (1,) and 0 <= a[0] < 4

    def are_valid_sectors(self, sectors) -> bool:
        shape = getattr(sectors, 'shape', ())
        return (len(shape) == 2 and shape[1] == 1
                and bool(np.all(sectors >= 0)) and bool(np.all(sectors < 4)))

    _FUSION = {
        (0, 0): [[0]], (0, 1): [[1]], (0, 2): [[2]], (0, 3): [[3]],
        (1, 0): [[1]], (2, 0): [[2]], (3, 0): [[3]],
        (1, 1): [[0], [1], [2], [3]],
        (1, 2): [[1]], (2, 1): [[1]], (1, 3): [[1]], (3, 1): [[1]],
        (2, 2): [[3]], (2, 3): [[0]], (3, 2): [[0]], (3, 3): [[2]],
    }

    def fusion_outcomes(self, a, b) -> SectorArray:
        return np.array(self._FUSION[(int(a[0]), int(b[0]))], dtype=int)

    def sector_str(self, a) -> str:
        return ('one', 'eight', 'ten', 'ten_bar')[int(a[0])]

    def dual_sector(self, a):
        m = {0: 0, 1: 1, 2: 3, 3: 2}
        return np.array([m[int(a[0])]], dtype=int)

    def dual_sectors(self, sectors):
        return np.where(sectors >= 2, (-sectors) % 5, sectors)

    def _n_symbol(self, a, b, c) -> int:
        return 2 if int(a[0]) == int(b[0]) == int(c[0]) == 1 else 1

    def sector_dim(self, a) -> int:
        return 1

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        return np.ones((len(a),), int)

    def frobenius_schur(self, a) -> int:
        return 1

    def qdim(self, a) -> float:
        return 3.0 if int(a[0]) == 1 else 1.0

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        return np.where(a[:, 0] == 1, 3.0, 1.0)

    _E_SLICE = {0: slice(0, 1), 1: slice(1, 5), 2: slice(5, 6), 3: slice(6, 7)}

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        ia, ib, ic, id_ = int(a[0]), int(b[0]), int(c[0]), int(d[0])
        if not (self.can_fuse_to(b, c, e) and self.can_fuse_to(a, e, d)
                and self.can_fuse_to(a, b, f) and self.can_fuse_to(f, c, d)):
            return _ONE_4D
        abcd = (ia, ib, ic, id_)
        n_eights = sum(1 for x in abcd if x == 1)
        shape = (self._n_symbol(b, c, e), self._n_symbol(a, e, d),
                 self._n_symbol(a, b, f), self._n_symbol(f, c, d))
        if n_eights == 4:
            block = self._F8[self._E_SLICE[int(f[0])], self._E_SLICE[int(e[0])]]
            return block.reshape(shape)
        if n_eights == 3:
            idx = abcd.index([x for x in abcd if x != 1][0])
            not8 = abcd[idx]
            if not8 == 0:
                return np.eye(2).reshape(shape)
            if (not8 == 2 and idx != 1) or (not8 == 3 and idx == 1):
                return self._f2.reshape(shape)
            return self._f2.T.reshape(shape)
        if n_eights == 2 and all(abcd):
            pos = [i for i, x in enumerate(abcd) if x == 1]
            if pos[1] == pos[0] + 1 or (pos[0] == 0 and pos[1] == 3):
                return -1 * _ONE_4D
            return _ONE_4D
        if n_eights == 0 and all(abcd):
            tens = [i for i, x in enumerate(abcd) if x == 2]
            idx = 1
            if len(tens) == 3:
                idx = [i for i in range(4) if abcd[i] != 2][0]
            elif len(tens) == 1:
                idx = tens[0]
            if idx in (0, 2):
                return -1 * _ONE_4D
        return _ONE_4D

    def _r_symbol(self, a, b, c) -> np.ndarray:
        if int(a[0]) == 1 and int(b[0]) == 1:
            if int(c[0]) == 1:
                return np.array([-1j, 1j])
            return -1 * _ONE_1D
        return _ONE_1D

    def all_sectors(self) -> SectorArray:
        return np.arange(4, dtype=int)[:, None]

    def __repr__(self):
        return 'SU3_3AnyonCategory()'

    def _is_equivalent_factor(self, other) -> bool:
        return isinstance(other, SU3_3AnyonCategory)
