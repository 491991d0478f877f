"""Core symmetry / fusion-category interface.

Role-equivalent to the abstract layer of the reference's ``cyten/symmetries/_symmetries.py``
(BaseSymmetry :101, Symmetry :645, SymmetryFactor :1023). All topological data
(N/F/R/B/C symbols, fusion tensors, quantum dimensions, twists, S-matrix) lives host-side
as numpy arrays: it parameterizes the static block structure and recoupling coefficients
of tensors; it never becomes device data itself.

Design difference from the reference: every symbol accessor is memoized per instance,
keyed by integer sector tuples (the reference recomputes, noting caching as an OPTIMIZE
item). This matters because the fusion-tree backend hits the same F/R/C/B symbols
thousands of times while composing tree mappings.
"""

from __future__ import annotations

import math
import warnings
from abc import ABCMeta, abstractmethod
from enum import IntEnum

import numpy as np

from ..config import config
from ..dtypes import Dtype
from ..tools.misc import as_immutable_array

__all__ = [
    'Sector', 'SectorArray', 'FusionStyle', 'BraidingStyle', 'SymmetryError',
    'BraidChiralityUnspecifiedError', 'BaseSymmetry', 'SymmetryFactor', 'Symmetry',
]

# A sector is a 1D int ndarray; a SectorArray stacks sectors as rows (2D).
Sector = np.ndarray
SectorArray = np.ndarray

_ONE_1D = as_immutable_array(np.ones((1,), dtype=int))
_ONE_2D = as_immutable_array(np.ones((1, 1), dtype=int))
_ONE_4D = as_immutable_array(np.ones((1, 1, 1, 1), dtype=int))
_ONE_2D_F = as_immutable_array(np.ones((1, 1), dtype=float))
_ONE_4D_F = as_immutable_array(np.ones((1, 1, 1, 1), dtype=float))


class SymmetryError(Exception):
    """An error related to symmetries, fusion or topological data."""


class BraidChiralityUnspecifiedError(SymmetryError):
    """Operation requires a braid, but the chirality (over/under) was not specified."""


class FusionStyle(IntEnum):
    """How non-trivial the fusion product of two sectors can be.

    - ``single``: a ⊗ b is a single sector (abelian).
    - ``multiple_unique``: each outcome appears at most once (N ∈ {0, 1}).
    - ``general``: outcomes may have multiplicity (N ∈ {0, 1, 2, ...}).
    """

    single = 0
    multiple_unique = 10
    general = 20


class BraidingStyle(IntEnum):
    """How non-trivial braiding is.

    - ``bosonic``: symmetric braid, trivial twists.
    - ``fermionic``: symmetric braid, ±1 twists.
    - ``anyonic``: general non-symmetric braiding.
    - ``no_braiding``: braiding undefined.
    """

    bosonic = 0
    fermionic = 10
    anyonic = 20
    no_braiding = 30


def _key(*sectors: Sector) -> tuple:
    """Hashable cache key from sectors."""
    return tuple(tuple(int(x) for x in s) for s in sectors)


class BaseSymmetry(metaclass=ABCMeta):
    """Shared interface + derived-quantity fallbacks for :class:`SymmetryFactor` /
    :class:`Symmetry`.

    Concrete subclasses provide fusion rules and the primary topological data (N, F, R);
    everything else (B and C symbols, quantum dimensions, Frobenius-Schur indicators,
    twists, the S matrix) has a categorical fallback derivation here, which subclasses
    may override with closed forms.
    """

    def __init__(self, fusion_style: FusionStyle, braiding_style: BraidingStyle,
                 trivial_sector: Sector, num_sectors: int | float,
                 has_complex_topological_data: bool):
        self.fusion_style = fusion_style
        self.braiding_style = braiding_style
        self.trivial_sector = as_immutable_array(np.asarray(trivial_sector, dtype=int))
        self.num_sectors = num_sectors
        self.sector_ind_len = len(self.trivial_sector)
        self.empty_sector_array = as_immutable_array(
            np.zeros((0, self.sector_ind_len), dtype=int))
        self.has_complex_topological_data = has_complex_topological_data
        self._cache: dict = {}

    # ---- style-derived properties -------------------------------------------------

    @property
    def can_be_dropped(self) -> bool:
        """Whether tensors with this symmetry can be converted to/from plain dense arrays.

        True for symmetric braids (group-like and fermionic); conversion of fermionic
        tensors loses the braid, requiring explicit swap gates.
        """
        return self.has_symmetric_braid

    @property
    def has_symmetric_braid(self) -> bool:
        return self.braiding_style <= BraidingStyle.fermionic

    @property
    def has_trivial_braid(self) -> bool:
        return self.braiding_style == BraidingStyle.bosonic

    @property
    def is_abelian(self) -> bool:
        """FusionStyle.single — all sectors fuse uniquely (not necessarily bosonic!)."""
        return self.fusion_style == FusionStyle.single

    @property
    def has_unique_fusion(self) -> bool:
        return self.fusion_style <= FusionStyle.multiple_unique

    # ---- abstract primary data ----------------------------------------------------

    @abstractmethod
    def is_valid_sector(self, a: Sector) -> bool: ...

    @abstractmethod
    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        """All distinct fusion outcomes of a ⊗ b as rows (each once, regardless of N)."""
        ...

    @abstractmethod
    def dual_sector(self, a: Sector) -> Sector:
        """The representative sector isomorphic to the dual space of `a`."""
        ...

    @abstractmethod
    def _n_symbol(self, a: Sector, b: Sector, c: Sector) -> int:
        """N^{ab}_c assuming c is a valid outcome."""
        ...

    @abstractmethod
    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        """[F^{abc}_d]^e_f as a 4D array over multiplicity indices [μ, ν, κ, λ]."""
        ...

    @abstractmethod
    def _r_symbol(self, a, b, c) -> np.ndarray:
        """Diagonal of R^{ab}_c as a 1D array over the multiplicity index [μ]."""
        ...

    @abstractmethod
    def as_Symmetry(self) -> Symmetry: ...

    # ---- validated + cached public accessors ---------------------------------------

    def n_symbol(self, a: Sector, b: Sector, c: Sector) -> int:
        """N^{ab}_c: multiplicity of c in a ⊗ b (0 if not an outcome)."""
        if not self.can_fuse_to(a, b, c):
            return 0
        return self._n_symbol(a, b, c)

    def f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        r"""Recoupling coefficients :math:`[F^{abc}_d]^{e\mu\nu}_{f\kappa\lambda}`.

        Relates ``(a ⊗ (b ⊗ c)_e)_d`` to ``((a ⊗ b)_f ⊗ c)_d``; unitary as a matrix from
        (fκλ) to (eμν). Returned with multiplicity axes [μ, ν, κ, λ].
        """
        if config.do_fusion_input_checks:
            ok = (self.can_fuse_to(b, c, e) and self.can_fuse_to(a, e, d)
                  and self.can_fuse_to(a, b, f) and self.can_fuse_to(f, c, d))
            if not ok:
                raise SymmetryError('Sectors inconsistent with fusion rules.')
        k = ('F',) + _key(a, b, c, d, e, f)
        res = self._cache.get(k)
        if res is None:
            res = as_immutable_array(self._f_symbol(a, b, c, d, e, f))
            self._cache[k] = res
        return res

    def r_symbol(self, a, b, c) -> np.ndarray:
        r"""Braid coefficients: diagonal of :math:`R^{ab}_c` over the multiplicity index."""
        if config.do_fusion_input_checks and not self.can_fuse_to(a, b, c):
            raise SymmetryError('Sectors inconsistent with fusion rules.')
        k = ('R',) + _key(a, b, c)
        res = self._cache.get(k)
        if res is None:
            res = as_immutable_array(self._r_symbol(a, b, c))
            self._cache[k] = res
        return res

    def b_symbol(self, a, b, c) -> np.ndarray:
        r"""Leg-bending coefficients :math:`[B^{ab}_c]^\mu_\nu` (2D over [μ, ν]).

        Relates ``a --(1 ⊗ η_b)--> a ⊗ b ⊗ b* --(X_μ ⊗ 1)--> c ⊗ b*`` to
        ``a --(Y_ν)--> c ⊗ b̄ --(1 ⊗ Z_b†)--> c ⊗ b*``.
        """
        if config.do_fusion_input_checks and not self.can_fuse_to(a, b, c):
            raise SymmetryError('Sectors inconsistent with fusion rules.')
        k = ('B',) + _key(a, b, c)
        res = self._cache.get(k)
        if res is None:
            res = as_immutable_array(self._b_symbol(a, b, c))
            self._cache[k] = res
        return res

    def c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        r"""Braid-on-a-tree coefficients
        :math:`[C^{abc}_d]^{e\mu\nu}_{f\kappa\lambda}` [μ,ν,κ,λ]."""
        if config.do_fusion_input_checks:
            ok = (self.can_fuse_to(a, b, e) and self.can_fuse_to(e, c, d)
                  and self.can_fuse_to(a, c, f) and self.can_fuse_to(f, b, d))
            if not ok:
                raise SymmetryError('Sectors inconsistent with fusion rules.')
        k = ('C',) + _key(a, b, c, d, e, f)
        res = self._cache.get(k)
        if res is None:
            res = as_immutable_array(self._c_symbol(a, b, c, d, e, f))
            self._cache[k] = res
        return res

    def fusion_tensor(self, a, b, c, Z_a: bool = False, Z_b: bool = False) -> np.ndarray:
        """Dense fusion tensor X^{ab}_{c,μ} with axes [μ, m_a, m_b, m_c].

        With ``Z_a`` (``Z_b``), a Z isomorphism is composed below the respective input leg.
        Only defined when the symmetry :attr:`can_be_dropped`.
        """
        if config.do_fusion_input_checks and not self.can_fuse_to(a, b, c):
            raise SymmetryError('Sectors inconsistent with fusion rules.')
        k = ('X', Z_a, Z_b) + _key(a, b, c)
        res = self._cache.get(k)
        if res is None:
            res = as_immutable_array(self._fusion_tensor(a, b, c, Z_a, Z_b))
            self._cache[k] = res
        return res

    # ---- fallback derivations (override for closed forms) --------------------------

    def _fusion_tensor(self, a, b, c, Z_a: bool, Z_b: bool) -> np.ndarray:
        if not self.can_be_dropped:
            raise SymmetryError(f'fusion tensor has no array representation for {self}')
        raise NotImplementedError

    def _b_symbol(self, a, b, c) -> np.ndarray:
        F = self._f_symbol(a, b, self.dual_sector(b), a, self.trivial_sector, c).conj()
        return self.sqrt_qdim(b) * F[0, 0, :, :]

    def _c_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        R1 = self._r_symbol(e, c, d)
        F = self._f_symbol(c, a, b, d, e, f)
        R2 = self._r_symbol(a, c, f)
        return R1[None, :, None, None] * F * np.conj(R2)[None, None, :, None]

    def swap_gate(self, a: Sector, b: Sector) -> np.ndarray:
        """Dense representation of the braid of two sectors, axes [b, a, b*, a*]."""
        if not self.can_be_dropped:
            raise SymmetryError(f'braid has no array representation for {self}')
        raise NotImplementedError

    def Z_iso(self, a: Sector) -> np.ndarray:
        r"""Matrix elements of :math:`Z_{\bar a}: \bar{a}^* \to a` as a [d_a, d_a] array.

        `a` is the *target* sector of the map. Fallback solves the defining relation
        through the fusion tensor with the trivial sector.
        """
        if not self.can_be_dropped:
            raise SymmetryError(f'Z iso has no array representation for {self}')
        X = self.fusion_tensor(a, self.dual_sector(a), self.trivial_sector)
        return self.sqrt_qdim(a) * X.conj()[0, :, :, 0].T

    def all_sectors(self) -> SectorArray:
        """All sectors (only for finitely many). Do not mutate the result."""
        if self.num_sectors == np.inf:
            raise SymmetryError(f'{type(self).__name__} has infinitely many sectors.')
        raise NotImplementedError

    def are_valid_sectors(self, sectors: SectorArray) -> bool:
        return all(self.is_valid_sector(a) for a in sectors)

    def fusion_outcomes_broadcast(self, a: SectorArray, b: SectorArray) -> SectorArray:
        """Row-wise unique fusion (abelian only)."""
        assert self.is_abelian
        if len(a) == 0:
            return np.zeros_like(a)
        return np.concatenate([self.fusion_outcomes(sa, sb) for sa, sb in zip(a, b)], axis=0)

    def multiple_fusion(self, *sectors: Sector) -> Sector:
        return self.multiple_fusion_broadcast(*(s[None, :] for s in sectors))[0, :]

    def multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        """Row-wise unique fusion of several sector arrays (abelian only)."""
        if len(sectors) == 0:
            return self.trivial_sector[None, :]
        if len(sectors) == 1:
            return sectors[0]
        return self._multiple_fusion_broadcast(*sectors)

    def _multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        res = sectors[0]
        for s in sectors[1:]:
            res = self.fusion_outcomes_broadcast(res, s)
        return res

    def can_fuse_to(self, a: Sector, b: Sector, c: Sector) -> bool:
        """Whether c appears in the fusion of a and b."""
        return bool(np.any(np.all(self.fusion_outcomes(a, b) == c[None, :], axis=1)))

    def sector_dim(self, a: Sector) -> int:
        """Dimension of the sector as an unstructured vector space (requires can_be_dropped)."""
        if not self.can_be_dropped:
            raise SymmetryError(f'sector_dim is not defined for {self}')
        return int(round(self.qdim(a)))

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        if self.is_abelian:
            return np.ones([a.shape[0]], dtype=int)
        return np.array([self.sector_dim(s) for s in a])

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        if self.is_abelian:
            return np.ones([a.shape[0]], dtype=int)
        return np.array([self.qdim(s) for s in a])

    def sector_str(self, a: Sector) -> str:
        return str(a)

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        if len(sectors) == 0:
            return sectors
        return np.stack([self.dual_sector(s) for s in sectors])

    def frobenius_schur(self, a: Sector) -> int:
        F = self._f_symbol(a, self.dual_sector(a), a, a, self.trivial_sector,
                           self.trivial_sector)
        return int(np.sign(np.real(F[0, 0, 0, 0])))

    def qdim(self, a: Sector) -> float:
        """Quantum dimension Tr(id_a)."""
        F = self._f_symbol(a, self.dual_sector(a), a, a, self.trivial_sector,
                           self.trivial_sector)
        return 1.0 / abs(F[0, 0, 0, 0])

    def sqrt_qdim(self, a: Sector) -> float:
        return math.sqrt(self.qdim(a))

    def inv_sqrt_qdim(self, a: Sector) -> float:
        return 1.0 / self.sqrt_qdim(a)

    def total_qdim(self) -> float:
        return math.sqrt(sum(self.qdim(a) ** 2 for a in self.all_sectors()))

    def topological_twist(self, a: Sector) -> complex:
        r"""Twist factor θ_a = (1/d_a) Σ_b d_b Tr R^{aa}_b."""
        if self.has_trivial_braid:
            return +1
        k = ('twist',) + _key(a)
        res = self._cache.get(k)
        if res is not None:
            return res
        tot = 0
        for b in self.fusion_outcomes(a, a):
            tot += self.qdim(b) * np.sum(self._r_symbol(a, a, b))
        tot /= self.qdim(a)
        if self.has_symmetric_braid:
            tot = -1 if np.real(tot) < 0 else +1
        else:
            tot = complex(tot)
        self._cache[k] = tot
        return tot

    def s_matrix_element(self, a: Sector, b: Sector) -> complex:
        S = 0
        for c in self.fusion_outcomes(a, b):
            S += self._n_symbol(a, b, c) * self.qdim(c) * self.topological_twist(c)
        S /= self.topological_twist(a) * self.topological_twist(b) * self.total_qdim()
        return np.real_if_close(S)

    def s_matrix(self) -> np.ndarray:
        """Modular S matrix (for modular tensor categories)."""
        sectors = self.all_sectors()
        n = len(sectors)
        S = np.zeros((n, n), dtype=complex)
        inv_twists = np.array([1 / self.topological_twist(a) for a in sectors])
        for i in range(n):
            for j in range(n):
                for c in self.fusion_outcomes(sectors[i], sectors[j]):
                    S[i, j] += (self._n_symbol(sectors[i], sectors[j], c)
                                * self.qdim(c) * self.topological_twist(c))
        S *= np.outer(inv_twists, inv_twists) / self.total_qdim()
        return np.real_if_close(S)


class SymmetryFactor(BaseSymmetry):
    """A single irreducible-content symmetry (group, fermion grading, or anyon category).

    User-facing symmetries are always a :class:`Symmetry` (a product of factors);
    call :meth:`as_Symmetry` or multiply factors to build one.
    """

    #: dtype of the dense fusion tensor, or None if it has no array representation
    fusion_tensor_dtype: Dtype | None = None

    def __init__(self, fusion_style: FusionStyle, braiding_style: BraidingStyle,
                 trivial_sector: Sector, group_name: str, num_sectors: int | float,
                 has_complex_topological_data: bool,
                 descriptive_name: str | None = None):
        self.group_name = group_name
        self.descriptive_name = descriptive_name
        BaseSymmetry.__init__(self, fusion_style, braiding_style, trivial_sector,
                              num_sectors, has_complex_topological_data)

    @abstractmethod
    def _is_equivalent_factor(self, other) -> bool:
        """Equivalence ignoring the descriptive name."""
        ...

    def is_equivalent_to(self, other) -> bool:
        if isinstance(other, Symmetry):
            return other.is_equivalent_to(self)
        return self._is_equivalent_factor(other)

    def as_Symmetry(self) -> Symmetry:
        return Symmetry([self])

    def __mul__(self, other):
        if isinstance(other, SymmetryFactor):
            return Symmetry([self, other])
        if isinstance(other, Symmetry):
            return Symmetry([self, *other.factors])
        return NotImplemented

    def __eq__(self, other):
        if isinstance(other, SymmetryFactor):
            return (self._is_equivalent_factor(other)
                    and self.descriptive_name == other.descriptive_name)
        return NotImplemented

    def __hash__(self):
        return hash((type(self).__name__, self.group_name, self.descriptive_name))

    def __str__(self):
        if self.descriptive_name is not None:
            return f'{self.group_name}("{self.descriptive_name}")'
        return self.group_name

    # serialization: subclasses override _init_args to list constructor kwargs
    def _init_args(self) -> dict:
        return {}

    def to_config(self) -> dict:
        cfg = {'class': type(self).__name__, **self._init_args()}
        if self.descriptive_name is not None:
            cfg['descriptive_name'] = self.descriptive_name
        return cfg

    @staticmethod
    def from_config(cfg: dict) -> SymmetryFactor:
        from ..tools.misc import find_subclass
        cfg = dict(cfg)
        cls = find_subclass(SymmetryFactor, cfg.pop('class'))
        return cls(**cfg)


class Symmetry(BaseSymmetry):
    r"""A product of :class:`SymmetryFactor`\ s — the user-facing symmetry type.

    Sectors are concatenated integer rows; ``sector_slices[i]:sector_slices[i+1]`` of a
    sector belongs to ``factors[i]``. Topological data combines factor-wise via Kronecker
    products over the multiplicity axes.
    """

    def __init__(self, factors: list[SymmetryFactor]):
        flat: list[SymmetryFactor] = []
        for f in factors:
            if isinstance(f, Symmetry):
                flat.extend(f.factors)
            else:
                flat.append(f)
        for f in flat:
            assert isinstance(f, SymmetryFactor)
        self.factors = flat

        n_fermionic = sum(f.braiding_style == BraidingStyle.fermionic for f in flat)
        if n_fermionic > 1:
            warnings.warn('Multiple fermionic factors: distinct species would braid as '
                          'mutual bosons. Use U1/ZN factors per species plus a single '
                          'fermionic factor.', stacklevel=2)

        self.sector_slices = np.cumsum([0] + [f.sector_ind_len for f in flat])
        BaseSymmetry.__init__(
            self,
            fusion_style=max((f.fusion_style for f in flat), default=FusionStyle.single),
            braiding_style=max((f.braiding_style for f in flat), default=BraidingStyle.bosonic),
            trivial_sector=np.concatenate([f.trivial_sector for f in flat])
            if flat else np.zeros(0, dtype=int),
            num_sectors=math.prod([f.num_sectors for f in flat]),
            has_complex_topological_data=any(f.has_complex_topological_data for f in flat),
        )
        dtypes = [f.fusion_tensor_dtype for f in flat]
        self.fusion_tensor_dtype = None if None in dtypes else (
            Dtype.common(*dtypes) if dtypes else Dtype.float64)

    # ---- structure ------------------------------------------------------------------

    @property
    def num_factors(self) -> int:
        return len(self.factors)

    def _split(self, a: Sector) -> list[Sector]:
        s = self.sector_slices
        return [a[s[i]:s[i + 1]] for i in range(self.num_factors)]

    def _split_many(self, sectors: SectorArray) -> list[SectorArray]:
        s = self.sector_slices
        return [sectors[:, s[i]:s[i + 1]] for i in range(self.num_factors)]

    def factor_where(self, descriptive_name: str) -> int:
        """Index of the first factor with that descriptive name."""
        for i, f in enumerate(self.factors):
            if f.descriptive_name == descriptive_name:
                return i
        raise ValueError(f'Name not found: {descriptive_name}')

    def has_factor(self, other) -> bool:
        if isinstance(other, SymmetryFactor):
            return any(f == other for f in self.factors)
        if isinstance(other, type) and issubclass(other, SymmetryFactor):
            return any(isinstance(f, other) for f in self.factors)
        raise TypeError('Expected instance or subclass of SymmetryFactor.')

    def as_Symmetry(self) -> Symmetry:
        return self

    def __mul__(self, other):
        if isinstance(other, Symmetry):
            return Symmetry([*self.factors, *other.factors])
        if isinstance(other, SymmetryFactor):
            return Symmetry([*self.factors, other])
        return NotImplemented

    def __eq__(self, other):
        if not isinstance(other, Symmetry):
            return False
        return (self.num_factors == other.num_factors
                and all(f1 == f2 for f1, f2 in zip(self.factors, other.factors)))

    def __hash__(self):
        return hash(tuple(hash(f) for f in self.factors))

    def is_equivalent_to(self, other, strict_ordering: bool = False) -> bool:
        """Equivalence ignoring descriptive names (and factor order unless strict)."""
        other = other.as_Symmetry()
        if self.num_factors != other.num_factors:
            return False
        if strict_ordering:
            return all(f1._is_equivalent_factor(f2)
                       for f1, f2 in zip(self.factors, other.factors))
        unmatched = list(other.factors)
        for f1 in self.factors:
            for i, f2 in enumerate(unmatched):
                if f1._is_equivalent_factor(f2):
                    del unmatched[i]
                    break
            else:
                return False
        return True

    def __repr__(self):
        if self.num_factors == 0:
            return 'Symmetry([])'
        if self.num_factors == 1:
            return f'Symmetry([{self.factors[0]!r}])'
        return ' * '.join(repr(f) for f in self.factors)

    def __str__(self):
        if self.num_factors == 0:
            return 'Symmetry([])'
        if self.num_factors == 1:
            return f'Symmetry([{self.factors[0]!s}])'
        return ' x '.join(str(f) for f in self.factors)

    # ---- sector validity / fusion ---------------------------------------------------

    def is_valid_sector(self, a: Sector) -> bool:
        if getattr(a, 'shape', ()) != (self.sector_ind_len,):
            return False
        return all(f.is_valid_sector(ai) for f, ai in zip(self.factors, self._split(a)))

    def are_valid_sectors(self, sectors: SectorArray) -> bool:
        shape = getattr(sectors, 'shape', ())
        if len(shape) != 2 or shape[1] != self.sector_ind_len:
            return False
        return all(f.are_valid_sectors(si)
                   for f, si in zip(self.factors, self._split_many(sectors)))

    def fusion_outcomes(self, a: Sector, b: Sector) -> SectorArray:
        """Cartesian product of factor-wise outcomes (factor 0 varies slowest).

        Memoized per sector pair: this is the innermost call of tree-move plan
        construction (thousands of hits per structure).
        """
        cache = self.__dict__.setdefault('_fusion_outcomes_cache', {})
        key = (np.asarray(a).tobytes(), np.asarray(b).tobytes())
        res = cache.get(key)
        if res is None:
            parts = [f.fusion_outcomes(ai, bi)
                     for f, ai, bi in zip(self.factors, self._split(a),
                                          self._split(b))]
            res = _row_cartesian(parts, self.sector_ind_len)
            res.setflags(write=False)
            cache[key] = res
        return res

    def fusion_outcomes_broadcast(self, a: SectorArray, b: SectorArray) -> SectorArray:
        assert self.is_abelian
        parts = [f.fusion_outcomes_broadcast(ai, bi)
                 for f, ai, bi in zip(self.factors, self._split_many(a), self._split_many(b))]
        return np.concatenate(parts, axis=-1) if parts else np.zeros_like(a)

    def _multiple_fusion_broadcast(self, *sectors: SectorArray) -> SectorArray:
        splits = [self._split_many(s) for s in sectors]
        parts = [f.multiple_fusion_broadcast(*(sp[i] for sp in splits))
                 for i, f in enumerate(self.factors)]
        return np.concatenate(parts, axis=-1) if parts else np.zeros_like(sectors[0])

    def all_sectors(self) -> SectorArray:
        if self.num_sectors == np.inf:
            raise SymmetryError(f'{self} has infinitely many sectors.')
        parts = [f.all_sectors() for f in self.factors]
        return _row_cartesian(parts, self.sector_ind_len)

    def dual_sector(self, a: Sector) -> Sector:
        parts = [f.dual_sector(ai) for f, ai in zip(self.factors, self._split(a))]
        return np.concatenate(parts) if parts else a.copy()

    def dual_sectors(self, sectors: SectorArray) -> SectorArray:
        parts = [f.dual_sectors(si)
                 for f, si in zip(self.factors, self._split_many(sectors))]
        return np.concatenate(parts, axis=-1) if parts else sectors.copy()

    # ---- dimensions -----------------------------------------------------------------

    def sector_dim(self, a: Sector) -> int:
        if self.is_abelian:
            return 1
        return math.prod(f.sector_dim(ai) for f, ai in zip(self.factors, self._split(a)))

    def batch_sector_dim(self, a: SectorArray) -> np.ndarray:
        if self.is_abelian:
            return np.ones([a.shape[0]], dtype=int)
        dims = np.ones(len(a), dtype=int)
        for f, ai in zip(self.factors, self._split_many(a)):
            dims *= f.batch_sector_dim(ai)
        return dims

    def batch_qdim(self, a: SectorArray) -> np.ndarray:
        if self.is_abelian:
            return np.ones([a.shape[0]], dtype=int)
        dims = np.ones(len(a))
        for f, ai in zip(self.factors, self._split_many(a)):
            dims *= f.batch_qdim(ai)
        return dims

    def qdim(self, a: Sector) -> float:
        if self.is_abelian:
            return 1
        res = 1
        for f, ai in zip(self.factors, self._split(a)):
            res *= f.qdim(ai)
        return res

    def sector_str(self, a: Sector) -> str:
        return '[' + ', '.join(f.sector_str(ai)
                               for f, ai in zip(self.factors, self._split(a))) + ']'

    # ---- topological data (kron over factors) ----------------------------------------

    def _n_symbol(self, a, b, c) -> int:
        if self.has_unique_fusion:
            return 1
        res = 1
        for f, ai, bi, ci in zip(self.factors, self._split(a), self._split(b), self._split(c)):
            res *= f._n_symbol(ai, bi, ci)
        return res

    def _f_symbol(self, a, b, c, d, e, f) -> np.ndarray:
        res = np.ones((1, 1, 1, 1))
        for fac, *secs in zip(self.factors, self._split(a), self._split(b), self._split(c),
                              self._split(d), self._split(e), self._split(f)):
            res = np.kron(res, fac._f_symbol(*secs))
        return res

    def _r_symbol(self, a, b, c) -> np.ndarray:
        res = np.ones((1,))
        for fac, ai, bi, ci in zip(self.factors, self._split(a), self._split(b), self._split(c)):
            res = np.kron(res, fac._r_symbol(ai, bi, ci))
        return res

    def _fusion_tensor(self, a, b, c, Z_a: bool = False, Z_b: bool = False) -> np.ndarray:
        if not self.can_be_dropped:
            raise SymmetryError(f'fusion tensor has no array representation for {self}')
        res = np.ones((1, 1, 1, 1))
        for fac, ai, bi, ci in zip(self.factors, self._split(a), self._split(b), self._split(c)):
            res = np.kron(res, fac._fusion_tensor(ai, bi, ci, Z_a, Z_b))
        return res

    def swap_gate(self, a: Sector, b: Sector) -> np.ndarray:
        if not self.can_be_dropped:
            raise SymmetryError(f'braid has no array representation for {self}')
        res = np.ones((1, 1, 1, 1))
        for fac, ai, bi in zip(self.factors, self._split(a), self._split(b)):
            res = np.kron(res, fac.swap_gate(ai, bi))
        return res

    def Z_iso(self, a: Sector) -> np.ndarray:
        if not self.can_be_dropped:
            raise SymmetryError(f'Z iso has no array representation for {self}')
        res = np.ones((1, 1))
        for fac, ai in zip(self.factors, self._split(a)):
            res = np.kron(res, fac.Z_iso(ai))
        return res

    # ---- serialization ----------------------------------------------------------------

    def to_config(self) -> dict:
        return {'class': 'Symmetry', 'factors': [f.to_config() for f in self.factors]}

    @staticmethod
    def from_config(cfg: dict) -> Symmetry:
        if cfg.get('class') == 'Symmetry':
            return Symmetry([SymmetryFactor.from_config(c) for c in cfg['factors']])
        return SymmetryFactor.from_config(cfg).as_Symmetry()


def _row_cartesian(parts: list[np.ndarray], total_cols: int) -> np.ndarray:
    """Cartesian product over lists of sector rows; first factor varies slowest."""
    if not parts:
        return np.zeros((1, 0), dtype=int)
    counts = [p.shape[0] for p in parts]
    total = math.prod(counts)
    out = np.zeros((total,) + (total_cols,), dtype=int)
    col = 0
    rep_inner = total
    for p in parts:
        n, w = p.shape
        rep_inner //= n
        reps_outer = total // (n * rep_inner)
        idx = np.tile(np.repeat(np.arange(n), rep_inner), reps_outer)
        out[:, col:col + w] = p[idx]
        col += w
    return out
