"""Symmetry spaces: legs, elementary spaces, tensor products and abelian leg pipes.

Role-equivalent to reference ``cyten/symmetries/spaces.py`` (Leg :38, LegPipe :262,
Space :420, ElementarySpace :761, TensorProduct :1488, AbelianLegPipe :2029,
swap_gate :2523, twist_gate :2597).

All of these objects are static host-side metadata. They are hashable (lazily,
content-based), so plans derived from them can be cached by structure.

Semantic contracts reproduced exactly (cf. SURVEY.md Appendix A):
- ``defining_sectors`` are ``np.lexsort(.T)``-sorted; ket spaces have
  ``sector_order='sorted'``, bra spaces ``'dual_sorted'``.
- ``basis_perm`` translates public -> internal basis: ``public[basis_perm] == internal``.
- ``AbelianLegPipe.block_ind_map`` rows are ``[b_start, b_end, i_1, ..., i_n, J]``,
  C-style combination order for codomain pipes, F-style for domain pipes.
"""

from __future__ import annotations

import bisect
import itertools as it
import warnings
from abc import ABCMeta, abstractmethod
from math import prod
from typing import Generator, Literal, Sequence

import numpy as np

from ..tools.misc import (
    UNSPECIFIED, combine_permutations, find_row_differences, inverse_permutation,
    iter_common_sorted_arrays, make_grid, make_stride, rank_data,
)
from .core import Sector, SectorArray, Symmetry, SymmetryError, SymmetryFactor
from .trees import fusion_trees

__all__ = [
    'Leg', 'LegPipe', 'Space', 'ElementarySpace', 'TensorProduct', 'AbelianLegPipe',
    'swap_gate', 'twist_gate',
]


def _sort_sectors(sectors: SectorArray, multiplicities: np.ndarray):
    perm = np.lexsort(sectors.T)
    return sectors[perm], multiplicities[perm], perm


def _unique_sorted_sectors(sectors: SectorArray, multiplicities: np.ndarray):
    """Sort sectors and merge duplicates, summing multiplicities."""
    sectors, multiplicities, perm = _sort_sectors(sectors, multiplicities)
    mult_slices = np.concatenate([[0], np.cumsum(multiplicities)])
    diffs = find_row_differences(sectors, include_len=True)
    multiplicities = mult_slices[diffs[1:]] - mult_slices[diffs[:-1]]
    return sectors[diffs[:-1]], multiplicities, perm


def _parse_drop_which(which, symmetry: Symmetry):
    """Normalize the `which` argument of drop_symmetry; returns (which, remaining)."""
    from . import no_symmetry

    if which == 'all' or (isinstance(which, list) and len(which) == symmetry.num_factors):
        return 'all', no_symmetry
    if isinstance(which, (int, np.integer)):
        which = [int(which)]
    which = [w % symmetry.num_factors for w in which]
    remaining = [f for i, f in enumerate(symmetry.factors) if i not in which]
    if len(remaining) == 0:
        return 'all', no_symmetry
    return which, Symmetry(remaining)


class Leg(metaclass=ABCMeta):
    """A single leg of a tensor: an :class:`ElementarySpace` or a :class:`LegPipe`.

    Attributes: ``symmetry``, ``dim`` (quantum dimension; int iff the symmetry can be
    dropped), ``is_dual`` (flips when bending the leg), and an optional ``basis_perm``.
    """

    def __init__(self, symmetry: Symmetry, dim, is_dual: bool, basis_perm):
        self.symmetry = symmetry
        self.dim = dim
        self.is_dual = is_dual
        self._hash = None
        if basis_perm is None:
            self._basis_perm = self._inverse_basis_perm = None
        else:
            if not symmetry.can_be_dropped:
                raise SymmetryError(f'basis_perm is meaningless for {symmetry}.')
            self._basis_perm = np.asarray(basis_perm, dtype=int)
            self._inverse_basis_perm = inverse_permutation(self._basis_perm)

    def test_sanity(self):
        if not self.symmetry.can_be_dropped:
            assert self._basis_perm is None
        if self._basis_perm is not None:
            assert self._basis_perm.shape == (self.dim,)
            assert np.all(self._basis_perm[self._inverse_basis_perm] == np.arange(self.dim))

    # --- abstract ---

    @abstractmethod
    def as_Space(self) -> Space: ...

    @property
    @abstractmethod
    def dual(self) -> Leg: ...

    @property
    @abstractmethod
    def is_trivial(self) -> bool: ...

    @abstractmethod
    def __eq__(self, other): ...

    def __hash__(self):
        if self._hash is None:
            self._hash = self._compute_hash()
        return self._hash

    @abstractmethod
    def _compute_hash(self) -> int: ...

    # --- basis permutation ---

    @property
    def basis_perm(self) -> np.ndarray:
        """Public -> internal basis order: ``public_basis[basis_perm] == internal_basis``."""
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'basis_perm is meaningless for {self.symmetry}.')
        if self._basis_perm is None:
            return np.arange(self.dim)
        return self._basis_perm

    @basis_perm.setter
    def basis_perm(self, value):
        self.set_basis_perm(basis_perm=value)

    @property
    def inverse_basis_perm(self) -> np.ndarray:
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'basis_perm is meaningless for {self.symmetry}.')
        if self._inverse_basis_perm is None:
            return np.arange(self.dim)
        return self._inverse_basis_perm

    @inverse_basis_perm.setter
    def inverse_basis_perm(self, value):
        self.set_basis_perm(inverse_basis_perm=value)

    def set_basis_perm(self, basis_perm=UNSPECIFIED, inverse_basis_perm=UNSPECIFIED):
        if basis_perm is UNSPECIFIED and inverse_basis_perm is UNSPECIFIED:
            raise ValueError('Must specify at least one argument')
        if basis_perm is UNSPECIFIED:
            if inverse_basis_perm is None:
                basis_perm = None
            else:
                inverse_basis_perm = np.asarray(inverse_basis_perm, int)
                assert inverse_basis_perm.shape == (self.dim,)
                basis_perm = inverse_permutation(inverse_basis_perm)
        elif inverse_basis_perm is UNSPECIFIED:
            if basis_perm is not None:
                basis_perm = np.asarray(basis_perm, int)
                assert basis_perm.shape == (self.dim,)
                inverse_basis_perm = inverse_permutation(basis_perm)
            else:
                inverse_basis_perm = None
        elif (basis_perm is None) != (inverse_basis_perm is None):
            raise ValueError('Can not mix None with an explicit permutation')
        elif basis_perm is not None:
            basis_perm = np.asarray(basis_perm, int)
            inverse_basis_perm = np.asarray(inverse_basis_perm, int)
            if not np.all(basis_perm[inverse_basis_perm] == np.arange(self.dim)):
                raise ValueError('The given permutations are not mutually inverse!')
        self._basis_perm = basis_perm
        self._inverse_basis_perm = inverse_basis_perm
        self._hash = None

    def apply_basis_perm(self, arr, axis: int = 0, inverse: bool = False,
                         pre_compose: bool = False):
        """Apply (inverse) basis_perm to `arr` along `axis`, skipping trivial perms."""
        perm = self._inverse_basis_perm if inverse else self._basis_perm
        if perm is None:
            return arr
        if pre_compose:
            assert axis == 0
            return perm[arr]
        return np.take(arr, perm, axis=axis)

    # --- structure ---

    def as_ElementarySpace(self, is_dual: bool = False) -> ElementarySpace:
        return self.as_Space().as_ElementarySpace(is_dual=is_dual)

    @property
    def flat_legs(self) -> list[ElementarySpace]:
        """Flatten all pipes (incl. AbelianLegPipes)."""
        return [self]

    @property
    def flat_spaces(self) -> list[ElementarySpace]:
        """Flatten plain pipes, keep AbelianLegPipes nested."""
        return [self]

    @property
    def num_flat_legs(self) -> int:
        return 1

    def _flat_leg_permutation(self, offset: int = 0) -> list[int]:
        """Flat-leg permutation such that combining would be in C style."""
        return [offset]

    @property
    def ascii_arrow(self) -> str:
        is_pipe = isinstance(self, LegPipe)
        if isinstance(self, ElementarySpace):
            return {(False, False): 'v', (False, True): '▼',
                    (True, False): '^', (True, True): '▲'}[self.is_dual, is_pipe]
        if is_pipe:
            return '║'
        raise RuntimeError


class LegPipe(Leg):
    """A group of legs, as created by ``combine_legs``.

    ``combine_cstyle`` fixes the order in which multi-indices combine: C-style (last leg
    fastest) for codomain pipes, F-style for domain pipes (their order in ``legs`` is
    reversed relative to ``tensor.legs``). The dual pipe has reversed dual legs and
    flipped style.
    """

    def __init__(self, legs: Sequence[Leg], is_dual: bool = False,
                 combine_cstyle: bool = True):
        self.legs = list(legs)
        self.num_legs = len(legs)
        assert self.num_legs > 0
        self.combine_cstyle = combine_cstyle
        if all(l._basis_perm is None for l in legs):
            basis_perm = None
        else:
            basis_perm = combine_permutations([l.basis_perm for l in self.legs],
                                              cstyle=combine_cstyle)
        Leg.__init__(self, symmetry=legs[0].symmetry, dim=prod(l.dim for l in legs),
                     is_dual=is_dual, basis_perm=basis_perm)

    def test_sanity(self):
        assert all(l.symmetry == self.symmetry for l in self.legs)
        for l in self.legs:
            l.test_sanity()
        Leg.test_sanity(self)

    def as_Space(self):
        return TensorProduct([l.as_Space() for l in self.legs], symmetry=self.symmetry)

    @property
    def dual(self) -> LegPipe:
        return LegPipe([l.dual for l in reversed(self.legs)], is_dual=not self.is_dual,
                       combine_cstyle=not self.combine_cstyle)

    @property
    def is_trivial(self) -> bool:
        return all(l.is_trivial for l in self.legs)

    @property
    def flat_legs(self) -> list[ElementarySpace]:
        return list(it.chain.from_iterable(l.flat_legs for l in self.legs))

    @property
    def flat_spaces(self) -> list[ElementarySpace]:
        return list(it.chain.from_iterable(l.flat_spaces for l in self.legs))

    @property
    def num_flat_legs(self) -> int:
        return sum(l.num_flat_legs for l in self.legs)

    def _flat_leg_permutation(self, offset: int = 0) -> list[int]:
        if self.num_legs == self.num_flat_legs:
            perm = list(range(offset, offset + self.num_legs))
            return perm if self.combine_cstyle else perm[::-1]
        legs = self.legs if self.combine_cstyle else self.legs[::-1]
        offsets = np.cumsum([offset, *[l.num_flat_legs for l in legs]])[:-1]
        if not self.combine_cstyle:
            offsets = offsets[::-1]
        perm = [l._flat_leg_permutation(o) for l, o in zip(self.legs, offsets)]
        return list(it.chain.from_iterable(perm))

    def set_basis_perm(self, basis_perm=UNSPECIFIED, inverse_basis_perm=UNSPECIFIED):
        raise TypeError(f'Can not set basis_perm for {type(self).__name__}.')

    def __eq__(self, other):
        if not isinstance(other, LegPipe):
            return NotImplemented
        if isinstance(self, AbelianLegPipe) != isinstance(other, AbelianLegPipe):
            return False
        return (self.is_dual == other.is_dual
                and self.combine_cstyle == other.combine_cstyle
                and self.num_legs == other.num_legs
                and all(l1 == l2 for l1, l2 in zip(self.legs, other.legs)))

    __hash__ = Leg.__hash__  # defining __eq__ would otherwise disable hashing

    def _compute_hash(self) -> int:
        return hash((type(self).__name__, self.is_dual, self.combine_cstyle,
                     tuple(hash(l) for l in self.legs)))

    def __getitem__(self, idx):
        return self.legs[idx]

    def __iter__(self):
        return iter(self.legs)

    def __len__(self):
        return self.num_legs

    def __repr__(self, show_symmetry=True, one_line=False):
        return (f'LegPipe(num_legs={self.num_legs}, is_dual={self.is_dual}, '
                f'combine_cstyle={self.combine_cstyle})')


class Space(metaclass=ABCMeta):
    r"""A space with a symmetry: isomorphic to a direct sum of sectors.

    Attributes: ``sector_decomposition`` (unique sector rows), ``multiplicities``,
    ``sector_order`` ('sorted' | 'dual_sorted' | None), ``slices`` (per-sector index
    ranges in the internal basis; only if the symmetry can be dropped), ``dim``.
    """

    def __init__(self, symmetry: Symmetry, sector_decomposition,
                 multiplicities=None,
                 sector_order: Literal['sorted', 'dual_sorted'] | None = None):
        self.symmetry = symmetry = symmetry.as_Symmetry()
        self.sector_decomposition = sector_decomposition = np.asarray(
            sector_decomposition, dtype=int)
        self.sector_order = sector_order
        if sector_decomposition.ndim != 2 or \
                sector_decomposition.shape[1] != symmetry.sector_ind_len:
            raise ValueError(
                f'Wrong sectors.shape: expected (*, {symmetry.sector_ind_len}), '
                f'got {sector_decomposition.shape}.')
        self.num_sectors = num_sectors = len(sector_decomposition)
        if multiplicities is None:
            self.multiplicities = multiplicities = np.ones((num_sectors,), dtype=int)
        else:
            self.multiplicities = multiplicities = np.asarray(multiplicities, dtype=int)
            assert multiplicities.shape == (num_sectors,)
        if symmetry.can_be_dropped:
            self.sector_dims = dims = symmetry.batch_sector_dim(sector_decomposition)
            self.sector_qdims = dims
            slices = np.zeros((num_sectors, 2), dtype=np.intp)
            slices[:, 1] = ends = np.cumsum(multiplicities * dims)
            slices[1:, 0] = ends[:-1]
            self.slices = slices
            self.dim = int(np.sum(dims * multiplicities))
        else:
            self.sector_dims = None
            self.sector_qdims = qdims = symmetry.batch_qdim(sector_decomposition)
            self.slices = None
            self.dim = float(np.sum(qdims * multiplicities))

    def test_sanity(self):
        assert self.dim >= 0
        assert self.sector_decomposition.shape == (self.num_sectors,
                                                   self.symmetry.sector_ind_len)
        assert self.symmetry.are_valid_sectors(self.sector_decomposition)
        assert len(np.unique(self.sector_decomposition, axis=0)) == self.num_sectors
        if self.sector_order == 'sorted':
            assert np.all(np.lexsort(self.sector_decomposition.T)
                          == np.arange(self.num_sectors))
        elif self.sector_order == 'dual_sorted':
            duals = self.symmetry.dual_sectors(self.sector_decomposition)
            assert np.all(np.lexsort(duals.T) == np.arange(self.num_sectors))
        assert np.all(self.multiplicities > 0)
        if self.symmetry.can_be_dropped:
            assert self.slices.shape == (self.num_sectors, 2)
            expect = self.sector_dims * self.multiplicities
            assert np.all(self.slices[:, 1] - self.slices[:, 0] == expect)
            if self.num_sectors > 0:
                assert self.slices[0, 0] == 0
                assert np.all(self.slices[1:, 0] == self.slices[:-1, 1])
                assert self.slices[-1, 1] == self.dim

    @property
    @abstractmethod
    def dual(self) -> Space: ...

    @property
    def is_trivial(self) -> bool:
        """One-dimensional, in the trivial sector (the monoidal unit)."""
        return (self.num_sectors == 1 and self.multiplicities[0] == 1
                and bool(np.all(self.sector_decomposition[0]
                                == self.symmetry.trivial_sector)))

    @abstractmethod
    def __eq__(self, other): ...

    def is_isomorphic_to(self, other: Space) -> bool:
        """Same sector_decomposition up to ordering."""
        if self.symmetry != other.symmetry:
            raise SymmetryError('Incompatible symmetries')
        if self.num_sectors != other.num_sectors:
            return False
        p1 = np.lexsort(self.sector_decomposition.T)
        p2 = np.lexsort(other.sector_decomposition.T)
        return (np.all(self.multiplicities[p1] == other.multiplicities[p2])
                and np.all(self.sector_decomposition[p1]
                           == other.sector_decomposition[p2]))

    def is_subspace_of(self, other: Space) -> bool:
        """Whether self is (isomorphic to) a subspace of other."""
        if not self.symmetry.is_equivalent_to(other.symmetry):
            return False
        if self.num_sectors == 0:
            return True
        found = 0
        for sector, mult in zip(other.sector_decomposition, other.multiplicities):
            m = self.sector_multiplicity(sector)
            if m == 0:
                continue
            if m > mult:
                return False
            found += 1
        return found >= self.num_sectors

    def as_ElementarySpace(self, is_dual: bool = False) -> ElementarySpace:
        if is_dual:
            defining = self.symmetry.dual_sectors(self.sector_decomposition)
            sorted_ = self.sector_order == 'dual_sorted'
        else:
            defining = self.sector_decomposition
            sorted_ = self.sector_order == 'sorted'
        if sorted_:
            return ElementarySpace(self.symmetry, defining, self.multiplicities,
                                   is_dual=is_dual)
        return ElementarySpace.from_defining_sectors(
            self.symmetry, defining, self.multiplicities, is_dual=is_dual,
            unique_sectors=True)

    def as_Space(self):
        return self

    def sector_decomposition_where(self, sector: Sector) -> int | None:
        """Index of `sector` in the sector_decomposition, or None."""
        where = np.where(np.all(self.sector_decomposition == sector, axis=1))[0]
        if len(where) == 0:
            return None
        return int(where[0])

    def sector_multiplicity(self, sector: Sector) -> int:
        idx = self.sector_decomposition_where(sector)
        return 0 if idx is None else int(self.multiplicities[idx])

    @abstractmethod
    def change_symmetry(self, symmetry: Symmetry, sector_map, injective: bool = False): ...

    @abstractmethod
    def drop_symmetry(self, which: int | list[int] = 'all'): ...


class ElementarySpace(Space, Leg):
    r"""A space that *is* a (dual of a) direct sum of sectors — the standard tensor leg.

    Ket spaces (``is_dual=False``): ``sector_decomposition == defining_sectors`` (sorted).
    Bra spaces (``is_dual=True``): ``sector_decomposition == dual(defining_sectors)``
    where the ``defining_sectors`` are sorted (hence ``sector_order == 'dual_sorted'``).
    """

    def __init__(self, symmetry: Symmetry, defining_sectors, multiplicities=None,
                 is_dual: bool = False, basis_perm=None):
        defining_sectors = np.asarray(defining_sectors, dtype=int)
        assert symmetry.are_valid_sectors(defining_sectors), 'invalid sectors'
        if is_dual:
            sector_decomposition = symmetry.dual_sectors(defining_sectors)
            sector_order = 'dual_sorted'
        else:
            sector_decomposition = defining_sectors
            sector_order = 'sorted'
        Space.__init__(self, symmetry=symmetry, sector_decomposition=sector_decomposition,
                       multiplicities=multiplicities, sector_order=sector_order)
        Leg.__init__(self, symmetry=symmetry, dim=self.dim, is_dual=is_dual,
                     basis_perm=basis_perm)
        self.defining_sectors = defining_sectors

    def test_sanity(self):
        assert self.defining_sectors.shape == (self.num_sectors,
                                               self.symmetry.sector_ind_len)
        assert self.sector_order == ('dual_sorted' if self.is_dual else 'sorted')
        Space.test_sanity(self)
        Leg.test_sanity(self)

    # --- constructors ---

    @classmethod
    def from_basis(cls, symmetry: Symmetry, sectors_of_basis) -> ElementarySpace:
        """From the sector of every basis element (multi-dim sectors listed per state).

        Always builds a ket space; sectors are grouped by order of appearance: the m-th
        occurrence of a d-dimensional sector is state ``m % d`` of multiplet ``m // d``.
        """
        if not symmetry.can_be_dropped:
            raise SymmetryError(f'from_basis is meaningless for {symmetry}.')
        sectors_of_basis = np.asarray(sectors_of_basis, dtype=int)
        assert sectors_of_basis.shape[1] == symmetry.sector_ind_len
        basis_perm = np.lexsort(sectors_of_basis.T)  # stable
        sectors = sectors_of_basis[basis_perm]
        diffs = find_row_differences(sectors, include_len=True)
        sectors = sectors[diffs[:-1]]
        dims = symmetry.batch_sector_dim(sectors)
        occurrences = diffs[1:] - diffs[:-1]
        multiplicities, rem = np.divmod(occurrences, dims)
        if np.any(rem > 0):
            raise ValueError('Sectors must appear in whole multiplets.')
        # within a sector, the m-th public occurrence is state m % d of multiplet
        # m // d; the internal layout is *state-major* (index = state * mult + mu),
        # so reorder the per-sector segments of basis_perm accordingly.
        if np.any(dims > 1):
            basis_perm = basis_perm.copy()
            for i in range(len(sectors)):
                d = int(dims[i])
                if d == 1:
                    continue
                m = int(multiplicities[i])
                seg = basis_perm[diffs[i]:diffs[i + 1]]
                # internal position s * m + mu takes public occurrence mu * d + s
                occ = (np.arange(d)[:, None] + d * np.arange(m)[None, :]).reshape(-1)
                basis_perm[diffs[i]:diffs[i + 1]] = seg[occ]
        return cls(symmetry, sectors, multiplicities, is_dual=False,
                   basis_perm=basis_perm)

    @classmethod
    def from_defining_sectors(cls, symmetry: Symmetry, defining_sectors,
                              multiplicities=None, is_dual: bool = False,
                              basis_perm=None, unique_sectors: bool = False,
                              return_sorting_perm: bool = False):
        """Like the constructor, but sectors may be unsorted / contain duplicates."""
        defining_sectors = np.asarray(defining_sectors, dtype=int)
        assert defining_sectors.ndim == 2
        assert defining_sectors.shape[1] == symmetry.sector_ind_len
        assert symmetry.are_valid_sectors(defining_sectors), 'invalid sectors'
        if multiplicities is None:
            multiplicities = np.ones((len(defining_sectors),), dtype=int)
        else:
            multiplicities = np.asarray(multiplicities, dtype=int)
            assert multiplicities.shape == (len(defining_sectors),)

        if symmetry.can_be_dropped:
            num_states = symmetry.batch_sector_dim(defining_sectors) * multiplicities
            basis_slices = np.concatenate([[0], np.cumsum(num_states)])
            defining_sectors, multiplicities, sort = _sort_sectors(defining_sectors,
                                                                   multiplicities)
            if len(defining_sectors) == 0:
                basis_perm = np.zeros(0, int)
            else:
                if basis_perm is None:
                    basis_perm = np.arange(np.sum(num_states))
                basis_perm = np.concatenate(
                    [basis_perm[basis_slices[i]:basis_slices[i + 1]] for i in sort])
        else:
            defining_sectors, multiplicities, sort = _sort_sectors(defining_sectors,
                                                                   multiplicities)
            assert basis_perm is None

        if not unique_sectors:
            mult_slices = np.concatenate([[0], np.cumsum(multiplicities)])
            diffs = find_row_differences(defining_sectors, include_len=True)
            if basis_perm is not None and not symmetry.is_abelian:
                # for dim > 1 sectors: reorder so that all copies of the first state of
                # the multiplet come first, then all copies of the second state, etc.
                num_states = symmetry.batch_sector_dim(defining_sectors) * multiplicities
                basis_slices = np.concatenate([[0], np.cumsum(num_states)])
                for i in range(len(diffs) - 1):
                    d_a = symmetry.sector_dim(defining_sectors[diffs[i]])
                    if d_a == 1:
                        continue
                    mults = multiplicities[diffs[i]:diffs[i + 1]]
                    offsets = np.concatenate([[0], np.cumsum(mults * d_a)])
                    seg = basis_perm[basis_slices[diffs[i]]:basis_slices[diffs[i + 1]]]
                    new = np.concatenate([
                        seg[offsets[j] + k * m:offsets[j] + (k + 1) * m]
                        for k in range(d_a) for j, m in enumerate(mults)])
                    basis_perm[basis_slices[diffs[i]]:basis_slices[diffs[i + 1]]] = new
            multiplicities = mult_slices[diffs[1:]] - mult_slices[diffs[:-1]]
            defining_sectors = defining_sectors[diffs[:-1]]
        res = cls(symmetry, defining_sectors, multiplicities, is_dual=is_dual,
                  basis_perm=basis_perm)
        if return_sorting_perm:
            return res, sort
        return res

    @classmethod
    def from_sector_decomposition(cls, symmetry: Symmetry, sector_decomposition,
                                  multiplicities=None, is_dual: bool = False,
                                  basis_perm=None, unique_sectors: bool = False
                                  ) -> ElementarySpace:
        """From a given sector_decomposition (instead of defining_sectors)."""
        sector_decomposition = np.asarray(sector_decomposition, int)
        if is_dual:
            defining = symmetry.dual_sectors(sector_decomposition)
        else:
            defining = sector_decomposition
        return cls.from_defining_sectors(symmetry, defining, multiplicities,
                                         is_dual=is_dual, basis_perm=basis_perm,
                                         unique_sectors=unique_sectors)

    @classmethod
    def from_null_space(cls, symmetry: Symmetry, is_dual: bool = False) -> ElementarySpace:
        return cls(symmetry, symmetry.empty_sector_array, np.zeros(0, int),
                   is_dual=is_dual)

    @classmethod
    def from_trivial_sector(cls, dim: int = 1, symmetry: Symmetry = None,
                            is_dual: bool = False, basis_perm=None) -> ElementarySpace:
        if symmetry is None:
            from . import no_symmetry

            symmetry = no_symmetry
        if dim == 0:
            return cls.from_null_space(symmetry, is_dual=is_dual)
        return cls(symmetry, symmetry.trivial_sector[None, :], [dim], is_dual=is_dual,
                   basis_perm=basis_perm)

    @classmethod
    def from_independent_symmetries(cls, independent_descriptions
                                    ) -> ElementarySpace:
        """Combine per-symmetry descriptions of the same basis into one product symmetry."""
        from . import no_symmetry

        assert len(independent_descriptions) > 0
        dim = independent_descriptions[0].dim
        assert all(s.dim == dim for s in independent_descriptions)
        independent_descriptions = [s for s in independent_descriptions
                                    if s.symmetry != no_symmetry]
        if not independent_descriptions:
            return cls.from_trivial_sector(dim=dim)
        symmetry = Symmetry([s.symmetry for s in independent_descriptions])
        if not symmetry.can_be_dropped:
            raise SymmetryError(
                f'from_independent_symmetries is not supported for {symmetry}.')
        sectors_of_basis = np.concatenate(
            [s.sectors_of_basis for s in independent_descriptions], axis=1)
        return cls.from_basis(symmetry, sectors_of_basis)

    @classmethod
    def from_largest_common_subspace(cls, *spaces: Space, is_dual: bool = False
                                     ) -> ElementarySpace:
        """Sector-wise minimum of multiplicities over all given spaces."""
        if len(spaces) == 0:
            raise ValueError('Need at least one space')
        if len(spaces) == 1:
            return spaces[0].as_ElementarySpace(is_dual=is_dual)
        sp1, sp2, *more = spaces
        if more:
            sp = cls.from_largest_common_subspace(sp1, sp2)
            return cls.from_largest_common_subspace(sp, *more, is_dual=is_dual)
        sectors, mults = [], []
        for i, sector in enumerate(sp1.sector_decomposition):
            j = sp2.sector_decomposition_where(sector)
            if j is None:
                continue
            sectors.append(sector)
            mults.append(min(sp1.multiplicities[i], sp2.multiplicities[j]))
        if not sectors:
            return cls.from_null_space(sp1.symmetry, is_dual=is_dual)
        res = cls.from_sector_decomposition(sp1.symmetry, sectors, mults,
                                            is_dual=is_dual, unique_sectors=True)
        res._basis_perm = None
        res._inverse_basis_perm = None
        return res

    # --- properties / conversions ---

    @property
    def sectors_of_basis(self):
        """The sector of each basis vector, in public basis order."""
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'sectors_of_basis is meaningless for {self.symmetry}.')
        res = np.zeros((self.dim, self.symmetry.sector_ind_len), dtype=int)
        for sect, slc in zip(self.sector_decomposition, self.slices):
            res[slc[0]:slc[1], :] = sect[None, :]
        return self.apply_basis_perm(res, inverse=True)

    @property
    def dual(self) -> ElementarySpace:
        return ElementarySpace(self.symmetry, self.defining_sectors,
                               self.multiplicities, is_dual=not self.is_dual,
                               basis_perm=self._basis_perm)

    def as_ElementarySpace(self, is_dual: bool = False) -> ElementarySpace:
        if bool(is_dual) == self.is_dual:
            return self
        return self.with_opposite_duality()

    def as_ket_space(self):
        return self if not self.is_dual else self.with_opposite_duality()

    def as_bra_space(self):
        return self if self.is_dual else self.with_opposite_duality()

    def with_opposite_duality(self):
        """An isomorphic space with flipped is_dual."""
        if self.is_dual:
            dual_defining = self.sector_decomposition
        else:
            dual_defining = self.symmetry.dual_sectors(self.defining_sectors)
        return ElementarySpace.from_defining_sectors(
            self.symmetry, dual_defining, self.multiplicities,
            is_dual=not self.is_dual, basis_perm=self._basis_perm, unique_sectors=True)

    def with_is_dual(self, is_dual: bool) -> ElementarySpace:
        return self if is_dual == self.is_dual else self.with_opposite_duality()

    def change_symmetry(self, symmetry, sector_map, injective=False) -> ElementarySpace:
        return ElementarySpace.from_defining_sectors(
            symmetry, sector_map(self.defining_sectors), self.multiplicities,
            is_dual=self.is_dual, basis_perm=self._basis_perm, unique_sectors=injective)

    def drop_symmetry(self, which='all'):
        which, remaining = _parse_drop_which(which, self.symmetry)
        if which == 'all':
            return ElementarySpace.from_trivial_sector(
                dim=self.dim, symmetry=remaining, is_dual=self.is_dual,
                basis_perm=self._basis_perm)
        mask = np.ones((self.symmetry.sector_ind_len,), dtype=bool)
        for i in which:
            mask[self.symmetry.sector_slices[i]:self.symmetry.sector_slices[i + 1]] = False
        return self.change_symmetry(remaining, lambda sectors: sectors[:, mask])

    def direct_sum(self, *others: ElementarySpace) -> ElementarySpace:
        """Direct sum (stacking); bases concatenate."""
        if not others:
            return self
        assert all(o.symmetry == self.symmetry for o in others)
        assert all(o.is_dual == self.is_dual for o in others)
        if self.symmetry.can_be_dropped:
            offsets = np.cumsum([self.dim, *(o.dim for o in others)])
            basis_perm = np.concatenate(
                [self.basis_perm] + [o.basis_perm + n for o, n in zip(others, offsets)])
        else:
            basis_perm = None
        return ElementarySpace.from_defining_sectors(
            self.symmetry,
            np.concatenate([self.defining_sectors, *(o.defining_sectors for o in others)]),
            np.concatenate([self.multiplicities, *(o.multiplicities for o in others)]),
            is_dual=self.is_dual, basis_perm=basis_perm)

    # --- indexing ---

    def parse_index(self, idx: int) -> tuple[int, int]:
        """(sector_idx, index within the sector block) for a public basis index."""
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'parse_index is meaningless for {self.symmetry}.')
        idx = self.apply_basis_perm(idx, inverse=True, pre_compose=True)
        sector_idx = bisect.bisect(self.slices[:, 0].tolist(), idx) - 1
        return sector_idx, idx - self.slices[sector_idx, 0]

    def idx_to_sector(self, idx: int) -> Sector:
        return self.sector_decomposition[self.parse_index(idx)[0]]

    def take_slice(self, blockmask) -> ElementarySpace:
        """Keep only the basis states where `blockmask` (public order) is True."""
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'take_slice is meaningless for {self.symmetry}.')
        blockmask = np.asarray(blockmask, dtype=bool)
        blockmask = self.apply_basis_perm(blockmask)
        sectors, mults = [], []
        for a, d_a, slc in zip(self.defining_sectors, self.sector_dims, self.slices):
            sector_mask = blockmask[slc[0]:slc[1]]
            per_state = np.reshape(sector_mask, (d_a, -1))  # state-major layout
            if not np.all(per_state == per_state[:1, :]):
                raise ValueError('Multiplets must be kept or discarded as a whole.')
            mult = int(np.sum(sector_mask)) // d_a
            if mult > 0:
                sectors.append(a)
                mults.append(mult)
        if not sectors:
            sectors = self.symmetry.empty_sector_array
            mults = np.zeros(0, int)
        # small-leg basis_perm: unique choice that makes the internal projection a plain
        # mask (preserves ordering); see reference spaces.py:1398-1421 for the diagram.
        basis_perm = rank_data(self.basis_perm[blockmask])
        return ElementarySpace(self.symmetry, sectors, mults, is_dual=self.is_dual,
                               basis_perm=basis_perm)

    # --- dunders ---

    def __eq__(self, other):
        if not isinstance(other, ElementarySpace):
            return NotImplemented
        if isinstance(other, LegPipe) != isinstance(self, LegPipe):
            return False
        if self.is_dual != other.is_dual or self.symmetry != other.symmetry:
            return False
        if self.num_sectors != other.num_sectors:
            return False
        if not (np.all(self.multiplicities == other.multiplicities)
                and np.all(self.defining_sectors == other.defining_sectors)):
            return False
        if (self._basis_perm is not None) or (other._basis_perm is not None):
            return bool(np.all(self.basis_perm == other.basis_perm))
        return True

    __hash__ = Leg.__hash__  # defining __eq__ would otherwise disable hashing

    def _compute_hash(self) -> int:
        return hash((type(self).__name__, self.is_dual,
                     self.defining_sectors.tobytes(), self.multiplicities.tobytes(),
                     None if self._basis_perm is None else self._basis_perm.tobytes()))

    def __repr__(self, show_symmetry=True, one_line=False):
        if self.num_sectors > 8:
            return (f'ElementarySpace(num_sectors={self.num_sectors}, dim={self.dim}, '
                    f'is_dual={self.is_dual})')
        secs = [self.symmetry.sector_str(a) for a in self.defining_sectors]
        return (f'ElementarySpace(defining_sectors=[{", ".join(secs)}], '
                f'multiplicities={list(self.multiplicities)}, is_dual={self.is_dual})')


class TensorProduct(Space):
    r"""A tensor product of spaces, e.g. the (co)domain of a tensor.

    Computes and caches the fused ``sector_decomposition`` (sorted). Unlike a
    :class:`LegPipe`, it is a :class:`Space` and has no ``is_dual``.
    """

    def __init__(self, factors: list, symmetry: Symmetry = None,
                 _sector_decomposition=None, _multiplicities=None):
        self.num_factors = len(factors)
        if symmetry is None:
            if self.num_factors == 0:
                raise ValueError('For empty factors, the symmetry arg is required.')
            symmetry = factors[0].symmetry
        if not all(sp.symmetry == symmetry for sp in factors):
            raise SymmetryError('Incompatible symmetries.')
        self.symmetry = symmetry
        self.factors = list(factors)
        self._hash = None
        if _sector_decomposition is None or _multiplicities is None:
            _sector_decomposition, _multiplicities = self._calc_sectors(factors)
        Space.__init__(self, symmetry=symmetry,
                       sector_decomposition=_sector_decomposition,
                       multiplicities=_multiplicities, sector_order='sorted')

    def test_sanity(self):
        assert len(self.factors) == self.num_factors
        for sp in self.factors:
            sp.test_sanity()
        Space.test_sanity(self)

    @classmethod
    def from_partial_products(cls, *factors: TensorProduct) -> TensorProduct:
        """Flatten partial products, reusing their fused sector data."""
        spaces = factors[0].factors[:]
        symmetry = factors[0].symmetry
        for f in factors[1:]:
            spaces.extend(f.factors)
            assert f.symmetry == symmetry
        iso = TensorProduct(factors=list(factors), symmetry=symmetry)
        return cls(spaces, symmetry=symmetry,
                   _sector_decomposition=iso.sector_decomposition,
                   _multiplicities=iso.multiplicities)

    @property
    def dual(self):
        sectors = self.symmetry.dual_sectors(self.sector_decomposition)
        sectors, mults, _ = _sort_sectors(sectors, self.multiplicities)
        return TensorProduct([sp.dual for sp in reversed(self.factors)],
                             symmetry=self.symmetry, _sector_decomposition=sectors,
                             _multiplicities=mults)

    def block_size(self, coupled: Sector | int) -> int:
        """Total multiplicity of a coupled sector (given as sector or as index)."""
        if isinstance(coupled, (int, np.integer)):
            return int(self.multiplicities[coupled])
        return self.sector_multiplicity(coupled)

    def change_symmetry(self, symmetry, sector_map, injective=False):
        sectors = sector_map(self.sector_decomposition)
        mults = self.multiplicities
        if injective:
            sectors, mults, _ = _sort_sectors(sectors, mults)
        else:
            sectors, mults, _ = _unique_sorted_sectors(sectors, mults)
        return TensorProduct(
            [sp.change_symmetry(symmetry, sector_map, injective) for sp in self.factors],
            symmetry=symmetry, _sector_decomposition=sectors, _multiplicities=mults)

    def drop_symmetry(self, which='all'):
        which, remaining = _parse_drop_which(which, self.symmetry)
        return TensorProduct([sp.drop_symmetry(which) for sp in self.factors],
                             symmetry=remaining)

    @property
    def has_pipes(self) -> bool:
        return any(isinstance(l, LegPipe) for l in self.factors)

    @property
    def flat_legs(self) -> list[ElementarySpace]:
        return list(it.chain.from_iterable(l.flat_legs for l in self.factors))

    @property
    def flat_spaces(self) -> list[ElementarySpace]:
        return list(it.chain.from_iterable(l.flat_spaces for l in self.factors))

    @property
    def num_flat_legs(self) -> int:
        return sum(l.num_flat_legs for l in self.factors)

    def flat_legs_nesting(self) -> list[list[int]]:
        """Indices into flat_legs combining to each factor."""
        i, res = 0, []
        for l in self.factors:
            n = l.num_flat_legs
            res.append([*range(i, i + n)])
            i += n
        return res

    def flat_leg_idcs(self, i: int) -> list[int]:
        i = i % self.num_factors
        start = sum(l.num_flat_legs for l in self.factors[:i])
        return list(range(start, start + self.factors[i].num_flat_legs))

    # --- tree / forest block helpers (used by the fusion tree backend) ---

    def tree_block_size(self, uncoupled) -> int:
        return prod(s.sector_multiplicity(a)
                    for s, a in zip(self.flat_legs, uncoupled))

    def forest_block_size(self, uncoupled, coupled: Sector) -> int:
        return len(fusion_trees(self.symmetry, uncoupled, coupled)) \
            * self.tree_block_size(uncoupled)

    def forest_block_slice(self, uncoupled, coupled: Sector) -> slice:
        """Index range of a forest block within its coupled-sector block."""
        offset = 0
        for unc, mults in self.iter_uncoupled():
            if all(np.all(a == b) for a, b in zip(unc, uncoupled)):
                break
            offset += len(fusion_trees(self.symmetry, unc, coupled)) * prod(mults)
        else:
            raise ValueError('Uncoupled sectors incompatible')
        size = self.forest_block_size(uncoupled, coupled)
        return slice(offset, offset + size)

    def tree_block_slice(self, tree) -> slice:
        """Index range of a tree block within its coupled-sector block.

        Cached per coupled sector: one :meth:`iter_tree_blocks` pass builds the
        offsets of every tree at that coupled sector (hot path of tree-move plan
        construction).
        """
        cache = getattr(self, '_tree_slice_cache', None)
        if cache is None:
            cache = self._tree_slice_cache = {}
        key = tuple(np.asarray(tree.coupled).tolist())
        slices = cache.get(key)
        if slices is None:
            slices = cache[key] = {
                t: slc for t, slc, _, _ in
                self.iter_tree_blocks([np.asarray(tree.coupled)])}
        try:
            return slices[tree]
        except KeyError:
            raise ValueError('Uncoupled sectors incompatible') from None

    def iter_tree_blocks(self, coupled) -> Generator:
        """Yield (tree, slice, mults, i) over all tree blocks for coupled[i]."""
        are_dual = [sp.is_dual for sp in self.flat_legs]
        for i, c in enumerate(coupled):
            start = 0
            for uncoupled, mults in self.iter_uncoupled():
                tree_block_size = prod(mults)
                for tree in fusion_trees(self.symmetry, uncoupled, c, are_dual):
                    yield tree, slice(start, start + tree_block_size), mults, i
                    start += tree_block_size

    def iter_forest_blocks(self, coupled) -> Generator:
        """Yield (uncoupled, slice, i) over all forest blocks for coupled[i]."""
        for i, c in enumerate(coupled):
            start = 0
            for uncoupled, mults in self.iter_uncoupled():
                width = len(fusion_trees(self.symmetry, uncoupled, c)) * prod(mults)
                if width == 0:
                    continue
                yield uncoupled, slice(start, start + width), i
                start += width

    def iter_uncoupled(self, yield_slices: bool = False) -> Generator:
        """Iterate over sector combinations of the flat legs (C-style, last fastest)."""
        flat_legs = self.flat_legs
        if len(flat_legs) == 0:
            a = self.symmetry.empty_sector_array
            m = np.zeros(0, int)
            yield (a, m, []) if yield_slices else (a, m)
            return
        for idcs in it.product(*(range(s.num_sectors) for s in flat_legs)):
            a = np.array([flat_legs[n].sector_decomposition[i]
                          for n, i in enumerate(idcs)], int)
            m = np.array([flat_legs[n].multiplicities[i]
                          for n, i in enumerate(idcs)], int)
            if yield_slices:
                yield a, m, [slice(*flat_legs[n].slices[i]) for n, i in enumerate(idcs)]
            else:
                yield a, m

    # --- composition ---

    def insert_multiply(self, other: Space, pos: int) -> TensorProduct:
        iso = TensorProduct([self, other])
        return TensorProduct(self.factors[:pos] + [other] + self.factors[pos:],
                             symmetry=self.symmetry,
                             _sector_decomposition=iso.sector_decomposition,
                             _multiplicities=iso.multiplicities)

    def left_multiply(self, other: Space) -> TensorProduct:
        return self.insert_multiply(other, 0)

    def right_multiply(self, other: Space) -> TensorProduct:
        return self.insert_multiply(other, self.num_factors)

    def permuted(self, perm) -> TensorProduct:
        assert sorted(perm) == list(range(self.num_factors))
        return TensorProduct([self.factors[i] for i in perm], symmetry=self.symmetry,
                             _sector_decomposition=self.sector_decomposition,
                             _multiplicities=self.multiplicities)

    # --- dunders ---

    def __eq__(self, other):
        if not isinstance(other, TensorProduct):
            return NotImplemented
        return (self.num_factors == other.num_factors
                and self.symmetry == other.symmetry
                and all(s1 == s2 for s1, s2 in zip(self.factors, other.factors)))

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(('TensorProduct',
                               tuple(hash(f) for f in self.factors)))
        return self._hash

    def __getitem__(self, idx):
        return self.factors[idx]

    def __iter__(self):
        return iter(self.factors)

    def __len__(self):
        return self.num_factors

    def __repr__(self, show_symmetry=True, one_line=False):
        return f'TensorProduct(num_factors={self.num_factors}, dim={self.dim})'

    def _calc_sectors(self, factors) -> tuple[SectorArray, np.ndarray]:
        """Fused sector decomposition (sorted, unique) of the product."""
        factors = list(it.chain.from_iterable(l.flat_spaces for l in factors))
        if len(factors) == 0:
            return self.symmetry.trivial_sector[None, :], np.ones([1], int)
        factors = [f.as_Space() for f in factors]
        if len(factors) == 1:
            sectors = factors[0].sector_decomposition
            mults = factors[0].multiplicities
            if factors[0].sector_order == 'sorted':
                return sectors, mults
            perm = np.lexsort(sectors.T)
            return sectors[perm], mults[perm]
        if self.symmetry.is_abelian:
            grid = make_grid([sp.num_sectors for sp in factors], cstyle=False)
            sectors = self.symmetry.multiple_fusion_broadcast(
                *(sp.sector_decomposition[g] for sp, g in zip(factors, grid.T)))
            mults = np.prod([sp.multiplicities[g] for sp, g in zip(factors, grid.T)],
                            axis=0)
            sectors, mults, _ = _unique_sorted_sectors(sectors, mults)
            return sectors, mults
        # non-abelian: fold pairwise
        sectors, mults = self._calc_sectors(factors[:-1])
        sector_arrays, mult_arrays = [], []
        for s2, m2 in zip(factors[-1].sector_decomposition, factors[-1].multiplicities):
            for s1, m1 in zip(sectors, mults):
                new = self.symmetry.fusion_outcomes(s1, s2)
                sector_arrays.append(new)
                if self.symmetry.has_unique_fusion:
                    mult_arrays.append(m1 * m2 * np.ones(len(new), dtype=int))
                else:
                    mult_arrays.append(m1 * m2 * np.array(
                        [self.symmetry._n_symbol(s1, s2, c) for c in new], dtype=int))
        sectors, mults, _ = _unique_sorted_sectors(
            np.concatenate(sector_arrays, axis=0), np.concatenate(mult_arrays, axis=0))
        return sectors, mults


class AbelianLegPipe(LegPipe, ElementarySpace):
    r"""Combined leg for abelian symmetries: a pipe that *is* an ElementarySpace.

    Carries the combination metadata that the abelian backend needs to treat combined
    legs like regular legs (cf. SURVEY.md Appendix A.3):

    - ``sector_strides``: strides over ``[leg.num_sectors for leg in legs]`` in
      ``combine_cstyle`` order — maps per-leg sector-index tuples to a single int.
    - ``fusion_outcomes_sort``: permutation that sorts the fused sector list.
    - ``block_ind_map``: rows ``[b_start, b_end, i_1, ..., i_n, J]``: the sector-index
      combination ``(i_1...i_n)`` of the legs occupies ``b_start:b_end`` *within* the
      pipe block of coupled sector index ``J``.
    - ``block_ind_map_slices``: ranges of block_ind_map rows per coupled sector.
    """

    def __init__(self, legs: Sequence[ElementarySpace], is_dual: bool = False,
                 combine_cstyle: bool = True):
        LegPipe.__init__(self, legs=legs, is_dual=is_dual, combine_cstyle=combine_cstyle)
        assert self.symmetry.is_abelian and self.symmetry.can_be_dropped
        sectors, mults = self._calc_sectors()
        basis_perm = self._calc_basis_perm(mults)
        ElementarySpace.__init__(self, symmetry=self.symmetry, defining_sectors=sectors,
                                 multiplicities=mults, is_dual=is_dual,
                                 basis_perm=basis_perm)

    def _calc_sectors(self):
        """Compute defining sectors/multiplicities; sets the pipe metadata attributes."""
        self.sector_strides = make_stride([l.num_sectors for l in self.legs],
                                          cstyle=self.combine_cstyle)
        grid = make_grid([l.num_sectors for l in self.legs],
                         cstyle=self.combine_cstyle)
        nblocks = grid.shape[0]
        block_ind_map = np.zeros((nblocks, 3 + self.num_legs), dtype=np.intp)
        block_ind_map[:, 2:-1] = grid
        multiplicities = np.prod([sp.multiplicities[g]
                                  for sp, g in zip(self.legs, grid.T)], axis=0)
        sectors = self.symmetry.multiple_fusion_broadcast(
            *(s.sector_decomposition[g] for s, g in zip(self.legs, grid.T)))
        if self.is_dual:
            # sort by the *defining* sectors (duals of the decomposition)
            sectors = self.symmetry.dual_sectors(sectors)

        self.fusion_outcomes_sort = sort = np.lexsort(sectors.T)
        block_ind_map = block_ind_map[sort]
        sectors = sectors[sort]
        multiplicities = multiplicities[sort]

        slices = np.concatenate([[0], np.cumsum(multiplicities)])
        block_ind_map[:, 0] = slices[:-1]
        block_ind_map[:, 1] = slices[1:]

        diffs = find_row_differences(sectors, include_len=True)
        self.block_ind_map_slices = diffs
        slices = slices[diffs]
        multiplicities = slices[1:] - slices[:-1]
        diffs = diffs[:-1]
        sectors = sectors[diffs]

        new_block_ind = np.zeros(len(block_ind_map), dtype=np.intp)
        new_block_ind[diffs[1:]] = 1
        block_ind_map[:, -1] = new_block_ind = np.cumsum(new_block_ind)
        block_ind_map[:, :2] -= slices[new_block_ind][:, np.newaxis]
        self.block_ind_map = block_ind_map
        return sectors, multiplicities

    def _calc_basis_perm(self, multiplicities):
        """basis_perm such that combine_legs(tensor).to_numpy() == to_numpy().reshape()."""
        order = 'C' if self.combine_cstyle else 'F'
        res = np.reshape(np.arange(self.dim), [l.dim for l in self.legs], order=order)
        res = res[np.ix_(*(l.basis_perm for l in self.legs))]
        res = np.reshape(res, (self.dim,), order=order)
        return res[self._fusion_outcomes_perm(multiplicities)]

    def _fusion_outcomes_perm(self, multiplicities):
        """Basis permutation induced by stable-sorting fusion outcomes by sector."""
        dim_strides = make_stride([l.dim for l in self.legs],
                                  cstyle=self.combine_cstyle)
        perm = np.empty(self.dim, int)
        slices_starts = np.concatenate([[0], np.cumsum(multiplicities)[:-1]])
        for start, stop, *idcs, J in self.block_ind_map:
            offset = slices_starts[J]
            mult_grid = make_grid([l.multiplicities[i] for l, i in zip(self.legs, idcs)],
                                  cstyle=self.combine_cstyle)
            sector_starts = np.array([l.slices[i, 0] for l, i in zip(self.legs, idcs)])
            basis_grid = mult_grid + sector_starts
            perm[start + offset:stop + offset] = basis_grid @ dim_strides
        return perm

    def test_sanity(self):
        for l in self.legs:
            assert isinstance(l, ElementarySpace)
            l.test_sanity()
        assert self.sector_strides.shape == (self.num_legs,)
        expect = make_stride([l.num_sectors for l in self.legs],
                             cstyle=self.combine_cstyle)
        assert np.all(self.sector_strides == expect)
        assert self.block_ind_map_slices.shape == (self.num_sectors + 1,)
        M, N = self.block_ind_map.shape
        assert M == prod(l.num_sectors for l in self.legs)
        assert N == 3 + self.num_legs
        for i, (b1, b2, *idcs, J) in enumerate(self.block_ind_map):
            if i > 0 and J == self.block_ind_map[i - 1][-1]:
                assert b1 == self.block_ind_map[i - 1][1]
            else:
                assert b1 == 0
            fused = self.symmetry.multiple_fusion(
                *(l.sector_decomposition[i] for i, l in zip(idcs, self.legs)))
            assert np.all(fused == self.sector_decomposition[J])
        LegPipe.test_sanity(self)
        ElementarySpace.test_sanity(self)

    def as_Space(self):
        return self

    def as_ElementarySpace(self, is_dual: bool = False):
        return self.with_is_dual(is_dual=is_dual)

    @property
    def dual(self) -> AbelianLegPipe:
        return AbelianLegPipe([l.dual for l in reversed(self.legs)],
                              is_dual=not self.is_dual,
                              combine_cstyle=not self.combine_cstyle)

    @property
    def is_trivial(self) -> bool:
        return ElementarySpace.is_trivial.fget(self)

    @property
    def flat_spaces(self) -> list[ElementarySpace]:
        # AbelianLegPipes behave like spaces; no need to flatten
        return [self]

    def change_symmetry(self, symmetry, sector_map, injective=False):
        legs = [l.change_symmetry(symmetry, sector_map, injective) for l in self.legs]
        return AbelianLegPipe(legs, is_dual=self.is_dual,
                              combine_cstyle=self.combine_cstyle)

    def drop_symmetry(self, which='all'):
        legs = [l.drop_symmetry(which) for l in self.legs]
        return AbelianLegPipe(legs, is_dual=self.is_dual,
                              combine_cstyle=self.combine_cstyle)

    def set_basis_perm(self, basis_perm=UNSPECIFIED, inverse_basis_perm=UNSPECIFIED):
        raise TypeError(f'Can not set basis_perm for {type(self).__name__}.')

    def take_slice(self, blockmask):
        warnings.warn('AbelianLegPipe.take_slice loses the pipe structure; the result '
                      'is a plain ElementarySpace.', stacklevel=2)
        as_space = ElementarySpace(self.symmetry, self.defining_sectors,
                                   self.multiplicities, is_dual=self.is_dual,
                                   basis_perm=self._basis_perm)
        return as_space.take_slice(blockmask)

    def with_opposite_duality(self):
        return AbelianLegPipe(self.legs, is_dual=not self.is_dual,
                              combine_cstyle=self.combine_cstyle)

    def __eq__(self, other):
        return LegPipe.__eq__(self, other)

    __hash__ = Leg.__hash__

    def _compute_hash(self) -> int:
        return LegPipe._compute_hash(self)

    def __repr__(self, show_symmetry=True, one_line=False):
        return (f'AbelianLegPipe(num_legs={self.num_legs}, dim={self.dim}, '
                f'is_dual={self.is_dual}, combine_cstyle={self.combine_cstyle})')


def swap_gate(V: Leg, W: Leg) -> np.ndarray:
    """Dense representation of the braid of two legs, axes ``[W, V, W*, V*]``.

    Over- and underbraid are assumed equal (symmetric braiding required).
    """
    assert V.symmetry == W.symmetry
    if not V.symmetry.can_be_dropped:
        raise SymmetryError(f'braid has no array representation for {V.symmetry}')
    dV, dW = int(V.dim), int(W.dim)

    if not isinstance(V, ElementarySpace):
        assert isinstance(V, LegPipe)
        res = swap_gate(V.legs[-1], W)  # [W, Vz, W*, Vz*]
        for n, Vi in enumerate(reversed(V.legs[:-1])):
            sw = swap_gate(Vi, W)  # [W, Vi, W*, Vi*]
            res = np.tensordot(sw, res, (2, 0))  # [W, Vi, Vi*, {Vs}, W*, {Vs}*]
            res = np.moveaxis(res, 2, -2 - n)
        return np.reshape(res, (dW, dV, dW, dV),
                          order='C' if V.combine_cstyle else 'F')
    if not isinstance(W, ElementarySpace):
        assert isinstance(W, LegPipe)
        res = swap_gate(V, W.legs[0])  # [Wa, V, Wa*, V*]
        for n, Wi in enumerate(W.legs[1:], start=1):
            sw = swap_gate(V, Wi)
            res = np.tensordot(res, sw, (n, -1))
            res = np.transpose(res, [*range(n), -3, -2, *range(n, 2 * n), -1, -4])
        return np.reshape(res, (dW, dV, dW, dV),
                          order='C' if W.combine_cstyle else 'F')

    res = np.zeros((dW, dV, dW, dV))
    i = 0
    for a, ma in zip(V.defining_sectors, V.multiplicities):
        da = V.symmetry.sector_dim(a)
        j = 0
        for b, mb in zip(W.defining_sectors, W.multiplicities):
            swap = V.symmetry.swap_gate(a, b)  # axes [b, a, b*, a*]
            db = swap.shape[0]
            # state-major layout: sector index = state * mult + mu; the gate acts
            # on the state indices, identity on the multiplicity indices
            blk = np.einsum('uvxy,bc,ad->ubvaxcyd', swap, np.eye(mb), np.eye(ma))
            blk = blk.reshape(db * mb, da * ma, db * mb, da * ma)
            res[j:j + db * mb, i:i + da * ma, j:j + db * mb, i:i + da * ma] = blk
            j += db * mb
        i += da * ma
    inv_w, inv_v = W.inverse_basis_perm, V.inverse_basis_perm
    return res[np.ix_(inv_w, inv_v, inv_w, inv_v)]


def twist_gate(V: Leg) -> np.ndarray:
    """Dense topological twist on a whole leg, axes ``[V, V*]`` (diagonal)."""
    if not V.symmetry.can_be_dropped:
        raise SymmetryError(f'twist has no array representation for {V.symmetry}')
    return np.diag(_twist_gate_diag(V))


def _twist_gate_diag(V: Leg) -> np.ndarray:
    if not isinstance(V, ElementarySpace):
        assert isinstance(V, LegPipe)
        order = 'C' if V.combine_cstyle else 'F'
        res = _twist_gate_diag(V.legs[0])
        for Vi in V.legs[1:]:
            res = np.reshape(res[:, None] * _twist_gate_diag(Vi)[None, :], -1,
                             order=order)
        return res
    res = np.zeros(int(V.dim), dtype=complex)
    for a, (i, j) in zip(V.sector_decomposition, V.slices):
        res[i:j] = V.symmetry.topological_twist(a)
    if np.allclose(res.imag, 0):
        res = res.real
    return res[V.inverse_basis_perm]
