r"""Fusion trees and their elementary moves (braid, bend, twist, F-moves).

A copy of ``cyten_tpu/symmetries/trees.py``, role-equivalent to reference
``cyten/symmetries/trees.py`` (FusionTree :21, moves :352-1004, fusion_trees :1102).
Everything here is host-side numpy: trees label the symmetric basis, and the moves
produce sparse linear combinations of trees whose coefficients the fusion-tree
backend turns into gather/scatter plans (``backends/tree_moves.py``).

Canonical tree form: left-to-right fusion caterpillar. The n-th vertex (top to bottom)
fuses ``e ⊗ f -> g`` with multiplicity label ``multiplicities[n]`` where
``e = uncoupled[0] if n == 0 else inner_sectors[n-1]``, ``f = uncoupled[n+1]``,
``g = coupled if n == num_vertices - 1 else inner_sectors[n]``.
``are_dual[i]`` indicates a Z isomorphism above the i-th uncoupled sector.
"""

from __future__ import annotations

from math import prod
from typing import Iterable, Sequence

import numpy as np

from .core import Sector, SectorArray, Symmetry, SymmetryError

__all__ = ['FusionTree', 'fusion_trees']


class FusionTree:
    """A fusion tree: the canonical map from uncoupled sectors to a coupled sector."""

    def __init__(self, symmetry: Symmetry, uncoupled, coupled: Sector, are_dual,
                 inner_sectors, multiplicities=None):
        assert isinstance(symmetry, Symmetry)
        self.symmetry = symmetry
        self.uncoupled = np.asarray(uncoupled)
        self.num_uncoupled = len(uncoupled)
        self.num_vertices = num_vertices = max(len(uncoupled) - 1, 0)
        self.num_inner_edges = max(len(uncoupled) - 2, 0)
        self.coupled = coupled
        self.are_dual = np.asarray(are_dual, dtype=bool)
        if len(inner_sectors) == 0:
            inner_sectors = symmetry.empty_sector_array
        self.inner_sectors = np.asarray(inner_sectors, dtype=int)
        if multiplicities is None:
            multiplicities = np.zeros((num_vertices,), dtype=int)
        self.multiplicities = np.asarray(multiplicities, dtype=int)

    def test_sanity(self):
        assert self.symmetry.are_valid_sectors(self.uncoupled), 'invalid uncoupled'
        assert self.symmetry.is_valid_sector(self.coupled), 'invalid coupled'
        assert len(self.are_dual) == self.num_uncoupled
        assert len(self.inner_sectors) == self.num_inner_edges
        assert self.symmetry.are_valid_sectors(self.inner_sectors)
        assert len(self.multiplicities) == self.num_vertices
        if self.num_uncoupled == 0:
            assert np.all(self.coupled == self.symmetry.trivial_sector)
        if self.num_uncoupled == 1:
            assert np.all(self.uncoupled[0] == self.coupled)
        for n in range(self.num_vertices):
            a, b, mu, c = self.vertex_labels(n)
            N = self.symmetry.n_symbol(a, b, c)
            assert N > 0, 'inconsistent fusion'
            assert 0 <= mu < N, 'invalid multiplicity label'

    # --- constructors ---

    @classmethod
    def from_empty(cls, symmetry: Symmetry) -> FusionTree:
        return cls(symmetry, symmetry.empty_sector_array, symmetry.trivial_sector,
                   [], symmetry.empty_sector_array, [])

    @classmethod
    def from_sector(cls, symmetry: Symmetry, sector: Sector, is_dual: bool) -> FusionTree:
        return cls(symmetry, [sector], sector, [is_dual],
                   symmetry.empty_sector_array, [])

    @classmethod
    def from_abelian_symmetry(cls, symmetry: Symmetry, uncoupled, are_dual) -> FusionTree:
        """The unique tree for abelian symmetries (fusion determines everything)."""
        assert symmetry.is_abelian
        if len(uncoupled) == 0:
            return cls.from_empty(symmetry)
        if len(uncoupled) == 1:
            return cls.from_sector(symmetry, uncoupled[0], are_dual[0])
        inner = []
        last = uncoupled[0]
        for a in uncoupled[1:]:
            last = symmetry.fusion_outcomes(last, a)[0]
            inner.append(last)
        return cls(symmetry, uncoupled, inner[-1], are_dual, inner[:-1])

    # --- basic structure ---

    @property
    def pre_Z_uncoupled(self) -> SectorArray:
        """The sectors above the Z isomorphisms."""
        res = self.uncoupled.copy()
        res[self.are_dual, :] = self.symmetry.dual_sectors(res[self.are_dual, :])
        return res

    def vertex_labels(self, n: int) -> tuple[Sector, Sector, int, Sector]:
        """(a, b, mu, c) of the n-th vertex: a ⊗ b -> c with multiplicity label mu."""
        a = self.uncoupled[0] if n == 0 else self.inner_sectors[n - 1]
        b = self.uncoupled[n + 1]
        c = self.coupled if n == self.num_vertices - 1 else self.inner_sectors[n]
        return a, b, self.multiplicities[n], c

    def copy(self, deep=True) -> FusionTree:
        if deep:
            return FusionTree(self.symmetry, self.uncoupled.copy(),
                              np.array(self.coupled), self.are_dual.copy(),
                              self.inner_sectors.copy(), self.multiplicities.copy())
        return FusionTree(self.symmetry, self.uncoupled, self.coupled, self.are_dual,
                          self.inner_sectors, self.multiplicities)

    def modify_vertex_labels(self, n: int, a: Sector, b: Sector, mu: int, c: Sector,
                             copy: bool = True) -> FusionTree:
        """Update sectors/multiplicity around the n-th vertex; inverse of
        :meth:`vertex_labels`. ``None`` entries are kept. Reference: trees.py:574."""
        if copy:
            return self.copy(deep=True).modify_vertex_labels(n, a, b, mu, c,
                                                             copy=False)
        if a is not None:
            if n == 0:
                self.uncoupled[0] = a
            else:
                self.inner_sectors[n - 1] = a
        if b is not None:
            self.uncoupled[n + 1] = b
        if c is not None:
            if n == self.num_vertices - 1:
                self.coupled = np.asarray(c)
            else:
                self.inner_sectors[n] = c
        if mu is not None:
            self.multiplicities[n] = mu
        return self

    def ascii_diagram(self, dagger: bool = False) -> str:
        """Visual ASCII rendering of the tree (cf. reference trees.py:322).

        Drawn with the coupled sector at the bottom (top if `dagger`), uncoupled
        sectors across the other side, one fusion vertex per inner line.
        """
        sym = self.symmetry
        unc = [f'{sym.sector_str(a)}' + ('*' if d else '')
               for a, d in zip(self.uncoupled, self.are_dual)]
        if self.num_uncoupled == 0:
            return sym.sector_str(self.coupled)
        if self.num_uncoupled == 1:
            lines = [unc[0], '|', sym.sector_str(self.coupled)]
            return '\n'.join(reversed(lines) if dagger else lines)
        width = max(len(s) for s in unc) + 2
        top = ''.join(s.center(width) for s in unc)
        rows = [top, ''.join('|'.center(width) for _ in unc)]
        # successive fusions left to right: after vertex n the leftmost line carries
        # inner_sectors[n] (or coupled at the last vertex)
        for n in range(self.num_vertices):
            c = self.coupled if n == self.num_vertices - 1 else self.inner_sectors[n]
            mu = self.multiplicities[n]
            joint = '\\' + '_' * (width - 2) + '/'
            pad = ' ' * (n * width // 2)
            label = sym.sector_str(c) + (f'[{mu}]' if not sym.has_unique_fusion
                                         else '')
            rows.append(pad + joint + ''.join(
                '|'.center(width) for _ in range(self.num_uncoupled - n - 2)))
            rows.append(pad + label.center(width) + ''.join(
                '|'.center(width) for _ in range(self.num_uncoupled - n - 2)))
        return '\n'.join(reversed(rows) if dagger else rows)

    def __hash__(self) -> int:
        if self.symmetry.is_abelian:
            parts = (self.are_dual, self.coupled, self.uncoupled)
        elif self.symmetry.has_unique_fusion:
            parts = (self.are_dual, self.coupled, self.uncoupled, self.inner_sectors)
        else:
            parts = (self.are_dual, self.coupled, self.uncoupled, self.inner_sectors,
                     self.multiplicities)
        return hash(tuple(tuple(np.asarray(p).flatten().tolist()) for p in parts))

    def __eq__(self, other) -> bool:
        if not isinstance(other, FusionTree):
            return False
        return (np.all(self.are_dual == other.are_dual)
                and np.all(self.coupled == other.coupled)
                and np.all(self.uncoupled == other.uncoupled)
                and np.all(self.inner_sectors == other.inner_sectors)
                and np.all(self.multiplicities == other.multiplicities))

    def __str__(self) -> str:
        return 'FusionTree' + self._signature_str()

    __repr__ = __str__

    def _signature_str(self) -> str:
        sym = self.symmetry
        unc = ', '.join(
            f'dual({sym.sector_str(sym.dual_sector(a))})' if d else sym.sector_str(a)
            for a, d in zip(self.uncoupled, self.are_dual))
        inner = ', '.join(sym.sector_str(a) for a in self.inner_sectors)
        return (f'[({unc}) -> {sym.sector_str(self.coupled)}'
                + (f'; inner=({inner})' if len(self.inner_sectors) else '')
                + (f'; mu={list(self.multiplicities)}'
                   if not sym.has_unique_fusion else '') + ']')

    # --- elementary moves ---

    def braid(self, j: int, overbraid: bool, cutoff: float = 1e-16,
              do_conj: bool = False) -> dict[FusionTree, complex]:
        r"""Braid ``uncoupled[j]`` over/under ``uncoupled[j+1]``.

        Returns the braided tree as a linear combination ``{X_i: a_i}``.
        ``j == 0`` is an R-move (diagonal); ``j > 0`` a C-move (mixes inner sectors
        and multiplicities).
        """
        assert 0 <= j < self.num_uncoupled - 1
        sym = self.symmetry
        if j == 0:  # R-move
            a, b, mu, c = self.vertex_labels(0)
            if overbraid:
                coeff = sym.r_symbol(a, b, c)[mu]
            else:
                coeff = np.conj(sym.r_symbol(b, a, c)[mu])
            if do_conj:
                coeff = np.conj(coeff)
            X_i = self.copy(deep=True)
            X_i.uncoupled[0] = b
            X_i.uncoupled[1] = a
            X_i.are_dual[:2] = X_i.are_dual[1::-1]
            return {X_i: coeff}

        # C-move
        res: dict[FusionTree, complex] = {}
        a, b, mu, e = self.vertex_labels(j - 1)
        _, c, nu, d = self.vertex_labels(j)
        template = self.copy(deep=True)
        template.uncoupled[j] = c
        template.uncoupled[j + 1] = b
        template.are_dual[j] = self.are_dual[j + 1]
        template.are_dual[j + 1] = self.are_dual[j]
        for f in sym.fusion_outcomes(a, c):
            if not sym.can_fuse_to(f, b, d):
                continue
            if overbraid:
                C = sym.c_symbol(a, b, c, d, e, f)[mu, nu]
            else:
                # underbraid: conj, b <-> c, e <-> f, (mu,nu) <-> (kappa,lambda)
                C = np.conj(sym.c_symbol(a, c, b, d, f, e)[:, :, mu, nu])
            if do_conj:
                C = np.conj(C)
            for (kappa, lam), coeff in np.ndenumerate(C):
                if abs(coeff) < cutoff:
                    continue
                X_i = template.copy(deep=True)
                X_i.inner_sectors[j - 1] = f
                X_i.multiplicities[j - 1] = kappa
                X_i.multiplicities[j] = lam
                res[X_i] = coeff
        return res

    @staticmethod
    def bend_leg(X: FusionTree, Y: FusionTree, bend_downward: bool,
                 do_conj: bool = False) -> dict[tuple[FusionTree, FusionTree], complex]:
        r"""Bend a leg on the tree pair ``hconj(X) @ Y``.

        ``bend_downward=True``: the rightmost leg of the fusion tree `Y` is bent down
        (into the splitting side). ``False``: the rightmost leg of ``hconj(X)`` is bent
        up. Returns ``{(X_i, Y_i): b_i}`` with ``bent = sum_i b_i hconj(X_i) @ Y_i``
        (note: the reference's dict keys are ordered (new_fusion, new_splitting); we
        return (new_splitting_as_fusion_tree X_i, new_fusion_tree Y_i) pairs in the
        convention of the docstring above — for ``bend_downward=True``, the moved leg
        leaves `Y` and joins `X`).
        """
        if not bend_downward:
            # dagger trick: bend down on the swapped pair, then swap back and conj
            other = FusionTree.bend_leg(Y, X, bend_downward=True, do_conj=not do_conj)
            return {(Y_i, X_i): b_i for (X_i, Y_i), b_i in other.items()}

        sym = Y.symmetry
        assert X.symmetry == sym
        assert np.all(Y.coupled == X.coupled)
        c = Y.coupled
        if Y.num_uncoupled == 0:
            raise ValueError('No leg to bend.')
        is_dual = Y.are_dual[-1]

        if Y.num_uncoupled == 1:
            Y_i = FusionTree.from_empty(sym)
            X_i = X.extended(sym.dual_sector(c), 0, sym.trivial_sector, not is_dual)
            b_i = sym.sqrt_qdim(c)
            if is_dual:
                b_i = b_i * sym.frobenius_schur(c)
            if do_conj:
                b_i = np.conj(b_i)
            return {(X_i, Y_i): b_i}

        Y_rest, c, mu, z = Y.split_bottom_vertex()

        if X.num_uncoupled == 0:
            e = Y_rest.coupled
            X_i = FusionTree.from_sector(sym, e, is_dual=not is_dual)
            b_i = sym.inv_sqrt_qdim(e)
            if not is_dual:
                b_i = b_i * sym.frobenius_schur(e)
            if do_conj:
                b_i = np.conj(b_i)
            return {(X_i, Y_rest): b_i}

        B = sym.b_symbol(Y_rest.coupled, z, c)
        chi_z = sym.frobenius_schur(z)
        zbar = sym.dual_sector(z)
        res = {}
        for nu in range(B.shape[1]):
            b_i = B[mu, nu]
            X_i = X.extended(zbar, nu, Y_rest.coupled, not is_dual)
            if is_dual:
                b_i = b_i * chi_z
            if do_conj:
                b_i = np.conj(b_i)
            res[X_i, Y_rest] = b_i
        return res

    def twist(self, idcs: Sequence[int], overtwist: bool) -> dict[FusionTree, complex]:
        """Twist the legs `idcs` (jointly) above the tree.

        Prefix sets (and single legs / all legs) are diagonal: a twist of the
        corresponding inner (or coupled) sector. A contiguous mid-segment
        ``[i, j)`` uses the ribbon identity
        ``theta_{A (x) B} = c_{B,A} c_{A,B} (theta_A (x) theta_B)`` with
        ``A = [0, i)``: the segment twist is the prefix twist of ``[0, j)``
        times the inverse prefix twist of ``[0, i)`` and the inverse double
        block-braiding — a linear combination of trees. (The reference raises
        ``NotImplementedError`` here and sketches exactly this as its
        'Option A', reference symmetries/trees.py:1090-1099.)

        Non-contiguous sets depend on how the strands are routed into the
        twist loop; the convention here is to gather them rightward — each
        selected strand passing OVER the skipped ones, independent of the
        twist chirality, so undertwist stays the exact inverse of overtwist —
        into a contiguous block, twist, and route back.
        """
        sym = self.symmetry
        if sym.has_trivial_braid or len(idcs) == 0:
            return {self: 1}
        idcs = sorted(i % self.num_uncoupled for i in idcs)
        assert len(set(idcs)) == len(idcs), 'duplicate idcs'
        if len(idcs) == 1:
            theta = sym.topological_twist(self.uncoupled[idcs[0]])
        elif len(idcs) == self.num_uncoupled:
            # slide the whole tree through: twist of the coupled sector
            theta = sym.topological_twist(self.coupled)
        elif idcs == [*range(len(idcs))]:
            # contiguous from the left: twist of the corresponding inner sector
            theta = sym.topological_twist(self.inner_sectors[idcs[-1] - 1])
        elif idcs == [*range(idcs[0], idcs[-1] + 1)]:
            return self._twist_segment(idcs[0], idcs[-1] + 1, overtwist)
        else:
            return self._twist_gathered(idcs, overtwist)
        if not overtwist:
            theta = np.conj(theta)
        return {self: theta}

    def _twist_segment(self, i: int, j: int,
                       overtwist: bool) -> dict[FusionTree, complex]:
        """Joint twist of the contiguous legs ``[i, j)`` via the ribbon
        identity (see :meth:`twist`); ``0 < i < j <= num_uncoupled``."""
        # operators act bottom-up: c_{B,A}^-1 (inverse of the exchange whose
        # left block has size j-i), then c_{A,B}^-1, then the prefix twist of
        # [0, j) (central within the first j strands, so it may follow the
        # braids), then the inverse prefix twist of [0, i) on top
        terms = {self: 1. + 0j}
        terms = _apply_block_exchange(terms, j - i, j, overtwist, invert=True)
        terms = _apply_block_exchange(terms, i, j, overtwist, invert=True)
        out: dict[FusionTree, complex] = {}
        for tree, coeff in terms.items():
            # the fused sector of the prefix [0, k) is inner_sectors[k - 2]
            th_j = tree.symmetry.topological_twist(
                tree.coupled if j == tree.num_uncoupled
                else tree.inner_sectors[j - 2])
            th_i = tree.symmetry.topological_twist(
                tree.uncoupled[0] if i == 1 else tree.inner_sectors[i - 2])
            if not overtwist:
                th_j = np.conj(th_j)
                th_i = np.conj(th_i)
            c = coeff * th_j / th_i
            out[tree] = out.get(tree, 0) + c
        return {t: c for t, c in out.items() if abs(c) > 1e-14}

    def _twist_gathered(self, idcs: list[int],
                        overtwist: bool) -> dict[FusionTree, complex]:
        """Joint twist of a non-contiguous leg set: gather the selected legs
        rightward into a contiguous block ending at ``idcs[-1]``, twist the
        block, and invert the gathering braids (routing convention documented
        in :meth:`twist`)."""
        gather: list[int] = []  # elementary braid positions, in apply order
        target = idcs[-1]
        # move each selected leg (right to left in selection order) rightward
        # so the block [target - len + 1, target] becomes selected
        positions = list(idcs)
        for k in range(len(positions) - 2, -1, -1):
            want = target - (len(positions) - 1 - k)
            for p in range(positions[k], want):
                gather.append(p)
        terms = {self: 1. + 0j}
        # the gather routing is a FIXED convention (selected strands pass over
        # the skipped ones), independent of the twist chirality: the mirror
        # image of the whole diagram then flips every crossing, which is
        # exactly conjugating by the same gather — so undertwist stays the
        # adjoint of overtwist
        for p in gather:
            terms = _apply_move(
                terms, lambda t, p=p: t.braid(p, overbraid=True))
        lo = target - len(idcs) + 1
        out: dict[FusionTree, complex] = {}
        for tree, coeff in terms.items():
            if lo == 0:
                th = tree.symmetry.topological_twist(
                    tree.coupled if target + 1 == tree.num_uncoupled
                    else tree.inner_sectors[target - 1])
                if not overtwist:
                    th = np.conj(th)
                sub = {tree: th}
            else:
                sub = tree._twist_segment(lo, target + 1, overtwist)
            for t2, c2 in sub.items():
                out[t2] = out.get(t2, 0) + coeff * c2
        for p in reversed(gather):
            out = _apply_move(
                out, lambda t, p=p: t.braid(p, overbraid=False))
        return {t: c for t, c in out.items() if abs(c) > 1e-14}

    # --- tree algebra ---



    def extended(self, new_uncoupled: Sector, mu: int, new_coupled: Sector,
                 is_dual: bool) -> FusionTree:
        """Add a fusion vertex at the bottom: (coupled ⊗ new_uncoupled)_mu -> new_coupled."""
        if self.num_uncoupled == 0:
            assert mu == 0
            multiplicities = []
        else:
            multiplicities = np.append(self.multiplicities, mu)
        if self.num_uncoupled < 2:
            inner_sectors = self.inner_sectors
        else:
            inner_sectors = np.append(self.inner_sectors, self.coupled[None, :], axis=0)
        return FusionTree(
            self.symmetry,
            uncoupled=np.append(self.uncoupled, np.asarray(new_uncoupled)[None, :],
                                axis=0),
            coupled=new_coupled,
            are_dual=np.append(self.are_dual, is_dual),
            inner_sectors=inner_sectors, multiplicities=multiplicities)

    def split_bottom_vertex(self) -> tuple[FusionTree, Sector, int, Sector]:
        """Inverse of :meth:`extended`: returns (rest_tree, coupled, mu, last_uncoupled)."""
        if self.num_uncoupled == 0:
            raise ValueError('Cannot split empty tree')
        if self.num_uncoupled == 1:
            return FusionTree.from_empty(self.symmetry), self.coupled, 0, self.coupled
        if self.num_uncoupled == 2:
            rest = FusionTree.from_sector(self.symmetry, self.uncoupled[0],
                                          is_dual=self.are_dual[0])
            return rest, self.coupled, self.multiplicities[0], self.uncoupled[-1]
        rest = FusionTree(self.symmetry, self.uncoupled[:-1], self.inner_sectors[-1],
                          self.are_dual[:-1], self.inner_sectors[:-1],
                          self.multiplicities[:-1])
        return rest, self.coupled, self.multiplicities[-1], self.uncoupled[-1]

    def insert(self, t2: FusionTree) -> FusionTree:
        """Insert `t2` above the *first* uncoupled sector (stays canonical)."""
        return FusionTree(
            self.symmetry,
            uncoupled=np.concatenate([t2.uncoupled, self.uncoupled[1:]]),
            coupled=self.coupled,
            are_dual=np.concatenate([t2.are_dual, self.are_dual[1:]]),
            inner_sectors=np.concatenate([t2.inner_sectors, self.uncoupled[:1],
                                          self.inner_sectors]),
            multiplicities=np.concatenate([t2.multiplicities, self.multiplicities]))

    def insert_at(self, n: int, t2: FusionTree, eps: float = 1e-14
                  ) -> dict[FusionTree, complex]:
        """Insert `t2` above ``uncoupled[n]``; F-moves restore canonical form."""
        assert self.symmetry == t2.symmetry
        assert np.all(self.uncoupled[n] == t2.coupled)
        assert not self.are_dual[n]
        sym = self.symmetry

        if t2.num_uncoupled == 0:
            # removing uncoupled[n] (it is the trivial sector)
            res_unc = np.vstack((self.uncoupled[:n], self.uncoupled[n + 1:]))
            res_dual = np.concatenate([self.are_dual[:n], self.are_dual[n + 1:]])
            idx = max(0, n - 1)
            res_inner = np.vstack((self.inner_sectors[:idx],
                                   self.inner_sectors[idx + 1:]))
            res_mult = np.concatenate([self.multiplicities[:idx],
                                       self.multiplicities[idx + 1:]])
            return {FusionTree(sym, res_unc, self.coupled, res_dual, res_inner,
                               res_mult): 1}
        if t2.num_vertices == 0:
            if t2.are_dual[0]:
                res = self.copy()
                res.are_dual = self.are_dual.copy()
                res.are_dual[n] = True
                return {res: 1}
            return {self: 1}
        if self.num_vertices == 0:
            return {t2: 1}
        if n == 0:
            return {self.insert(t2): 1}

        # general case: iterate F-moves from the right of the inserted subtree
        coefficients: dict[FusionTree, complex] = {}
        new_unc = np.vstack((self.uncoupled[:n], t2.uncoupled, self.uncoupled[n + 1:]))
        new_dual = np.concatenate([self.are_dual[:n], t2.are_dual,
                                   self.are_dual[n + 1:]])
        inners_left = self.inner_sectors[:n - 1]
        inners_right = self.inner_sectors[n - 1:]
        mults_left = self.multiplicities[:n - 1]
        mults_right = self.multiplicities[n:]

        a = self.uncoupled[0] if len(inners_left) == 0 else inners_left[-1]
        d_initial = self.coupled if n == self.num_uncoupled - 1 else inners_right[0]
        # state: (tuple of new inner sectors, tuple of multiplicities) -> amplitude
        parts: dict[tuple, complex] = {((), (self.multiplicities[n - 1],)): 1}
        for i in range(t2.num_uncoupled - 1, 0, -1):
            new_parts: dict[tuple, complex] = {}
            for (inners, multis), amp in parts.items():
                b = t2.inner_sectors[i - 2] if i > 1 else t2.uncoupled[0]
                c = t2.uncoupled[i]
                d = np.asarray(inners[0], dtype=int) if inners else d_initial
                e = t2.coupled if not inners else t2.inner_sectors[i - 1]
                multi = t2.multiplicities[i - 1]
                for f in sym.fusion_outcomes(a, b):
                    if not sym.can_fuse_to(f, c, d):
                        continue
                    fs = sym._f_symbol(a, b, c, d, e, f)[multi, multis[0], :, :]
                    for (kap, lam), factor in np.ndenumerate(fs):
                        if abs(factor) < eps:
                            continue
                        key = ((tuple(f), *inners), (kap, lam, *multis[1:]))
                        new_parts[key] = new_parts.get(key, 0) + amp * factor
            parts = new_parts

        for (inners, multis), amp in parts.items():
            inners = np.asarray(inners, dtype=int)
            new_inner = np.vstack((inners_left, inners, inners_right))
            new_mult = np.concatenate([mults_left, multis, mults_right])
            tree = FusionTree(sym, new_unc, self.coupled, new_dual, new_inner, new_mult)
            coefficients[tree] = amp
        return coefficients

    def outer(self, right_tree: FusionTree, eps: float = 1e-14
              ) -> dict[FusionTree, complex]:
        """Outer product: fuse with `right_tree` at the coupled sector.

        Sums the per-embedding decompositions of :meth:`outer_embeddings` over
        all embeddings (coupled sector c, fusion multiplicity label m), which is
        only an unambiguous linear combination when every result tree is reached
        from a single embedding. Code that pairs a codomain-side and a
        domain-side product (e.g. the backend ``outer``) must use
        :meth:`outer_embeddings` and contract the embedding label instead.
        """
        res: dict[FusionTree, complex] = {}
        for decomp in self.outer_embeddings(right_tree, eps=eps).values():
            for t, c in decomp.items():
                res[t] = res.get(t, 0) + c
        return res

    def outer_embeddings(self, right_tree: FusionTree, eps: float = 1e-14
                         ) -> dict[tuple, dict[FusionTree, complex]]:
        """Per-embedding canonical decompositions of the product with `right_tree`.

        The product ``self (x) right_tree`` is a map into ``cA (x) cB``, not an
        irrep; resolving ``id_{cA (x) cB} = sum_{c, m} X_{c,m}^dagger X_{c,m}``
        gives one canonical-tree decomposition per embedding ``(c, m)``, where
        ``m`` labels the fusion multiplicity ``N(cA, cB -> c)``. Returns
        ``{(tuple(c), m): {tree: coeff}}``.

        Pairing a codomain-side and a domain-side product MUST contract the
        embedding label — i.e. combine only equal ``(c, m)`` keys. Summing each
        side over ``m`` independently (as the reference does in its backend
        ``outer``, fusion_tree_backend.py:1604-1631) double-counts the
        off-diagonal ``(m, m')`` pairs and is wrong as soon as a fusion
        multiplicity ``N > 1`` exists — e.g. ``outer(eye, eye) != eye`` for
        SU(3) or SU(3)_3 (dense oracle: tests/test_ops_coverage.py).
        """
        sym = self.symmetry
        if self.num_uncoupled == 0:
            return {(tuple(int(x) for x in right_tree.coupled), 0):
                    {right_tree: 1}}
        if right_tree.num_uncoupled == 0:
            return {(tuple(int(x) for x in self.coupled), 0): {self: 1}}
        res: dict[tuple, dict[FusionTree, complex]] = {}
        unc = np.vstack((self.uncoupled, right_tree.coupled))
        dual = np.concatenate([self.are_dual, [False]])
        if self.num_uncoupled <= 1:
            inner = np.zeros((0, unc.shape[1]), dtype=int)
        else:
            inner = np.vstack((self.inner_sectors, self.coupled))
        for new_coupled in sym.fusion_outcomes(self.coupled, right_tree.coupled):
            for m in range(sym._n_symbol(self.coupled, right_tree.coupled,
                                         new_coupled)):
                multi = np.concatenate([self.multiplicities, [m]])
                tree = FusionTree(sym, unc, new_coupled, dual, inner, multi)
                decomp = tree.insert_at(self.num_uncoupled, right_tree, eps=eps)
                if decomp:
                    res[(tuple(int(x) for x in new_coupled), m)] = decomp
        return res

    def split(self, n: int) -> tuple[FusionTree, FusionTree]:
        """Split at inner edge n-2: (fuses uncoupled[:n]) and (fuses the rest)."""
        if n < 2:
            raise ValueError('Left tree has no vertices (n < 2)')
        if n >= self.num_uncoupled:
            raise ValueError('Right tree has no vertices (n >= num_uncoupled)')
        cut = self.inner_sectors[n - 2]
        t1 = FusionTree(self.symmetry, self.uncoupled[:n], cut, self.are_dual[:n],
                        self.inner_sectors[:n - 2], self.multiplicities[:n - 1])
        t2 = FusionTree(self.symmetry,
                        np.concatenate([cut[None, :], self.uncoupled[n:]]),
                        self.coupled, np.insert(self.are_dual[n:], 0, False),
                        self.inner_sectors[n - 1:], self.multiplicities[n - 1:])
        return t1, t2

    # --- dense realization ---

    def as_block(self, dtype=None) -> np.ndarray:
        """Dense matrix elements of the tree map, axes ``[m_a1, ..., m_aJ, m_c]``."""
        sym = self.symmetry
        if not sym.can_be_dropped:
            raise SymmetryError(f'No array representation for {sym}')
        np_dtype = np.float64 if dtype is None else dtype
        if self.num_uncoupled == 0:
            return np.ones([1])
        if self.num_uncoupled == 1:
            if self.are_dual[0]:
                return np.asarray(sym.Z_iso(sym.dual_sector(self.uncoupled[0]))).T.copy()
            return np.eye(sym.sector_dim(self.coupled))
        if self.num_uncoupled == 2:
            mu = self.multiplicities[0]
            X = sym.fusion_tensor(self.uncoupled[0], self.uncoupled[1], self.coupled,
                                  self.are_dual[0], self.are_dual[1])[mu]
            return np.asarray(X)
        X0 = sym.fusion_tensor(self.uncoupled[0], self.uncoupled[1],
                               self.inner_sectors[0], Z_a=self.are_dual[0],
                               Z_b=self.are_dual[1])[self.multiplicities[0]]
        res = np.asarray(X0)  # [a0, a1, i0]
        for vertex in range(1, self.num_vertices):
            mu = self.multiplicities[vertex]
            a = self.inner_sectors[vertex - 1]
            b = self.uncoupled[vertex + 1]
            c = (self.inner_sectors[vertex] if vertex < self.num_inner_edges
                 else self.coupled)
            X = sym.fusion_tensor(a, b, c, Z_b=self.are_dual[vertex + 1])[mu]
            res = np.tensordot(res, X, (res.ndim - 1, 0))
        return res


class fusion_trees(Iterable[FusionTree]):
    r"""Iterable over all canonical :class:`FusionTree`\ s with given (un)coupled sectors.

    Deterministic order; ``len`` and :meth:`index` are computed without materializing
    intermediate trees.
    """

    def __init__(self, symmetry: Symmetry, uncoupled, coupled: Sector, are_dual=None):
        assert isinstance(symmetry, Symmetry)
        self.symmetry = symmetry
        if len(uncoupled) == 0:
            uncoupled = symmetry.empty_sector_array
        self.uncoupled = np.asarray(uncoupled)
        self.num_uncoupled = num_uncoupled = len(uncoupled)
        self.coupled = coupled
        self.are_dual = (np.zeros((num_uncoupled,), bool) if are_dual is None
                         else np.asarray(are_dual))

    def __iter__(self):
        sym = self.symmetry
        if self.num_uncoupled == 0:
            if np.all(self.coupled == sym.trivial_sector):
                yield FusionTree(sym, self.uncoupled, self.coupled, [], [], [])
            return
        if self.num_uncoupled == 1:
            if np.all(self.uncoupled[0] == self.coupled):
                yield FusionTree(sym, self.uncoupled, self.coupled, self.are_dual,
                                 [], [])
            return
        if self.num_uncoupled == 2:
            for mu in range(sym.n_symbol(self.uncoupled[0], self.uncoupled[1],
                                         self.coupled)):
                yield FusionTree(sym, self.uncoupled, self.coupled, self.are_dual,
                                 [], [mu])
            return
        a1, a2 = self.uncoupled[0], self.uncoupled[1]
        for b in sym.fusion_outcomes(a1, a2):
            rest_unc = np.concatenate([b[None, :], self.uncoupled[2:]])
            rest_dual = np.concatenate([[False], self.are_dual[2:]])
            left = FusionTree(sym, self.uncoupled[:2], b, self.are_dual[:2], [], [0])
            for rest in fusion_trees(sym, rest_unc, self.coupled, rest_dual):
                tree = rest.insert(left)
                for mu in range(sym._n_symbol(a1, a2, b)):
                    res = tree.copy()
                    res.multiplicities = res.multiplicities.copy()
                    res.multiplicities[0] = mu
                    yield res

    def __len__(self) -> int:
        sym = self.symmetry
        if self.num_uncoupled == 0:
            return 1 if np.all(self.coupled == sym.trivial_sector) else 0
        if self.num_uncoupled == 1:
            return 1 if np.all(self.uncoupled[0] == self.coupled) else 0
        if self.num_uncoupled == 2:
            return sym.n_symbol(self.uncoupled[0], self.uncoupled[1], self.coupled)
        a1, a2 = self.uncoupled[0], self.uncoupled[1]
        count = 0
        for b in sym.fusion_outcomes(a1, a2):
            rest_unc = np.concatenate([b[None, :], self.uncoupled[2:]])
            count += sym._n_symbol(a1, a2, b) \
                * len(fusion_trees(sym, rest_unc, self.coupled))
        return count

    def index(self, tree: FusionTree) -> int:
        """Position of `tree` in the iteration order."""
        if not self.symmetry.is_equivalent_to(tree.symmetry):
            raise ValueError('Inconsistent symmetries')
        if not np.all(self.uncoupled == tree.uncoupled):
            raise ValueError('Inconsistent uncoupled sectors')
        if not np.all(self.coupled == tree.coupled):
            raise ValueError('Inconsistent coupled sector')
        if not np.all(self.are_dual == tree.are_dual):
            raise ValueError('Inconsistent dualities')
        return self._compute_index(tree)

    def _compute_index(self, tree: FusionTree) -> int:
        sym = self.symmetry
        if self.num_uncoupled < 2:
            if self.num_uncoupled == 0 and np.all(self.coupled == sym.trivial_sector):
                return 0
            if self.num_uncoupled == 1 and np.all(self.uncoupled[0] == self.coupled):
                return 0
            raise ValueError('Inconsistent coupled sector.')

        idx = 0
        left_multi = 1  # product of multiplicities of fixed vertices so far
        max_multis = []
        for i in range(self.num_uncoupled - 2):
            target = tree.inner_sectors[i]
            left_sec = self.uncoupled[i] if i == 0 else tree.inner_sectors[i - 1]
            found = False
            for f in sym.fusion_outcomes(left_sec, self.uncoupled[i + 1]):
                multi = sym._n_symbol(left_sec, self.uncoupled[i + 1], f)
                if np.all(f == target):
                    found = True
                    left_multi *= multi
                    max_multis.append(multi)
                    break
                rest_unc = np.concatenate([f[None, :], self.uncoupled[i + 2:]])
                rest_dual = np.concatenate([[False], self.are_dual[i + 2:]])
                idx += left_multi * multi * len(
                    fusion_trees(sym, rest_unc, self.coupled, rest_dual))
            if not found:
                raise ValueError('Inconsistent inner sector.')

        left_sec = (self.uncoupled[0] if self.num_uncoupled == 2
                    else tree.inner_sectors[-1])
        if not sym.can_fuse_to(left_sec, self.uncoupled[-1], self.coupled):
            raise ValueError('Inconsistent inner sector.')
        max_multis.append(sym._n_symbol(left_sec, self.uncoupled[-1], self.coupled))
        if not np.all(tree.multiplicities < max_multis):
            raise ValueError('Inconsistent multiplicity.')
        if not sym.is_abelian:
            idx += sum(m * prod(max_multis[:i])
                       for i, m in enumerate(tree.multiplicities))
        return idx

    def __str__(self):
        return (f'fusion_trees[{self.symmetry!s}]'
                f'({[self.symmetry.sector_str(a) for a in self.uncoupled]} -> '
                f'{self.symmetry.sector_str(self.coupled)})')


def _apply_move(terms: dict, move) -> dict:
    """Apply a tree-move (tree -> {tree: coeff}) to a linear combination."""
    out: dict = {}
    for tree, coeff in terms.items():
        for t2, c2 in move(tree).items():
            out[t2] = out.get(t2, 0) + coeff * c2
    return {t: c for t, c in out.items() if abs(c) > 1e-14}


def _apply_block_exchange(terms: dict, left: int, j: int, over: bool,
                          invert: bool = False) -> dict:
    """Braid the leg block ``[0, left)`` past ``[left, j)`` (the left block
    passes OVER for ``over=True``), as a schedule of elementary braids.

    ``invert=True`` applies the exact inverse morphism — which acts on the
    *exchanged* configuration (right block of size ``left`` now leftmost) and
    undoes it: reversed schedule, opposite chirality."""
    moves = [left - 1 - t + s for s in range(j - left) for t in range(left)]
    chir = over
    if invert:
        moves = moves[::-1]
        chir = not over
    for p in moves:
        terms = _apply_move(terms, lambda t, p=p: t.braid(p, overbraid=chir))
    return terms
