"""Model base classes built on sites + couplings.

The counterpart of ``cyten_tpu/models/tenpy_models.py``: ``CouplingModel`` (:36)
collects onsite terms and couplings on a chain and emits the ``H_bonds`` /
``H_mpo`` data used by the DMRG engine; ``TFIModel`` (:124), ``GoldenModel`` and
``GoldenChain`` (:137-147) are built on it.
"""

from __future__ import annotations

from typing import Protocol

from .couplings import Coupling, gold_coupling
from .degrees_of_freedom import Site
from .sites import GoldenSite, SpinHalfSite

__all__ = ['CouplingModel', 'CouplingFactory', 'CouplingLike', 'TFIModel',
           'GoldenModel', 'GoldenChain']


class CouplingFactory(Protocol):
    """Functions that create couplings: called with a list of sites (plus keyword
    parameters), they return a :class:`Coupling`, as the factories of
    :mod:`cyten_tpu_torch.models.couplings` do."""

    def __call__(self, sites: list[Site], *, name: str | None = ...) -> Coupling: ...


#: anything :class:`CouplingModel` methods accept as a coupling term
CouplingLike = Coupling | CouplingFactory


class CouplingModel:
    """A 1D chain model defined by onsite terms and couplings between any two sites."""

    def __init__(self, sites: list[Site]):
        self.sites = list(sites)
        self.L = len(sites)
        self.onsite_terms: list[tuple[int, Coupling]] = []
        self.bond_terms: list[tuple[int, Coupling]] = []
        self.pair_terms: list[tuple[int, int, Coupling]] = []

    def add_onsite(self, i: int, coupling: Coupling):
        if coupling.num_sites != 1:
            raise ValueError('add_onsite needs a one-site coupling')
        self.onsite_terms.append((i, coupling))
        return self

    def add_coupling(self, i: int, coupling: Coupling, j: int = None):
        """Add a 2-site coupling acting on sites ``(i, j)``; default j = i+1.

        ``j > i + 1`` (J1-J2, 2D lattices snake-mapped to the chain) goes into the
        MPO of :meth:`build_H_mpo`; :meth:`all_bond_ops` then raises.
        """
        if coupling.num_sites != 2:
            raise ValueError('add_coupling needs a two-site coupling')
        j = i + 1 if j is None else j
        if not 0 <= i < j < self.L:
            raise ValueError(f'need 0 <= i < j < L, got ({i}, {j})')
        if j == i + 1:
            self.bond_terms.append((i, coupling))
        else:
            self.pair_terms.append((i, j, coupling))
        return self

    def build_H_mpo(self, backend=None, svd_cut: float = 1e-12):
        """The full Hamiltonian as an MPO (FSM construction, any-range terms).

        See :func:`cyten_tpu_torch.algorithms.models.mpo_from_terms`.
        """
        from ..algorithms.models import mpo_from_terms

        backend = backend if backend is not None else self.sites[0].backend
        onsite = [(i, c.to_tensor()) for i, c in self.onsite_terms]
        couplings = [(i, i + 1, c.to_tensor()) for i, c in self.bond_terms]
        couplings += [(i, j, c.to_tensor()) for i, j, c in self.pair_terms]
        return mpo_from_terms([s.leg for s in self.sites], onsite=onsite,
                              couplings=couplings, backend=backend,
                              svd_cut=svd_cut)

    def all_bond_ops(self):
        """H_bonds: per-bond two-site operators (onsite terms split half-half)."""
        if self.pair_terms:
            raise ValueError('model has couplings beyond nearest neighbors; '
                             'H_bonds do not exist — use build_H_mpo()')
        bonds = {}
        for i, c in self.bond_terms:
            t = c.to_tensor()
            bonds[i] = t if i not in bonds else bonds[i] + t
        for i, c in self.onsite_terms:
            op = c.to_tensor().relabelled(['p', 'p*'])
            w = 0.5 if 0 < i < self.L - 1 else 1.
            contributions = []
            if i > 0:
                contributions.append((i - 1, 1))
            if i < self.L - 1:
                contributions.append((i, 0))
            for bond, pos in contributions:
                t = _embed_onsite(op, self.sites[bond], self.sites[bond + 1], pos, w)
                bonds[bond] = t if bond not in bonds else bonds[bond] + t
        return [bonds.get(i) for i in range(self.L - 1)]


def _embed_onsite(op, site0, site1, pos, weight):
    """weight * (op ⊗ 1) or (1 ⊗ op) as a two-site operator."""
    from ..tensors import SymmetricTensor, outer, permute_legs

    if pos == 0:
        eye1 = SymmetricTensor.from_eye([site1.leg], backend=site1.backend,
                                        labels=['p1'], dtype=op.dtype)
        t = outer(op.relabelled(['p0', 'p0*']), eye1)
    else:
        eye0 = SymmetricTensor.from_eye([site0.leg], backend=site0.backend,
                                        labels=['p0'], dtype=op.dtype)
        t = outer(eye0, op.relabelled(['p1', 'p1*']))
    t = permute_legs(t, codomain=['p0', 'p1'], domain=['p0*', 'p1*'])
    return weight * t


class TFIModel(CouplingModel):
    """Transverse-field Ising chain's sites, as a coupling model with no terms (as in
    ``cyten_tpu``; :class:`cyten_tpu_torch.algorithms.TFIModel` builds its bonds and
    MPO)."""

    def __init__(self, L: int, J: float = 1., g: float = 1., conserve: str = 'parity',
                 device: str = None):
        site_conserve = 'parity' if conserve == 'parity' else 'None'
        sites = [SpinHalfSite(conserve=site_conserve, device=device) for _ in range(L)]
        CouplingModel.__init__(self, sites)
        self.J = J
        self.g = g


class GoldenModel(CouplingModel):
    """Fibonacci golden chain via couplings."""

    def __init__(self, L: int, J: float = 1., backend=None, device: str = None):
        sites = [GoldenSite(backend=backend, device=device) for _ in range(L)]
        CouplingModel.__init__(self, sites)
        for i in range(L - 1):
            self.add_coupling(i, gold_coupling([sites[i], sites[i + 1]], J=J))


GoldenChain = GoldenModel
