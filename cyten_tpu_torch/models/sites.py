"""Concrete sites, each parameterized by a ``conserve`` option.

The counterpart of ``cyten_tpu/models/sites.py``: ``SpinSite`` (:32), ``SpinHalfSite``
(:62), ``SpinlessBosonSite`` (:67), ``SpinlessFermionSite`` (:91),
``SpinHalfFermionSite`` (:121), ``ClockSite`` (:181) and the anyon sites (:199-232).

The ``conserve`` choice fixes the symmetry of the leg and thereby *which* operators
remain symmetric: diagonal operators survive any abelian conservation;
charge-shifting operators become :class:`ChargedTensor`\\ s; only the ``'None'``
choice keeps everything as plain symmetric tensors. Every site takes ``backend`` or
``device`` (default: the CUDA card).
"""

from __future__ import annotations

import numpy as np

from ..symmetries import (
    ElementarySpace, FermionNumber, FermionParity, SU2_kAnyonCategory, Symmetry, U1, ZN,
    fibonacci_anyon_category, ising_anyon_category, no_symmetry, su2_symmetry,
    u1_symmetry,
)
from .degrees_of_freedom import BosonicDOF, ClockDOF, FermionicDOF, Site, SpinDOF

__all__ = ['SpinSite', 'SpinHalfSite', 'SpinlessBosonSite', 'SpinlessFermionSite',
           'SpinHalfFermionSite', 'ClockSite', 'AnyonSite', 'FibonacciAnyonSite',
           'IsingAnyonSite', 'GoldenSite', 'SU2kSpin1Site']


def _check_conserve(cls_name: str, conserve, allowed) -> str:
    if conserve not in allowed:
        raise ValueError(f'{cls_name}: unknown conserve={conserve!r}')
    return conserve or 'None'


class SpinSite(Site):
    """Spin-S site. ``conserve`` in {'SU(2)', 'Sz', 'parity', 'None'}."""

    def __init__(self, S: float = 0.5, conserve: str = 'Sz', backend=None,
                 device: str = None):
        conserve = _check_conserve('SpinSite', conserve,
                                   ('SU(2)', 'SU2', 'Sz', 'parity', 'None', None))
        self.S = S
        self.conserve = conserve
        d = int(round(2 * S + 1))
        ops = SpinDOF.spin_ops(S)
        if conserve in ('SU(2)', 'SU2'):
            leg = ElementarySpace(su2_symmetry, [[d - 1]])
            site_ops = {}  # only SU(2)-scalars; Sz etc. are not
        elif conserve == 'Sz':
            leg = ElementarySpace.from_basis(
                u1_symmetry, [[int(round(2 * m))] for m in (S - np.arange(d))])
            site_ops = {k: ops[k] for k in ('Sz', 'Sz2', 'Sp', 'Sm')}
        elif conserve == 'parity':
            leg = ElementarySpace.from_basis(
                ZN(2, 'parity').as_Symmetry(), [[i % 2] for i in range(d)])
            site_ops = {k: ops[k] for k in ('Sz', 'Sz2', 'Sp', 'Sm', 'Sx')}
        else:
            leg = ElementarySpace.from_trivial_sector(d, symmetry=no_symmetry)
            site_ops = {k: ops[k] for k in ('Sz', 'Sz2', 'Sp', 'Sm', 'Sx', 'Sy')}
        labels = {'up': 0, 'down': 1} if d == 2 else {}
        Site.__init__(self, leg, backend=backend, state_labels=labels, device=device,
                      **site_ops)


class SpinHalfSite(SpinSite):
    def __init__(self, conserve: str = 'Sz', backend=None, device: str = None):
        SpinSite.__init__(self, S=0.5, conserve=conserve, backend=backend, device=device)


class SpinlessBosonSite(Site):
    """Boson site with occupation cutoff. ``conserve`` in {'N', 'parity', 'None'}."""

    def __init__(self, n_max: int = 2, conserve: str = 'N', backend=None,
                 device: str = None):
        conserve = _check_conserve('SpinlessBosonSite', conserve,
                                   ('N', 'parity', 'None', None))
        self.n_max = n_max
        self.conserve = conserve
        d = n_max + 1
        ops = BosonicDOF.occupation_ops(n_max)
        if conserve == 'N':
            leg = ElementarySpace.from_basis(
                U1('N').as_Symmetry(), [[n] for n in range(d)])
        elif conserve == 'parity':
            leg = ElementarySpace.from_basis(
                ZN(2, 'parity_N').as_Symmetry(), [[n % 2] for n in range(d)])
        else:
            leg = ElementarySpace.from_trivial_sector(d, symmetry=no_symmetry)
        Site.__init__(self, leg, backend=backend, state_labels={'vac': 0},
                      device=device, N=ops['N'], NN=ops['NN'], dN=ops['dN'],
                      B=ops['B'], Bd=ops['Bd'])


class SpinlessFermionSite(Site):
    """Spinless fermion site. ``conserve`` in {'N', 'parity', 'None'}.

    'N' takes the graded :class:`FermionNumber`, 'parity' :class:`FermionParity`: the
    braids of the symmetry then carry the signs between sites, and couplings need no
    Jordan-Wigner string between them. 'None' keeps no grading.
    """

    def __init__(self, conserve: str = 'N', backend=None, device: str = None):
        conserve = _check_conserve('SpinlessFermionSite', conserve,
                                   ('N', 'parity', 'None', None))
        self.conserve = conserve
        ops = FermionicDOF.fermion_ops()
        if conserve == 'N':
            leg = ElementarySpace.from_basis(FermionNumber().as_Symmetry(), [[0], [1]])
        elif conserve == 'parity':
            leg = ElementarySpace.from_basis(FermionParity().as_Symmetry(), [[0], [1]])
        else:
            leg = ElementarySpace.from_trivial_sector(2, symmetry=no_symmetry)
        Site.__init__(self, leg, backend=backend,
                      state_labels={'empty': 0, 'full': 1}, device=device,
                      N=ops['N'], JW=ops['JW'], C=ops['C'], Cd=ops['Cd'])

    def get_annihilator_numpy(self, include_JW: bool = True) -> np.ndarray:
        return FermionicDOF.get_annihilator_numpy({}, 0, 1, include_JW=include_JW)


#: the kron basis (up x down) (0,0), (0,1), (1,0), (1,1) in the site's order |0>,
#: |up>, |down>, |updown>
_SPIN_HALF_FERMION_BASIS = np.eye(4)[[0, 2, 1, 3]]


class SpinHalfFermionSite(Site):
    """Spin-1/2 fermion site, basis |0>, |up>, |down>, |updown>.

    ``conserve_N`` in {'N', 'parity', 'None'} and ``conserve_S`` in {'Sz', 'None'};
    the symmetry is ``FermionNumber('N')`` or ``FermionParity('parity')`` times
    ``U1('2*Sz')``, the factors that are conserved. Species 0 is up, 1 down; the
    down annihilator carries the Jordan-Wigner string of the up species.
    """

    def __init__(self, conserve_N: str = 'N', conserve_S: str = 'Sz', backend=None,
                 device: str = None):
        conserve_N = _check_conserve('SpinHalfFermionSite', conserve_N,
                                     ('N', 'parity', 'None', None))
        conserve_S = _check_conserve('SpinHalfFermionSite', conserve_S,
                                     ('Sz', 'None', None))
        self.conserve_N = conserve_N
        self.conserve_S = conserve_S
        P = _SPIN_HALF_FERMION_BASIS
        Cu = P @ FermionicDOF.get_annihilator_numpy({}, 0, 2, include_JW=False) @ P.T
        Cdn = P @ FermionicDOF.get_annihilator_numpy({}, 1, 2, include_JW=True) @ P.T
        Nu = Cu.T @ Cu
        Nd = Cdn.T @ Cdn
        Sp = Cu.T @ Cdn  # S+ = c†_up c_down
        factors = []
        sectors = []
        if conserve_N == 'N':
            factors.append(FermionNumber('N'))
            sectors.append([0, 1, 1, 2])
        elif conserve_N == 'parity':
            factors.append(FermionParity('parity'))
            sectors.append([0, 1, 1, 0])
        if conserve_S == 'Sz':
            factors.append(U1('2*Sz'))
            sectors.append([0, 1, -1, 0])
        if factors:
            leg = ElementarySpace.from_basis(Symmetry(factors), np.array(sectors).T)
        else:
            leg = ElementarySpace.from_trivial_sector(4, symmetry=no_symmetry)
        Site.__init__(self, leg, backend=backend,
                      state_labels={'empty': 0, 'up': 1, 'down': 2, 'full': 3},
                      device=device, Nu=Nu, Nd=Nd, Ntot=Nu + Nd, NuNd=Nu @ Nd,
                      Sz=0.5 * (Nu - Nd), JW=np.diag([1., -1., -1., 1.]), Cu=Cu,
                      Cdu=Cu.T.copy(), Cdn=Cdn, Cddn=Cdn.T.copy(), Sp=Sp,
                      Sm=Sp.T.copy())

    def get_annihilator_numpy(self, species: int, include_JW: bool = True
                              ) -> np.ndarray:
        P = _SPIN_HALF_FERMION_BASIS
        return P @ FermionicDOF.get_annihilator_numpy(
            {}, species, 2, include_JW=include_JW) @ P.T


class ClockSite(Site):
    """q-state clock site. ``conserve`` in {'Z', 'None'}."""

    def __init__(self, q: int = 3, conserve: str = 'Z', backend=None,
                 device: str = None):
        conserve = _check_conserve('ClockSite', conserve, ('Z', 'None', None))
        self.q = q
        self.conserve = conserve
        ops = ClockDOF.clock_ops(q)
        if conserve == 'Z':
            leg = ElementarySpace.from_basis(
                ZN(q, 'clock').as_Symmetry(), [[k] for k in range(q)])
        else:
            leg = ElementarySpace.from_trivial_sector(q, symmetry=no_symmetry)
        Site.__init__(self, leg, backend=backend, device=device, Z=ops['Z'],
                      Zhc=ops['Zhc'], X=ops['X'], Xhc=ops['Xhc'])


class AnyonSite(Site):
    """A site carrying a single anyon of the given fusion category."""

    def __init__(self, symmetry, sector, backend=None, device: str = None):
        symmetry = symmetry.as_Symmetry()
        leg = ElementarySpace(symmetry, np.asarray(sector, int)[None, :])
        self.sector = np.asarray(sector, int)
        Site.__init__(self, leg, backend=backend, device=device)


class FibonacciAnyonSite(AnyonSite):
    """One Fibonacci tau anyon."""

    def __init__(self, backend=None, device: str = None):
        AnyonSite.__init__(self, fibonacci_anyon_category, [1], backend=backend,
                           device=device)


class GoldenSite(FibonacciAnyonSite):
    """The site of the golden-chain model."""


class IsingAnyonSite(AnyonSite):
    """One Ising sigma anyon."""

    def __init__(self, backend=None, device: str = None):
        AnyonSite.__init__(self, ising_anyon_category, [1], backend=backend,
                           device=device)


class SU2kSpin1Site(AnyonSite):
    """The 'spin-1' object of the SU(2)_k anyon category."""

    def __init__(self, k: int = 2, backend=None, device: str = None):
        AnyonSite.__init__(self, SU2_kAnyonCategory(k).as_Symmetry(), [2],
                           backend=backend, device=device)
