"""Couplings: multi-site operators factorized MPO-style into per-site tensors.

The counterpart of ``cyten_tpu/models/couplings.py``: ``Coupling`` (:32),
``squeeze_w_legs`` (:135), the numpy helpers (:146-175) and the spin, boson, fermion
(``hopping``, ``pairing``, ``onsite_pairing``, :263-305), clock and anyon factories
(:177-391).

A :class:`Coupling` stores one tensor per site with legs ``[wL, p, wR, p*]``
(codomain ``[wL, p]``, domain ``[p, wR]`` — the planar MPO-entry layout), such that
contracting the horizontal ``w`` legs reproduces the multi-site operator. The
factorization is computed by successive planar SVDs — exact, and valid for every
symmetry backend including anyons. The tensors live where the sites' do.
"""

from __future__ import annotations

import numpy as np

from ..tensors import (
    SymmetricTensor, add_trivial_leg, compose, permute_legs, scale_axis, squeeze_legs,
    svd, svd_apply_mask, truncate_singular_values,
)
from .degrees_of_freedom import AnyonDOF, Site, SpinDOF

__all__ = ['Coupling', 'spin_spin_coupling', 'spin_field_coupling', 'heisenberg_coupling',
           'aklt_coupling', 'chiral_3spin_coupling', 'chemical_potential',
           'onsite_interaction', 'density_density_interaction', 'hopping', 'pairing',
           'onsite_pairing', 'clock_coupling',
           'clock_clock_coupling', 'clock_field', 'clock_field_coupling',
           'sector_projection_coupling', 'gold_coupling']


class Coupling:
    """A multi-site operator in factorized (MPO-entry) form."""

    def __init__(self, factorization: list[SymmetricTensor], sites: list[Site],
                 name: str = 'coupling'):
        self.factorization = list(factorization)
        self.sites = list(sites)
        self.num_sites = len(sites)
        self.name = name

    @classmethod
    def from_tensor(cls, op: SymmetricTensor, sites: list[Site],
                    name: str = 'coupling', svd_cut: float = 1e-12) -> Coupling:
        """Factorize a multi-site operator (codomain [p0..pn], domain [p0..pn]) by
        successive planar SVD splits."""
        n = len(sites)
        if n == 1:
            t = op.relabelled(['p', 'p*'])
            t = permute_legs(t, codomain=['p'], domain=['p*'])
            t = add_trivial_leg(t, 0, label='wL')
            t = add_trivial_leg(t, 2, label='wR', to_domain=True, is_dual=True)
            return cls([t], sites, name)
        op = op.relabelled([f'p{i}' for i in range(n)]
                           + [f'p{i}*' for i in reversed(range(n))])
        factors = []
        rest = op
        for i in range(n - 1):
            # split site i off the left: the left arc is circularly contiguous
            # (..., p_i*, [wL,] p_i, ...), so the regrouping is a planar rotation
            cod = [f'p{i}*', f'p{i}'] if i == 0 else [f'p{i}*', 'wL', f'p{i}']
            dom = [f'p{k}*' for k in range(i + 1, n)] \
                + [f'p{k}' for k in range(n - 1, i, -1)]
            X = permute_legs(rest, codomain=cod, domain=dom)
            U, S, Vh = svd(X, new_labels=['wR', 'wL'])
            mask, _, _ = truncate_singular_values(S, svd_min=svd_cut)
            U, S, Vh = svd_apply_mask(U, S, Vh, mask)
            sqrt_S = S ** 0.5
            A = scale_axis(U, sqrt_S, 'wR')
            rest = scale_axis(Vh, sqrt_S, 'wL')
            # shape A into the MPO-entry layout [wL, p, wR, p*] (planar moves)
            if i == 0:
                A = permute_legs(A, codomain=[f'p{i}'], domain=[f'p{i}*', 'wR'])
                A = add_trivial_leg(A, 0, label='wL')
            else:
                A = permute_legs(A, codomain=['wL', f'p{i}'],
                                 domain=[f'p{i}*', 'wR'])
            factors.append(A.relabelled({f'p{i}': 'p', f'p{i}*': 'p*'}))
        last = permute_legs(rest, codomain=['wL', f'p{n - 1}'],
                            domain=[f'p{n - 1}*'])
        last = add_trivial_leg(last, 2, label='wR', to_domain=True, is_dual=True)
        factors.append(last.relabelled({f'p{n - 1}': 'p', f'p{n - 1}*': 'p*'}))
        return cls(factors, sites, name)

    @classmethod
    def from_dense_block(cls, block, sites: list[Site], name: str = 'coupling',
                         backend=None, tol: float = 1e-8) -> Coupling:
        """From a dense multi-site operator block (legs [p0.., pN*..p0*])."""
        backend = backend if backend is not None else sites[0].backend
        legs = [s.leg for s in sites]
        op = SymmetricTensor.from_dense_block(block, legs, legs, backend=backend,
                                              tol=tol)
        return cls.from_tensor(op, sites, name)

    def to_tensor(self) -> SymmetricTensor:
        """Contract the horizontal legs back into the full multi-site operator.

        All rearrangements are planar rotations, so this works for anyons too.
        """
        n = self.num_sites
        res = self.factorization[0].relabelled({'p': 'p0', 'p*': 'p0*'})
        for i in range(1, n):
            f = self.factorization[i].relabelled({'p': f'p{i}', 'p*': f'p{i}*'})
            # rotate res so that wR sits alone in the domain
            labels = res.labels
            k = labels.index('wR')
            resp = permute_legs(res, codomain=labels[k + 1:] + labels[:k],
                                domain=['wR'])
            fp = permute_legs(f, codomain=['wL'],
                              domain=[f'p{i}*', 'wR', f'p{i}'])
            res = compose(resp, fp)
        res = squeeze_w_legs(res)
        return permute_legs(res, codomain=[f'p{i}' for i in range(n)],
                            domain=[f'p{i}*' for i in range(n)])

    def __mul__(self, factor):
        factors = list(self.factorization)
        factors[0] = factor * factors[0]
        return Coupling(factors, self.sites, self.name)

    __rmul__ = __mul__

    def __repr__(self):
        return f'<Coupling {self.name!r} on {self.num_sites} sites>'


def squeeze_w_legs(t):
    """Squeeze the trivial ``wL`` / ``wR`` legs of ``t``."""
    idcs = [n for n, l in enumerate(t._labels)
            if l in ('wL', 'wR') and t.get_leg(n).is_trivial]
    return squeeze_legs(t, idcs)


# --- factories (dense path for droppable symmetries) ------------------------------------


def _check_num_sites(sites, n: int, name: str):
    if len(sites) != n:
        raise ValueError(f'{name} acts on {n} site(s), got {len(sites)}')


def _two_site_block(h: np.ndarray, sites) -> np.ndarray:
    """A ``kron(op0, op1)``-convention matrix as a block in legs order
    ``[p0, p1, p1*, p0*]``."""
    d0, d1 = int(sites[0].leg.dim), int(sites[1].leg.dim)
    return h.reshape(d0, d1, d0, d1).transpose(0, 1, 3, 2)


def _two_site_from_numpy(op1: np.ndarray, op2: np.ndarray, sites, coeff=1.,
                         name='coupling') -> Coupling:
    return Coupling.from_dense_block(_two_site_block(coeff * np.kron(op1, op2), sites),
                                     sites, name=name)


def _two_site_sum_from_numpy(terms, sites, name='coupling') -> Coupling:
    d0, d1 = int(sites[0].leg.dim), int(sites[1].leg.dim)
    h = np.zeros((d0 * d1, d0 * d1), dtype=complex)
    for coeff, op1, op2 in terms:
        h = h + coeff * np.kron(op1, op2)
    if np.allclose(h.imag, 0):
        h = h.real
    return Coupling.from_dense_block(_two_site_block(h, sites), sites, name=name)


def _one_site_from_numpy(op: np.ndarray, sites, name) -> Coupling:
    site = sites[0]
    t = SymmetricTensor.from_dense_block(op, [site.leg], [site.leg],
                                         backend=site.backend, labels=['p', 'p*'])
    return Coupling.from_tensor(t, sites, name=name)


def _spin_ops_numpy(site):
    """(Sp, Sm, Sz) of a spin site — from its ops, or recomputed for SU(2) sites
    (where the components are not individually symmetric)."""
    if site.has_op('Sp'):
        return tuple(site.get_op_numpy(k) for k in ('Sp', 'Sm', 'Sz'))
    S = getattr(site, 'S', (int(site.leg.dim) - 1) / 2.)
    ops = SpinDOF.spin_ops(S)
    return ops['Sp'], ops['Sm'], ops['Sz']


def spin_spin_coupling(sites, Jx=0., Jy=0., Jz=0., name='spin_spin') -> Coupling:
    r""":math:`J_x S^x S^x + J_y S^y S^y + J_z S^z S^z`."""
    _check_num_sites(sites, 2, 'spin_spin_coupling')
    Sp0, Sm0, Sz0 = _spin_ops_numpy(sites[0])
    Sp1, Sm1, Sz1 = _spin_ops_numpy(sites[1])
    terms = [(Jz, Sz0, Sz1),
             ((Jx + Jy) / 4., Sp0, Sm1), ((Jx + Jy) / 4., Sm0, Sp1),
             ((Jx - Jy) / 4., Sp0, Sp1), ((Jx - Jy) / 4., Sm0, Sm1)]
    terms = [t for t in terms if abs(t[0]) > 0]
    return _two_site_sum_from_numpy(terms, sites, name=name)


def heisenberg_coupling(sites, J=1., name='heisenberg') -> Coupling:
    r""":math:`J \vec{S} \cdot \vec{S}`. Works for any conserve choice incl. SU(2),
    where the dense block is projected exactly."""
    return spin_spin_coupling(sites, Jx=J, Jy=J, Jz=J, name=name)


def aklt_coupling(sites, J=1., name='aklt') -> Coupling:
    r""":math:`J [\vec{S}\vec{S} + \frac{1}{3}(\vec{S}\vec{S})^2]`."""
    _check_num_sites(sites, 2, 'aklt_coupling')
    Sp0, Sm0, Sz0 = _spin_ops_numpy(sites[0])
    Sp1, Sm1, Sz1 = _spin_ops_numpy(sites[1])
    SS = (np.kron(Sz0, Sz1) + 0.5 * (np.kron(Sp0, Sm1) + np.kron(Sm0, Sp1)))
    h = J * (SS + np.matmul(SS, SS) / 3.)
    return Coupling.from_dense_block(_two_site_block(h, sites), sites, name=name)


def chiral_3spin_coupling(sites, J=1., name='chiral_3spin') -> Coupling:
    r""":math:`J \vec{S}_1 \cdot (\vec{S}_2 \times \vec{S}_3)`."""
    _check_num_sites(sites, 3, 'chiral_3spin_coupling')
    mats = []
    for s in sites:
        Sp, Sm, Sz = (s.get_op_numpy(k) for k in ('Sp', 'Sm', 'Sz'))
        mats.append((0.5 * (Sp + Sm), -0.5j * (Sp - Sm), Sz))
    h = 0.
    eps = {(0, 1, 2): 1, (1, 2, 0): 1, (2, 0, 1): 1,
           (2, 1, 0): -1, (0, 2, 1): -1, (1, 0, 2): -1}
    for (a, b, c), sign in eps.items():
        h = h + sign * np.kron(np.kron(mats[0][a], mats[1][b]), mats[2][c])
    h = np.asarray(J * h)
    if np.allclose(h.imag, 0):
        h = h.real
    dims = [int(s.leg.dim) for s in sites]
    block = np.reshape(h, dims + dims).transpose(0, 1, 2, 5, 4, 3)
    return Coupling.from_dense_block(block, sites, name=name)


def chemical_potential(sites, mu=1., name='chemical_potential') -> Coupling:
    r""":math:`-\mu N` on a single site."""
    _check_num_sites(sites, 1, 'chemical_potential')
    return _one_site_from_numpy(-mu * sites[0].get_op_numpy('N'), sites, name)


def onsite_interaction(sites, U=1., name='onsite_interaction') -> Coupling:
    r""":math:`\frac{U}{2} N (N - 1)`, or :math:`U N_u N_d` on a site with ``NuNd``."""
    _check_num_sites(sites, 1, 'onsite_interaction')
    s = sites[0]
    if s.has_op('NuNd'):
        return _one_site_from_numpy(U * s.get_op_numpy('NuNd'), sites, name)
    N = s.get_op_numpy('N')
    return _one_site_from_numpy(0.5 * U * (N @ N - N), sites, name)


def density_density_interaction(sites, V=1., name='density_density') -> Coupling:
    r""":math:`V N_i N_j`."""
    _check_num_sites(sites, 2, 'density_density_interaction')
    N0, N1 = (s.get_op_numpy('Ntot' if s.has_op('Ntot') else 'N') for s in sites)
    return _two_site_from_numpy(N0, N1, sites, coeff=V, name=name)


def hopping(sites, t=1., species: str = '', name='hopping') -> Coupling:
    r""":math:`-t (c^\dagger_i c_j + c^\dagger_j c_i)` of one species (``'u'``,
    ``'dn'`` on a spin-1/2 fermion site).

    The braids of a graded symmetry carry the signs between the sites; the dense
    block takes the Jordan-Wigner string to the right of the first site's operator.
    """
    _check_num_sites(sites, 2, 'hopping')
    Cd0, C0, JW0 = (sites[0].get_op_numpy(k) for k in ('Cd' + species, 'C' + species,
                                                         'JW'))
    Cd1, C1 = (sites[1].get_op_numpy(k) for k in ('Cd' + species, 'C' + species))
    return _two_site_sum_from_numpy([(-t, Cd0 @ JW0, C1), (t, C0 @ JW0, Cd1)], sites,
                                    name=name)


def pairing(sites, D=1., species: str = '', name='pairing') -> Coupling:
    r""":math:`\Delta (c^\dagger_i c^\dagger_j + c_j c_i)`.

    :math:`c^\dagger_i c^\dagger_j` is ``(Cd JW) x Cd`` and :math:`c_j c_i` is
    ``(JW C) x C``: the string stands to the left of a lowering operator
    (``JW C = -C JW``; ``C JW`` would flip that term's sign and the operator would not
    be hermitian).
    """
    _check_num_sites(sites, 2, 'pairing')
    Cd0, C0, JW0 = (sites[0].get_op_numpy(k) for k in ('Cd' + species, 'C' + species,
                                                         'JW'))
    Cd1, C1 = (sites[1].get_op_numpy(k) for k in ('Cd' + species, 'C' + species))
    return _two_site_sum_from_numpy([(D, Cd0 @ JW0, Cd1), (D, JW0 @ C0, C1)], sites,
                                    name=name)


def onsite_pairing(sites, D=1., name='onsite_pairing') -> Coupling:
    r""":math:`\Delta (c^\dagger_u c^\dagger_d + c_d c_u)` on one spin-1/2 fermion
    site."""
    _check_num_sites(sites, 1, 'onsite_pairing')
    Cdu, Cddn, Cu, Cdn = (sites[0].get_op_numpy(k) for k in ('Cdu', 'Cddn', 'Cu', 'Cdn'))
    return _one_site_from_numpy(D * (Cdu @ Cddn + Cdn @ Cu), sites, name)


def spin_field_coupling(sites, hx=0., hy=0., hz=0., name='spin-field') -> Coupling:
    r""":math:`h_x S^x + h_y S^y + h_z S^z` on one site."""
    _check_num_sites(sites, 1, 'spin_field_coupling')
    Sp, Sm, Sz = _spin_ops_numpy(sites[0])
    h = hx * (Sp + Sm) / 2. + hy * (Sp - Sm) / 2.j + hz * Sz
    if np.allclose(h.imag, 0):
        h = h.real
    return _one_site_from_numpy(h, sites, name)


def clock_clock_coupling(sites, Jx=0., Jz=0., name='clock-clock') -> Coupling:
    r""":math:`J_x X_i X_j^\dagger + J_z Z_i Z_j^\dagger + h.c.` (no sign; cf.
    :func:`clock_coupling`, which carries the ferromagnetic minus sign)."""
    _check_num_sites(sites, 2, 'clock_clock_coupling')
    X0, Z0 = sites[0].get_op_numpy('X'), sites[0].get_op_numpy('Z')
    X1, Z1 = sites[1].get_op_numpy('X'), sites[1].get_op_numpy('Z')
    terms = [(Jx, X0, X1.conj().T), (Jz, Z0, Z1.conj().T),
             (Jx, X0.conj().T, X1), (Jz, Z0.conj().T, Z1)]
    terms = [t for t in terms if abs(t[0]) > 0]
    return _two_site_sum_from_numpy(terms, sites, name=name)


def clock_field_coupling(sites, hx=0., hz=0., name='clock-field') -> Coupling:
    r""":math:`h_x (X + X^\dagger) + h_z (Z + Z^\dagger)` on one site."""
    _check_num_sites(sites, 1, 'clock_field_coupling')
    X, Z = sites[0].get_op_numpy('X'), sites[0].get_op_numpy('Z')
    h = hx * (X + X.conj().T) + hz * (Z + Z.conj().T)
    if np.allclose(h.imag, 0):
        h = h.real
    return _one_site_from_numpy(h, sites, name)


def clock_coupling(sites, J=1., name='clock_ZZ') -> Coupling:
    r""":math:`-J (Z_i Z_j^\dagger + h.c.)`."""
    _check_num_sites(sites, 2, 'clock_coupling')
    Z0 = sites[0].get_op_numpy('Z')
    Z1hc = sites[1].get_op_numpy('Zhc')
    terms = [(-J, Z0, Z1hc), (-J, Z0.conj().T, Z1hc.conj().T)]
    return _two_site_sum_from_numpy(terms, sites, name=name)


def clock_field(sites, g=1., name='clock_X') -> Coupling:
    r""":math:`-g (X + X^\dagger)` on one site."""
    _check_num_sites(sites, 1, 'clock_field')
    X = sites[0].get_op_numpy('X')
    return _one_site_from_numpy(-g * (X + X.conj().T), sites, name)


def sector_projection_coupling(sites, J=1., sector=None,
                               name='sector_projection') -> Coupling:
    """``J P_sector`` — two-site projector onto a fusion channel, built sector-wise;
    works for anyonic symmetries."""
    _check_num_sites(sites, 2, 'sector_projection_coupling')
    if sector is None:
        raise ValueError('sector_projection_coupling needs a sector')
    op = AnyonDOF.sector_projector((sites[0].leg, sites[1].leg), sector,
                                   sites[0].backend, coeff=J)
    return Coupling.from_tensor(op, sites, name=name)


def gold_coupling(sites, J=1., name='gold') -> Coupling:
    r""":math:`-J P^{\text{vac}}` of two Fibonacci anyons."""
    _check_num_sites(sites, 2, 'gold_coupling')
    return sector_projection_coupling(sites, J=-J, sector=sites[0].symmetry.trivial_sector,
                                      name=name)
