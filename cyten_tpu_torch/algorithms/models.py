"""Spin chains (Heisenberg, transverse-field Ising, spin-S XXZ), fermion chains
(Fermi-Hubbard, Kitaev), the golden chain and their MPOs, with exact references.

The counterpart of ``cyten_tpu/algorithms/models.py``'s ``spin_half_site`` (:35),
``mpo_from_bond_op`` (:99), ``mpo_from_bond_ops`` (:122), ``mpo_from_terms`` (:192)
with ``MpoTensors`` (:361), ``TFIModel`` (:372), ``HeisenbergModel`` (:471),
``GoldenChainModel`` (:570), ``FermiHubbardModel`` (:690), ``SpinChainModel`` (:752),
``KitaevChainModel`` (:868) and ``tfi_exact_infinite_gs_energy`` (:654). H_bonds (two-site gates) and H_mpo (MPO
tensors) are SymmetricTensors for a chosen conserved symmetry; ``bc='infinite'`` gives
the bonds and bulk tensors of a unit cell of L sites (no infinite MPS or iDMRG is
ported: ``DMRGEngine`` refuses such a model). The exact ground-state energies come
from sparse exact diagonalization, the infinite chains' from their closed forms, the
golden chain's from MPSKit.jl.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Dtype
from ..symmetries import ElementarySpace, su2_symmetry, u1_symmetry, z2_symmetry, \
    no_symmetry
from ..tensors import (
    SymmetricTensor, add_trivial_leg, permute_legs, scale_axis, svd,
    truncate_singular_values, svd_apply_mask,
)

__all__ = ['FermiHubbardModel', 'GoldenChainModel', 'HeisenbergModel', 'KitaevChainModel',
           'SpinChainModel', 'TFIModel',
           'spin_half_site', 'mpo_from_bond_op', 'mpo_from_bond_ops', 'mpo_from_terms',
           'MpoTensors', 'bond_sum_ground_energy', 'heisenberg_exact_finite_gs_energy',
           'tfi_exact_finite_gs_energy', 'tfi_exact_infinite_gs_energy']

# Pauli x and z in the (|up>, |down>) basis
_sx = np.array([[0., 1.], [1., 0.]])
_sz = np.array([[1., 0.], [0., -1.]])
_id = np.eye(2)


def spin_half_site(conserve: str = 'None', backend=None):
    """The spin-1/2 site leg for a given conservation choice.

    conserve in {'SU(2)', 'Sz', 'parity', 'None'}: one spin-1/2 multiplet of SU(2)
    (the fusion-tree backend), U(1) by 2*Sz, Z2 by spin-flip parity of the ordered
    basis, or no symmetry. Public basis order is (|up>, |down>) in all cases.
    """
    if conserve in ('SU2', 'SU(2)'):
        leg = ElementarySpace(su2_symmetry, [[1]])  # one spin-1/2 multiplet
    elif conserve == 'Sz':
        leg = ElementarySpace.from_basis(u1_symmetry, [[1], [-1]])
    elif conserve == 'parity':
        leg = ElementarySpace.from_basis(z2_symmetry, [[0], [1]])
    else:
        leg = ElementarySpace.from_trivial_sector(2, symmetry=no_symmetry)
    return leg


def _factorize_pair(h_pair: SymmetricTensor, svd_cut: float = 1e-12):
    """``h = sum_k A_k ⊗ B_k`` by SVD across the pair, in MPO-entry form.

    Works for heterogeneous site legs. Returns ``(A, B, k_leg)``: ``A`` with
    legs ``[wL(trivial), p, wR=k, p*]``, ``B`` with ``[wL=k, p, wR(trivial),
    p*]``, and ``k_leg`` the factorization bond space carried between them
    (``B``'s wL codomain factor). The reference's ``horizontal_factorization``
    idea (cyten/tensors/planar.py:1102); all moves planar.
    """
    h = h_pair.relabelled(['p0', 'p1', 'p1*', 'p0*'])
    # planar horizontal cut: left arc (p0*, p0) vs right arc (p1*, p1)
    X = permute_legs(h, codomain=['p0*', 'p0'], domain=['p1*', 'p1'])
    U, S, Vh = svd(X, new_labels=['wR', 'wL'])
    mask, err, _ = truncate_singular_values(S, svd_min=svd_cut)
    U, S, Vh = svd_apply_mask(U, S, Vh, mask)
    sqrt_S = S.sqrt() if not S.dtype.is_complex else S ** 0.5
    A_k = scale_axis(U, sqrt_S, 'wR')   # legs [p0*, p0, wR]
    B_k = scale_axis(Vh, sqrt_S, 'wL')  # legs [wL, p1, p1*]
    A_k = permute_legs(A_k, codomain=['p0'], domain=['p0*', 'wR'])
    A_k = add_trivial_leg(A_k, 0, label='wL')
    A_k = A_k.relabelled({'p0': 'p', 'p0*': 'p*'})
    B_k = permute_legs(B_k, codomain=['wL', 'p1'], domain=['p1*'])
    B_k = add_trivial_leg(B_k, 2, label='wR', to_domain=True, is_dual=True)
    B_k = B_k.relabelled({'p1': 'p', 'p1*': 'p*'})
    return A_k, B_k, B_k.codomain.factors[0]


def _eye_mpo_cell(p, backend, dtype):
    """Identity MPO cell ``[wL(trivial), p, wR(trivial), p*]``."""
    eye_p = SymmetricTensor.from_eye([p], backend=backend, labels=['p'],
                                     dtype=dtype)
    Id = add_trivial_leg(eye_p, 0, label='wL')
    return add_trivial_leg(Id, 2, label='wR', to_domain=True, is_dual=True)


def _factorize_bond(h_bond: SymmetricTensor, svd_cut: float = 1e-12):
    """``h = sum_k A_k ⊗ B_k`` by SVD across the bond, in MPO-entry form.

    Returns ``(A, B, Id)`` with legs ``[wL, p, wR, p*]`` each (trivial wL on A,
    trivial wR on B).
    """
    A_k, B_k, _ = _factorize_pair(h_bond, svd_cut)
    p = h_bond.codomain.factors[0]
    Id = _eye_mpo_cell(p, h_bond.backend, h_bond.dtype)
    return A_k, B_k, Id


def mpo_from_bond_op(h_bond: SymmetricTensor, L: int, svd_cut: float = 1e-12,
                     bc: str = 'finite'):
    """Uniform nearest-neighbor MPO from a two-site bond operator.

    Assembles the standard 3-block MPO ``W = [[1, A, 0], [0, 0, B], [0, 0, 1]]``
    with :func:`tensor_from_grid`.
    """
    from ..tensors import tensor_from_grid

    A_k, B_k, Id = _factorize_bond(h_bond, svd_cut)
    grid = [[Id, A_k, None],
            [None, None, B_k],
            [None, None, Id]]
    W = tensor_from_grid(grid, labels=['wL', 'p', 'wR', 'p*'], row_leg='wL',
                         col_leg='wR')
    if bc == 'infinite':
        return [W] * L
    first = _boundary_selector(W, left=True)
    last = _boundary_selector(W, left=False)
    mpos = [first if i == 0 else (last if i == L - 1 else W) for i in range(L)]
    return mpos


def mpo_from_bond_ops(h_bonds: list, svd_cut: float = 1e-12):
    """Finite-chain MPO from per-bond two-site operators (non-uniform chains).

    Site ``i``'s tensor combines ``A`` of bond ``i`` with ``B`` of bond ``i-1``;
    boundary sites contract the standard left/right unit selectors. All sites share
    one local leg.
    """
    from ..tensors import tensor_from_grid

    L = len(h_bonds) + 1
    if L < 2:
        raise ValueError('mpo_from_bond_ops needs at least one bond')
    parts = [_factorize_bond(h, svd_cut) for h in h_bonds]
    mpos = []
    for i in range(L):
        A_i = parts[i][0] if i < L - 1 else parts[-1][0]      # dummy at last site
        B_prev = parts[i - 1][1] if i > 0 else parts[0][1]    # dummy at first site
        Id = parts[min(i, L - 2)][2]
        grid = [[Id, A_i, None],
                [None, None, B_prev],
                [None, None, Id]]
        W = tensor_from_grid(grid, labels=['wL', 'p', 'wR', 'p*'], row_leg='wL',
                             col_leg='wR')
        if i == 0:
            W = _boundary_selector(W, left=True)
        if i == L - 1:
            W = _boundary_selector(W, left=False)
        mpos.append(W)
    return mpos


def _boundary_selector(W: SymmetricTensor, left: bool) -> SymmetricTensor:
    """Contract the left (row 0) or right (last column) boundary unit vector.

    Selects the first / last multiplicity of the trivial sector of the stacked leg
    (works for every backend, incl. anyons).
    """
    from ..dtypes import Dtype
    from ..tensors import DiagonalTensor, Mask, apply_mask

    label = 'wL' if left else 'wR'
    leg = W.get_leg_co_domain(label)
    sym = leg.symmetry
    bb = W.backend.block_backend

    def func(shape, sector):
        keep = np.zeros(shape[0], dtype=bool)
        if np.all(np.asarray(sector) == sym.trivial_sector):
            keep[0 if left else -1] = True
        return bb.as_block(keep, Dtype.bool)

    diag = DiagonalTensor.from_sector_block_func(func, leg, backend=W.backend)
    mask = Mask.from_DiagonalTensor(diag)
    return apply_mask(W, mask, label)


def _passthrough_cell(k_leg, p, backend, dtype):
    """Identity passthrough ``[wL=k, p, wR=k, p*]`` carrying a term's factorization
    bond leg across a gap site."""
    P = SymmetricTensor.from_eye([k_leg, p], backend=backend, labels=['wL', 'p'],
                                 dtype=dtype)
    # legs [wL, p, p*, wL*] -> [wL, p, wR, p*]
    P = P.relabelled({'wL*': 'wR'})
    return permute_legs(P, codomain=['wL', 'p'], domain=['p*', 'wR'])


def mpo_from_terms(site_legs, onsite=(), couplings=(), backend=None,
                   svd_cut: float = 1e-12, bc: str = 'finite',
                   select_boundary: bool = True, device: str = None):
    """MPO from arbitrary-range one- and two-site terms (finite or infinite).

    A finite-state-machine ('MPO graph') construction generalizing
    :func:`mpo_from_bond_ops` to couplings between ANY pair of sites ``i < j``
    — next-nearest-neighbor (J1-J2), 2D cylinders via snake mapping. Each coupling
    is SVD-factorized across its pair (:func:`_factorize_pair`) and the
    factorization's bond leg is carried through the gap sites by identity
    passthroughs; terms sharing a pair ``(i, j)`` are summed before factorizing.

    Parameters
    ----------
    site_legs : list[ElementarySpace]
        The physical leg of each site.
    onsite : iterable of ``(i, op)`` or ``(i, op, strength)``
        ``op``: dense ``(d, d)`` array or a SymmetricTensor ``[p | p*]``.
    couplings : iterable of ``(i, j, h)`` or ``(i, j, h, strength)``
        ``0 <= i < j`` at any distance; ``h`` acts on ``(site_i, site_j)``
        *as if adjacent*: dense ``(d_i*d_j, d_i*d_j)`` in ``kron(op_i, op_j)``
        convention, or a SymmetricTensor with legs ``[p0, p1 | p1*, p0*]``.
        Finite bc requires ``j < L``; infinite bc requires ``i < L`` and lets
        ``j >= L`` wrap into the next unit cell(s) — every term is implicitly
        summed over all translates by ``L``.
    backend
        The tensor backend; by default the first SymmetricTensor term's, else the
        symmetry's on ``device`` (default: the CUDA card).
    bc : ``'finite' | 'infinite'``
        Infinite bc emits one tensor per unit-cell site with matching wrap
        legs (``W[0].wL == W[L-1].wR``), ready channel at dense index 0 and
        done channel last.
    select_boundary : bool
        Finite bc only: if False, skip contracting the boundary unit vectors
        and return the FULL grid tensors at the chain ends too (ready channel
        at public index 0, done channel last on every virtual leg).

    Returns
    -------
    MpoTensors
        MPO tensors ``[wL, p, wR, p*]``; for finite bc boundary-selected at the ends
        (directly usable as ``model.H_mpo`` by the engine), with ``max_range``.
    """
    from ..backends import get_backend
    from ..tensors import scalar_multiply, tensor_from_grid

    L = len(site_legs)
    if bc not in ('finite', 'infinite'):
        raise ValueError(f'invalid bc: {bc!r}')
    infinite = bc == 'infinite'
    onsite, couplings = list(onsite), list(couplings)
    if backend is None:
        given = [t[1] for t in onsite if isinstance(t[1], SymmetricTensor)] \
            + [t[2] for t in couplings if isinstance(t[2], SymmetricTensor)]
        backend = given[0].backend if given else \
            get_backend(site_legs[0].symmetry, device=device)

    def as_onsite(i, op, strength):
        p = site_legs[i]
        if not isinstance(op, SymmetricTensor):
            op = SymmetricTensor.from_dense_block(
                np.asarray(op), [p], [p], backend=backend, labels=['p', 'p*'])
        else:
            op = op.relabelled(['p', 'p*'])
        op = add_trivial_leg(op, 0, label='wL')
        op = add_trivial_leg(op, 2, label='wR', to_domain=True, is_dual=True)
        return scalar_multiply(strength, op)

    def as_pair(i, j, h, strength):
        pi, pj = site_legs[i], site_legs[j]
        if not isinstance(h, SymmetricTensor):
            h = np.asarray(h)
            block = h.reshape(pi.dim, pj.dim, pi.dim, pj.dim).transpose(0, 1, 3, 2)
            h = SymmetricTensor.from_dense_block(
                block, [pi, pj], [pi, pj], backend=backend,
                labels=['p0', 'p1', 'p1*', 'p0*'])
        return scalar_multiply(strength, h)

    onsite_map = {}
    for i, op, *rest in onsite:
        t = as_onsite(i, op, rest[0] if rest else 1.)
        onsite_map[i] = t if i not in onsite_map else onsite_map[i] + t
    pair_map = {}
    for i, j, h, *rest in couplings:
        if not (0 <= i < j and i < L and (infinite or j < L)):
            raise ValueError(f'need 0 <= i < j (< L for finite bc), got ({i}, {j})')
        t = as_pair(i, j % L if infinite else j, h, rest[0] if rest else 1.)
        pair_map[i, j] = t if (i, j) not in pair_map else pair_map[i, j] + t

    terms = []  # (i, j, A, B, k_leg) in canonical order
    for (i, j) in sorted(pair_map):
        A, B, k_leg = _factorize_pair(pair_map[i, j], svd_cut)
        terms.append((i, j, A, B, k_leg))

    cell_dtypes = [t.dtype for t in onsite_map.values()] + [t[2].dtype for t in terms]
    dtype = Dtype.common(*cell_dtypes) if cell_dtypes else Dtype.float64

    def states_at_bond(b):
        """FSM states crossing bond b (the left bond of site b).

        Finite: term (i, j) crosses iff i < b <= j (one state per term).
        Infinite: states are (t, s) = 'term t started s sites ago', present
        iff (i_t + s) == b (mod L) for s in 1..j-i — every translate of every
        term is live somewhere in the cell.
        """
        if not infinite:
            return [(t, None) for t in range(len(terms))
                    if terms[t][0] < b <= terms[t][1]]
        return [(t, s) for t, (i, j, *_) in enumerate(terms)
                for s in range(1, j - i + 1) if (i + s) % L == b % L]

    mpos = []
    for m in range(L):
        p = site_legs[m]
        rows = ['R'] + states_at_bond(m) + ['D']
        cols = ['R'] + states_at_bond(m + 1) + ['D']
        eye = _eye_mpo_cell(p, backend, dtype)
        grid = [[None] * len(cols) for _ in rows]

        def put(r, c, t):
            grid[rows.index(r)][cols.index(c)] = t

        put('R', 'R', eye)
        put('D', 'D', eye)
        if m in onsite_map:
            put('R', 'D', onsite_map[m].to_dtype(dtype))
        for t, (i, j, A, B, k_leg) in enumerate(terms):
            span = j - i
            if infinite:
                if i == m:
                    put('R', (t, 1), A.to_dtype(dtype))
                for s in range(1, span):
                    if (i + s) % L == m:
                        put((t, s), (t, s + 1),
                            _passthrough_cell(k_leg, p, backend, dtype))
                if (i + span) % L == m:
                    put((t, span), 'D', B.to_dtype(dtype))
            else:
                if i == m:
                    put('R', (t, None), A.to_dtype(dtype))
                if i < m < j:
                    put((t, None), (t, None),
                        _passthrough_cell(k_leg, p, backend, dtype))
                if j == m:
                    put((t, None), 'D', B.to_dtype(dtype))
        W = tensor_from_grid(grid, labels=['wL', 'p', 'wR', 'p*'],
                             row_leg='wL', col_leg='wR')
        if not infinite and select_boundary and m == 0:
            W = _boundary_selector(W, left=True)
        if not infinite and select_boundary and m == L - 1:
            W = _boundary_selector(W, left=False)
        mpos.append(W)
    res = MpoTensors(mpos)
    res.max_range = max((j - i for (i, j, *_) in terms), default=1)
    return res


class MpoTensors(list):
    """A list of MPO tensors annotated with the maximal coupling range."""

    max_range = 1


class HeisenbergModel:
    r"""Spin-1/2 Heisenberg chain: :math:`H = J \sum \vec{S}_i \cdot \vec{S}_{i+1}`.

    ``conserve='Sz'`` uses the U(1) symmetry of total :math:`S^z`, ``'SU(2)'`` the full
    spin rotation symmetry on the fusion-tree backend (the MPO from the bond operator,
    :func:`mpo_from_bond_op`, as in ``cyten_tpu``). The tensors live on ``device``
    (default: the CUDA card) unless a ``backend`` is given.
    """

    def __init__(self, L: int, J: float = 1., conserve: str = 'Sz', backend=None,
                 block_backend=None, bc: str = 'finite', device: str = None):
        if conserve not in ('SU2', 'SU(2)', 'Sz', 'parity', 'None', None):
            raise NotImplementedError(f'conserve={conserve!r} is not ported yet')
        if bc not in ('finite', 'infinite'):
            raise ValueError(f'unknown bc {bc!r}')
        self.L = L
        self.J = J
        self.bc = bc
        self.conserve = conserve = conserve or 'None'
        self.site_leg = spin_half_site(conserve)
        from ..backends import get_backend

        self.backend = backend if backend is not None else \
            get_backend(self.site_leg.symmetry, block_backend, device=device)
        self.H_bonds = self._build_H_bonds()
        self.H_mpo = self._build_H_mpo()

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def _build_H_bonds(self):
        Sp = np.array([[0., 1.], [0., 0.]])
        Sm = Sp.T
        Sz = 0.5 * _sz
        h = self.J * (0.5 * (np.kron(Sp, Sm) + np.kron(Sm, Sp)) + np.kron(Sz, Sz))
        p = self.site_leg
        block = h.reshape(2, 2, 2, 2).transpose(0, 1, 3, 2)
        op = SymmetricTensor.from_dense_block(
            block, [p, p], [p, p], backend=self.backend,
            labels=['p0', 'p1', 'p1*', 'p0*'])
        return [op] * (self.L if self.bc == 'infinite' else self.L - 1)

    def _build_H_mpo(self):
        if self.conserve in ('SU2', 'SU(2)'):
            return mpo_from_bond_op(self.H_bonds[0], self.L, bc=self.bc)
        Sp = np.array([[0., 1.], [0., 0.]])
        Sm = Sp.T
        Sz = 0.5 * _sz
        J = self.J
        p = self.site_leg
        sym = p.symmetry
        W = np.zeros((5, 2, 2, 5))
        W[0, :, :, 0] = _id
        W[0, :, :, 1] = Sp
        W[0, :, :, 2] = Sm
        W[0, :, :, 3] = Sz
        W[1, :, :, 4] = J / 2. * Sm
        W[2, :, :, 4] = J / 2. * Sp
        W[3, :, :, 4] = J * Sz
        W[4, :, :, 4] = _id
        if self.conserve == 'Sz':
            # virtual charges (2*Sz units): charge rule fuse(wL, p_ket) ==
            # fuse(wR, p_ket-of-domain-index) gives +2 for the Sp column, -2 for Sm.
            w_sectors = np.array([[0], [2], [-2], [0], [0]])
        elif self.conserve == 'parity':
            w_sectors = np.array([[0], [1], [1], [0], [0]])
        else:
            w_sectors = np.zeros((5, sym.sector_ind_len), dtype=int)
        w_leg = ElementarySpace.from_basis(sym, w_sectors)
        triv = ElementarySpace(sym, sym.trivial_sector[None, :])
        first = np.zeros((1, 5))
        first[0, 0] = 1.
        last = np.zeros((5, 1))
        last[4, 0] = 1.
        mpos = []
        for i in range(self.L):
            Wi = W
            wl, wr = w_leg, w_leg
            if i == 0 and self.bc == 'finite':
                Wi = np.tensordot(first, Wi, (1, 0))
                wl = triv
            if i == self.L - 1 and self.bc == 'finite':
                Wi = np.tensordot(Wi, last, (3, 0))
                wr = triv
            mpos.append(SymmetricTensor.from_dense_block(
                np.transpose(Wi, (0, 1, 3, 2)), [wl, p], [p, wr],
                backend=self.backend, labels=['wL', 'p', 'wR', 'p*']))
        return mpos

    def exact_infinite_gs_energy(self) -> float:
        """Bethe ansatz: e = J (1/4 - ln 2) per site for the antiferromagnet."""
        return self.J * (0.25 - np.log(2.0))


class TFIModel:
    r"""Transverse field Ising chain: :math:`H = -J \sum σ^x_i σ^x_{i+1} - g \sum σ^z_i`.

    The Z2 symmetry (spin-flip in the x direction == parity of down spins in the z
    basis) can be conserved with ``conserve='parity'``. The tensors live on ``device``
    (default: the CUDA card) unless a ``backend`` is given. ``bc='infinite'`` gives L
    bonds and L bulk MPO tensors (a unit cell) and the energy per site.
    """

    def __init__(self, L: int, J: float = 1., g: float = 1.,
                 conserve: str = 'parity', backend=None, block_backend=None,
                 bc: str = 'finite', device: str = None):
        if conserve not in ('parity', 'None', None):
            raise ValueError(f'TFIModel: unknown conserve={conserve!r}')
        if bc not in ('finite', 'infinite'):
            raise ValueError(f'unknown bc {bc!r}')
        self.L = L
        self.J = J
        self.g = g
        self.bc = bc
        self.conserve = conserve = conserve or 'None'
        self.site_leg = spin_half_site(conserve)
        from ..backends import get_backend

        self.backend = backend if backend is not None else \
            get_backend(self.site_leg.symmetry, block_backend, device=device)
        self.H_bonds = self._build_H_bonds()
        self.H_mpo = self._build_H_mpo()

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def _build_H_bonds(self):
        """Two-site gates; in a finite chain the field of the end sites sits wholly on
        their one bond."""
        p = self.site_leg
        finite = self.bc == 'finite'
        res = []
        for i in range(self.L - 1 if finite else self.L):
            gL = self.g / 2. * (2. if i == 0 and finite else 1.)
            gR = self.g / 2. * (2. if i + 1 == self.L - 1 and finite else 1.)
            h = -self.J * np.kron(_sx, _sx) \
                - gL * np.kron(_sz, _id) - gR * np.kron(_id, _sz)
            block = h.reshape(2, 2, 2, 2).transpose(0, 1, 3, 2)  # legs [p0,p1,p1*,p0*]
            res.append(SymmetricTensor.from_dense_block(
                block, [p, p], [p, p], backend=self.backend,
                labels=['p0', 'p1', 'p1*', 'p0*']))
        return res

    def _build_H_mpo(self):
        p = self.site_leg
        sym = p.symmetry
        if self.conserve == 'parity':
            wL_sectors = np.array([[0], [1], [0]])
        else:
            wL_sectors = np.zeros((3, sym.sector_ind_len), dtype=int)
        w_leg = ElementarySpace.from_basis(sym, wL_sectors)
        # W[wL, p(ket), p(bra), wR]; MPO layout is [wL, p, wR, p*]
        W = np.zeros((3, 2, 2, 3))
        W[0, :, :, 0] = _id
        W[0, :, :, 1] = _sx
        W[0, :, :, 2] = -self.g * _sz
        W[1, :, :, 2] = -self.J * _sx
        W[2, :, :, 2] = _id
        first = np.zeros((1, 3))
        first[0, 0] = 1.
        last = np.zeros((3, 1))
        last[2, 0] = 1.
        triv = ElementarySpace(sym, sym.trivial_sector[None, :])
        mpos = []
        for i in range(self.L):
            Wi = W
            wl, wr = w_leg, w_leg
            if i == 0 and self.bc == 'finite':
                Wi = np.tensordot(first, Wi, (1, 0))
                wl = triv
            if i == self.L - 1 and self.bc == 'finite':
                Wi = np.tensordot(Wi, last, (3, 0))
                wr = triv
            # dense axes [wL, p, p', wR] -> legs order [wL, p, wR, p*]
            mpos.append(SymmetricTensor.from_dense_block(
                np.transpose(Wi, (0, 1, 3, 2)), [wl, p], [p, wr],
                backend=self.backend, labels=['wL', 'p', 'wR', 'p*']))
        return mpos

    def energy(self, psi) -> float:
        """Total energy (finite) or energy per site (infinite)."""
        e = float(np.real(sum(complex(psi.bond_expectation_value(h, i))
                              for i, h in enumerate(self.H_bonds))))
        return e / self.L if self.bc == 'infinite' else e

    def exact_finite_gs_energy(self) -> float:
        return tfi_exact_finite_gs_energy(self.L, self.J, self.g)

    def exact_infinite_gs_energy(self) -> float:
        return tfi_exact_infinite_gs_energy(self.J, self.g)


class GoldenChainModel:
    r"""Golden chain: :math:`H = -J \sum_i P^{\text{vac}}_{i,i+1}` of Fibonacci anyons.

    Each site carries a tau anyon; the Hamiltonian projects neighboring pairs onto
    their trivial fusion channel. Its MPO comes from the bond operator
    (:func:`mpo_from_bond_op`), whose SVD across the pair runs in complex128 (the
    Fibonacci F and R symbols are complex), so every MPO tensor is complex128, as
    in ``cyten_tpu``. The tensors live on ``device`` (default: the CUDA card) unless
    a ``backend`` is given. Benchmark energies from MPSKit.jl (``BASELINE.md``).
    """

    #: exact finite-chain ground energies (J=1) from MPSKit.jl (BASELINE.md)
    EXACT_ENERGIES = {6: -4.02595560765756, 8: -5.54888659415890,
                      10: -7.0735949995638}

    def __init__(self, L: int, J: float = 1., backend=None, block_backend=None,
                 device: str = None):
        from ..symmetries import fibonacci_anyon_category as fib
        from ..backends import get_backend

        self.L = L
        self.J = J
        self.site_leg = ElementarySpace(fib, [[1]])  # one tau anyon
        self.backend = backend if backend is not None else \
            get_backend(fib, block_backend, device=device)
        self.H_bonds = self._build_H_bonds()
        self.H_mpo = mpo_from_bond_op(self.H_bonds[0], L)

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def _build_H_bonds(self):
        p = self.site_leg
        sym = p.symmetry
        bb = self.backend.block_backend
        J = self.J

        def func(shape, coupled):
            if np.all(np.asarray(coupled) == sym.trivial_sector):
                return -J * bb.eye_matrix(shape[0], Dtype.float64)
            return bb.zeros(shape, Dtype.float64)

        h = SymmetricTensor.from_sector_block_func(
            func, [p, p], [p, p], backend=self.backend,
            labels=['p0', 'p1', 'p1*', 'p0*'])
        return [h] * (self.L - 1)

    def energy(self, psi) -> float:
        return float(np.real(sum(complex(psi.bond_expectation_value(h, i))
                                 for i, h in enumerate(self.H_bonds))))

    def exact_finite_gs_energy(self) -> float:
        return self.EXACT_ENERGIES[self.L] * self.J


class SpinChainModel:
    r"""General spin-S XXZ chain:
    :math:`H = J \sum_i [\tfrac12 (S^+_i S^-_{i+1} + h.c.) + \Delta S^z_i S^z_{i+1}]
    + h_z \sum_i S^z_i`.

    ``S`` is any (half-)integer spin; ``conserve`` in ``('Sz', 'None')``. ``S=1,
    Delta=1`` is the Haldane chain (bulk e = -1.401484038971 per site, White & Huse,
    PRB 48, 3844). The tensors live on ``device`` (default: the CUDA card) unless a
    ``backend`` is given.
    """

    def __init__(self, L: int, S: float = 1.0, J: float = 1., Delta: float = 1.,
                 hz: float = 0., conserve: str = 'Sz', backend=None,
                 block_backend=None, bc: str = 'finite', device: str = None):
        from ..models.sites import SpinSite

        if conserve not in ('Sz', 'None', None):
            raise ValueError(f'SpinChainModel: unknown conserve={conserve!r}')
        if bc not in ('finite', 'infinite'):
            raise ValueError(f'unknown bc {bc!r}')
        self.L = L
        self.S = S
        self.J = J
        self.Delta = Delta
        self.hz = hz
        self.bc = bc
        self.conserve = conserve = conserve or 'None'
        if backend is None and block_backend is not None:
            from ..backends import get_backend

            backend = get_backend(u1_symmetry if conserve == 'Sz' else no_symmetry,
                                  block_backend, device=device)
        site = SpinSite(S, conserve=conserve, backend=backend, device=device)
        self.site = site
        self.site_leg = site.leg
        self.backend = site.backend
        # dense operators in the site's own public basis
        self._sz = site.get_op_numpy('Sz')
        self._sp = site.get_op_numpy('Sp')
        self._sm = site.get_op_numpy('Sm')
        self.H_bonds = self._build_H_bonds()
        self.H_mpo = self._build_H_mpo()

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def _build_H_bonds(self):
        d = int(self.site_leg.dim)
        sz, sp, sm = self._sz, self._sp, self._sm
        eye = np.eye(d)
        p = self.site_leg
        finite = self.bc == 'finite'
        res = []
        for i in range(self.L - 1 if finite else self.L):
            hL = self.hz / 2. * (2. if i == 0 and finite else 1.)
            hR = self.hz / 2. * (2. if i + 1 == self.L - 1 and finite else 1.)
            h = self.J * (0.5 * (np.kron(sp, sm) + np.kron(sm, sp))
                          + self.Delta * np.kron(sz, sz)) \
                + hL * np.kron(sz, eye) + hR * np.kron(eye, sz)
            res.append(SymmetricTensor.from_dense_block(
                h.reshape(d, d, d, d).transpose(0, 1, 3, 2), [p, p], [p, p],
                backend=self.backend, labels=['p0', 'p1', 'p1*', 'p0*']))
        return res

    def _build_H_mpo(self):
        d = int(self.site_leg.dim)
        sz, sp, sm = self._sz, self._sp, self._sm
        p = self.site_leg
        sym = p.symmetry
        W = np.zeros((5, d, d, 5))
        W[0, :, :, 0] = np.eye(d)
        W[0, :, :, 1] = sp
        W[0, :, :, 2] = sm
        W[0, :, :, 3] = sz
        W[0, :, :, 4] = self.hz * sz
        W[1, :, :, 4] = self.J / 2. * sm
        W[2, :, :, 4] = self.J / 2. * sp
        W[3, :, :, 4] = self.J * self.Delta * sz
        W[4, :, :, 4] = np.eye(d)
        if self.conserve == 'Sz':
            w_sectors = np.array([[0], [2], [-2], [0], [0]])
        else:
            w_sectors = np.zeros((5, sym.sector_ind_len), dtype=int)
        w_leg = ElementarySpace.from_basis(sym, w_sectors)
        triv = ElementarySpace(sym, sym.trivial_sector[None, :])
        first = np.zeros((1, 5))
        first[0, 0] = 1.
        last = np.zeros((5, 1))
        last[4, 0] = 1.
        mpos = []
        for i in range(self.L):
            Wi = W
            wl, wr = w_leg, w_leg
            if i == 0 and self.bc == 'finite':
                Wi = np.tensordot(first, Wi, (1, 0))
                wl = triv
            if i == self.L - 1 and self.bc == 'finite':
                Wi = np.tensordot(Wi, last, (3, 0))
                wr = triv
            mpos.append(SymmetricTensor.from_dense_block(
                np.transpose(Wi, (0, 1, 3, 2)), [wl, p], [p, wr],
                backend=self.backend, labels=['wL', 'p', 'wR', 'p*']))
        return mpos

    def energy(self, psi) -> float:
        """Total energy (finite) or energy per site (infinite)."""
        e = float(np.real(sum(complex(psi.bond_expectation_value(h, i))
                              for i, h in enumerate(self.H_bonds))))
        return e / self.L if self.bc == 'infinite' else e


def _model_site(site_cls, backend, block_backend, device, *args):
    """A site of ``site_cls(*args)`` on ``backend``, or on the ``block_backend`` tensor
    backend of its symmetry on ``device``."""
    site = site_cls(*args, backend=backend, device=device)
    if backend is None and block_backend is not None:
        from ..backends import get_backend

        backend = get_backend(site.leg.symmetry, block_backend, device=device)
        if backend is not site.backend:
            site = site_cls(*args, backend=backend)
    return site


class FermiHubbardModel:
    r"""Fermi-Hubbard chain:
    :math:`H = -t \sum_{s,i} (c^\dagger_{s,i} c_{s,i+1} + h.c.) + U \sum_i n_{u,i} n_{d,i}`.

    Built from the coupling factories on :class:`SpinHalfFermionSite` with graded
    fermion statistics (no Jordan-Wigner strings between sites); by default
    ``FermionNumber('N') x U1('2*Sz')`` is conserved, on the fusion-tree backend. The
    tensors live on ``device`` (default: the CUDA card) unless a ``backend`` is given.
    """

    def __init__(self, L: int, t: float = 1., U: float = 4., conserve_N: str = 'N',
                 conserve_S: str = 'Sz', backend=None, block_backend=None,
                 device: str = None):
        from ..models.couplings import hopping, onsite_interaction
        from ..models.sites import SpinHalfFermionSite
        from ..models.tenpy_models import CouplingModel

        self.L = L
        self.t = t
        self.U = U
        site = _model_site(SpinHalfFermionSite, backend, block_backend, device,
                           conserve_N, conserve_S)
        self.site = site
        self.site_leg = site.leg
        self.backend = site.backend
        cm = CouplingModel([site] * L)
        for i in range(L - 1):
            cm.add_coupling(i, hopping([site, site], t=t, species='u'))
            cm.add_coupling(i, hopping([site, site], t=t, species='dn'))
        if U != 0:
            for i in range(L):
                cm.add_onsite(i, onsite_interaction([site], U=U))
        self.H_bonds = cm.all_bond_ops()
        self.H_mpo = mpo_from_bond_ops(self.H_bonds)

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def exact_finite_gs_energy(self, sector=None) -> float:
        """Sparse ED of the bond sum the MPO represents; restricted to the states of
        total charge ``sector`` (e.g. ``[N, 2 Sz]``) if one is given."""
        return bond_sum_ground_energy(self.H_bonds, self.site_leg, self.L, sector)


class KitaevChainModel:
    r"""Kitaev chain (p-wave superconductor):
    :math:`H = \sum_i [-t (c^\dagger_i c_{i+1} + h.c.)
    + \Delta (c^\dagger_i c^\dagger_{i+1} + h.c.)] - \mu \sum_i n_i`.

    Built from the ``hopping``, ``pairing`` and ``chemical_potential`` factories on
    :class:`SpinlessFermionSite` with graded fermion statistics. Pairing breaks the
    particle number, so ``conserve`` is 'parity' (default) or 'None'. The exact
    references are the open chain's BdG solution and sparse ED. The tensors live on
    ``device`` (default: the CUDA card) unless a ``backend`` is given.
    """

    def __init__(self, L: int, t: float = 1., delta: float = 1., mu: float = 0.,
                 conserve: str = 'parity', backend=None, block_backend=None,
                 device: str = None):
        from ..models.couplings import chemical_potential, hopping, pairing
        from ..models.sites import SpinlessFermionSite
        from ..models.tenpy_models import CouplingModel

        if conserve not in ('parity', 'None', None):
            raise ValueError(f'KitaevChainModel: unknown conserve={conserve!r}')
        self.L = L
        self.t = t
        self.delta = delta
        self.mu = mu
        site = _model_site(SpinlessFermionSite, backend, block_backend, device,
                           conserve or 'None')
        self.site = site
        self.site_leg = site.leg
        self.backend = site.backend
        cm = CouplingModel([site] * L)
        for i in range(L - 1):
            cm.add_coupling(i, hopping([site, site], t=t))
            if delta != 0:
                cm.add_coupling(i, pairing([site, site], D=delta))
        if mu != 0:
            for i in range(L):
                cm.add_onsite(i, chemical_potential([site], mu=mu))
        self.H_bonds = cm.all_bond_ops()
        self.H_mpo = mpo_from_bond_ops(self.H_bonds)

    @property
    def site_legs(self):
        return [self.site_leg] * self.L

    def exact_finite_gs_energy(self, parity: str = None):
        """BdG ground energy of the open chain.

        The ground state fills every negative BdG mode: ``E = (tr(h) - sum_k eps_k) /
        2``, returned for ``parity=None``. ``parity='both'`` returns the unordered pair
        ``(E, E + eps_min)``, the lowest energies of the two parity sectors (flipping
        the lowest mode flips the parity; which one is even needs the Pfaffian's sign,
        which is not computed: resolve it by ED or the initial state's parity).
        """
        L, t, D, mu = self.L, self.t, self.delta, self.mu
        h = np.zeros((L, L))
        d = np.zeros((L, L))
        for i in range(L - 1):
            h[i, i + 1] = h[i + 1, i] = -t
            d[i, i + 1] = D
            d[i + 1, i] = -D
        np.fill_diagonal(h, -mu)
        eps = np.sort(np.linalg.eigvalsh(np.block([[h, d], [-d, -h]])))
        # the spectrum comes in +- pairs; the upper half are the quasiparticle
        # energies (a threshold would drop the exponentially small Majorana mode)
        pos = eps[L:]
        E = 0.5 * (np.trace(h) - pos.sum())
        if parity is None:
            return float(E)
        if parity != 'both':
            raise ValueError("parity must be None or 'both' (sector labels would need "
                             "the Pfaffian's sign)")
        return float(E), float(E + (pos.min() if len(pos) else 0.))


# --- exact reference (sparse ED) -------------------------------------------------------


def bond_sum_ground_energy(H_bonds, site_leg, L: int, sector=None) -> float:
    """Lowest eigenvalue of the sum of nearest-neighbour bond operators (legs ``[p0,
    p1, p1*, p0*]``) over ``L`` sites with leg ``site_leg``, by sparse ED of their
    dense forms: for fermions, the chain's Jordan-Wigner form. With ``sector``, only
    the basis states whose charges fuse to it count (abelian symmetries)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg

    d = int(site_leg.dim)
    H = sp.csr_matrix((d ** L, d ** L))
    for i, h in enumerate(H_bonds):
        hd = sp.csr_matrix(h.to_numpy().transpose(0, 1, 3, 2).reshape(d * d, d * d))
        H = H + sp.kron(sp.kron(sp.identity(d ** i, format='csr'), hd),
                        sp.identity(d ** (L - i - 2), format='csr'), format='csr')
    if sector is not None:
        sym = site_leg.symmetry
        basis = site_leg.sectors_of_basis
        total = basis
        for _ in range(L - 1):
            total = sym.fusion_outcomes_broadcast(
                np.repeat(total, d, axis=0), np.tile(basis, (len(total), 1)))
        keep = np.flatnonzero(np.all(total == np.asarray(sector), axis=1))
        H = H[keep][:, keep]
    if H.shape[0] <= 64:
        return float(np.linalg.eigvalsh(H.toarray())[0])
    return float(scipy.sparse.linalg.eigsh(H, k=1, which='SA',
                                           return_eigenvectors=False)[0])


def _sparse_chain_hamiltonian(L: int, bond_terms):
    """Sparse Hamiltonian from a list of (coupling, op_i, op_j) nearest-neighbor terms
    plus optional onsite terms; ops are 2x2 matrices."""
    import scipy.sparse as sp

    dim = 2 ** L
    H = sp.csr_matrix((dim, dim))

    def op_at(op, i):
        mats = [sp.identity(2, format='csr')] * L
        mats[i] = sp.csr_matrix(op)
        res = mats[0]
        for m in mats[1:]:
            res = sp.kron(res, m, format='csr')
        return res

    for term in bond_terms:
        if len(term) == 3:
            c, op1, op2 = term
            for i in range(L - 1):
                H = H + c * (op_at(op1, i) @ op_at(op2, i + 1))
        else:
            c, op1 = term[0], term[1]
            for i in range(L):
                H = H + c * op_at(op1, i)
    return H


def heisenberg_exact_finite_gs_energy(L: int, J: float) -> float:
    """Exact Heisenberg ground energy for a finite open chain (sparse ED)."""
    import scipy.sparse.linalg

    Sp = np.array([[0., 1.], [0., 0.]])
    Sm = Sp.T
    Sz = 0.5 * _sz
    H = _sparse_chain_hamiltonian(
        L, [(J / 2., Sp, Sm), (J / 2., Sm, Sp), (J, Sz, Sz)])
    vals = scipy.sparse.linalg.eigsh(H, k=1, which='SA',
                                     return_eigenvectors=False)
    return float(vals[0])


def tfi_exact_infinite_gs_energy(J: float, g: float) -> float:
    """Ground-state energy per site of the infinite TFI chain (free fermions):
    e = -(1/pi) int_0^pi dk sqrt(J^2 + g^2 - 2 J g cos k).

    Checks: g=0 -> -J; J=0 -> -g; J=g=1 -> -4/pi."""
    from scipy.integrate import quad

    val, _ = quad(lambda k: np.sqrt(J * J + g * g - 2 * J * g * np.cos(k)),
                  0.0, np.pi, limit=200)
    return -val / np.pi


def tfi_exact_finite_gs_energy(L: int, J: float, g: float) -> float:
    """Exact TFI ground energy for a finite open chain (sparse ED)."""
    import scipy.sparse.linalg

    H = _sparse_chain_hamiltonian(L, [(-J, _sx, _sx), (-g, _sz)])
    vals = scipy.sparse.linalg.eigsh(H, k=1, which='SA',
                                     return_eigenvectors=False)
    return float(vals[0])
