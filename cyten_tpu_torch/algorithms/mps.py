"""Finite matrix-product states in right-canonical (B) form.

The counterpart of ``cyten_tpu/algorithms/mps.py`` for finite chains: ``SimpleMPS``
(product, singlet and fusion-pair states, two-site wavefunctions, ``canonicalize``, and
the measurements: site and bond expectation values, local operators, entanglement
entropies, correlation functions with charged pairs, MPO expectation values and
variances, norms and overlaps) and ``split_truncate_theta`` (:664) with the exact
per-sector SVD. All contractions are label-based ``tdot`` and ``compose`` calls. A
``SimpleMPS`` is a type of the persistence schema (``tools/hdf5_io.py``).

Conventions:

- ``Bs[i]``: site tensor with labels ``['vL', 'p', 'vR']``, codomain ``[vL, p]``,
  domain ``[vR]``; right-canonical: contracting p and vR of B with its conjugate gives
  the identity on vL.
- ``Ss[i]``: DiagonalTensor of singular values on the *left* bond of site i.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Dtype
from ..backends import get_backend
from ..symmetries import ElementarySpace
from ..tensors import (
    ChargedTensor, DiagonalTensor, SymmetricTensor, Tensor, complex_conj, compose,
    dagger, eigh, entropy, eye, inner, item, linear_combination, lq, norm, permute_legs,
    pinv, qr, scale_axis, sqrt, svd, svd_apply_mask, tdot, trace,
    truncate_singular_values,
)
from ..tensors.adaptive import adaptive_truncated_svd, fused_truncated_svd
from ..tensors.randomized import randomized_truncated_svd

__all__ = ['SimpleMPS', 'split_truncate_theta']


class SimpleMPS:
    """A finite MPS in B-form. See module docstring for conventions."""

    def __init__(self, Bs, Ss, bc: str = 'finite'):
        assert bc in ('finite', 'infinite')
        self.Bs = list(Bs)
        self.Ss = list(Ss)
        self.bc = bc
        self.L = len(Bs)
        self.backend = Bs[0].backend

    def copy(self):
        return SimpleMPS([B.copy(deep=False) for B in self.Bs],
                         [S.copy(deep=False) for S in self.Ss], self.bc)

    def enlarge_unit_cell(self, factor: int) -> SimpleMPS:
        """The same infinite state on a ``factor * L``-site unit cell.

        Useful to bring cross-cell sites into indexable range (e.g. for
        ``correlation_function`` between sites of different cells)."""
        assert self.bc == 'infinite', 'only meaningful for infinite MPS'
        assert factor >= 1
        return SimpleMPS([B.copy(deep=False) for B in self.Bs * factor],
                         [S.copy(deep=False) for S in self.Ss * factor],
                         bc='infinite')

    @classmethod
    def from_product_state(cls, site_legs, basis_states, backend=None,
                           dtype=Dtype.float64, bc: str = 'finite',
                           device: str = None) -> SimpleMPS:
        """Product state MPS: ``basis_states[i]`` is the public basis index on site i.

        Without a ``backend`` the tensors live on ``device`` (default: the CUDA card).

        Virtual legs carry the cumulative charge so the state is exactly symmetric.
        For ``bc='infinite'`` the unit cell must carry total trivial charge (so the
        virtual leg wraps consistently).
        """
        symmetry = site_legs[0].symmetry
        if backend is None:
            backend = get_backend(symmetry, device=device)
        L = len(site_legs)
        Bs = []
        Ss = []
        left_sector = symmetry.trivial_sector
        left_leg = ElementarySpace(symmetry, left_sector[None, :])
        for i in range(L):
            p_leg = site_legs[i]
            state_sector = p_leg.idx_to_sector(basis_states[i]) \
                if symmetry.can_be_dropped else symmetry.trivial_sector
            right_sector = symmetry.multiple_fusion(left_sector, state_sector)
            right_leg = ElementarySpace(symmetry, right_sector[None, :])
            block = np.zeros((1, int(p_leg.dim), 1))
            block[0, basis_states[i], 0] = 1.
            B = SymmetricTensor.from_dense_block(
                block, [left_leg, p_leg], [right_leg], backend=backend,
                labels=['vL', 'p', 'vR'], dtype=dtype)
            Bs.append(B)
            Ss.append(DiagonalTensor.from_eye(left_leg, backend=B.backend,
                                              labels=['vL', 'vL*'], dtype=dtype))
            left_sector = right_sector
            left_leg = right_leg
        if bc == 'infinite' and not np.array_equal(left_sector,
                                                   symmetry.trivial_sector):
            raise ValueError('infinite product state: unit cell must carry total '
                             f'trivial charge, got {left_sector}')
        return cls(Bs, Ss, bc=bc)

    @classmethod
    def from_singlet_pairs(cls, site_leg, L: int, backend=None,
                           dtype=Dtype.float64, bc: str = 'finite',
                           device: str = None) -> SimpleMPS:
        """Product of nearest-neighbor singlet pairs (SU(2)-invariant MPS).

        Without a ``backend`` the tensors live on ``device`` (default: the CUDA card).

        Right-canonical by construction: even sites carry the identity (/sqrt 2 of
        the Schmidt split), odd sites the epsilon tensor.
        """
        assert L % 2 == 0
        symmetry = site_leg.symmetry
        if backend is None:
            backend = get_backend(symmetry, device=device)
        triv = ElementarySpace(symmetry, symmetry.trivial_sector[None, :])
        half = site_leg  # the bond inside a pair carries the same rep as the site
        d = int(site_leg.dim)
        eps = np.zeros((d, d))
        for a in range(d):
            eps[a, d - 1 - a] = (-1.) ** a
        Bs, Ss = [], []
        for i in range(L):
            if i % 2 == 0:
                block = (np.eye(d) / np.sqrt(d)).reshape(1, d, d)
                B = SymmetricTensor.from_dense_block(
                    block, [triv, site_leg], [half], backend=backend,
                    labels=['vL', 'p', 'vR'], dtype=dtype)
                S = DiagonalTensor.from_eye(triv, backend=B.backend,
                                            labels=['vL', 'vL*'], dtype=dtype)
            else:
                block = eps.reshape(d, d, 1)
                B = SymmetricTensor.from_dense_block(
                    block, [half, site_leg], [triv], backend=backend,
                    labels=['vL', 'p', 'vR'], dtype=dtype)
                S = DiagonalTensor.from_sector_block_func(
                    lambda shape, c: B.backend.block_backend.ones(shape, dtype)
                    / np.sqrt(d), half, backend=B.backend, labels=['vL', 'vL*'])
            Bs.append(B)
            Ss.append(S)
        return cls(Bs, Ss, bc=bc)  # singlet cell: trivial outer bonds wrap

    @classmethod
    def from_fusion_pairs(cls, site_leg, L: int, backend=None,
                          dtype=Dtype.float64, device: str = None) -> SimpleMPS:
        """Pairs of neighboring sites fused to the vacuum (works for anyons).

        Without a ``backend`` the tensors live on ``device`` (default: the CUDA card).

        The generalization of :meth:`from_singlet_pairs` to arbitrary symmetries,
        built sector-wise (no dense detour). Its blocks are ``dtype`` (f64 by
        default), also for a symmetry with complex topological data, as in
        ``cyten_tpu``: DMRG makes them complex where the Hamiltonian is.
        """
        assert L % 2 == 0
        symmetry = site_leg.symmetry
        if backend is None:
            backend = get_backend(symmetry, device=device)
        bb = backend.block_backend
        triv = ElementarySpace(symmetry, symmetry.trivial_sector[None, :])
        bond = site_leg.as_ket_space() if site_leg.is_dual else site_leg

        def ones_func(shape, coupled):
            return bb.ones(shape, dtype)

        Bs, Ss = [], []
        for i in range(L):
            if i % 2 == 0:
                B = SymmetricTensor.from_sector_block_func(
                    ones_func, [triv, site_leg], [bond], backend=backend,
                    labels=[['vL', 'p'], ['vR']])
                S = DiagonalTensor.from_eye(triv, backend=backend,
                                            labels=['vL', 'vL*'], dtype=dtype)
            else:
                B = SymmetricTensor.from_sector_block_func(
                    ones_func, [bond, site_leg], [triv], backend=backend,
                    labels=[['vL', 'p'], ['vR']])
                S = DiagonalTensor.from_eye(bond, backend=backend,
                                            labels=['vL', 'vL*'], dtype=dtype)
            Bs.append(B)
            Ss.append(S)
        return cls(Bs, Ss)

    def get_theta1(self, i: int) -> SymmetricTensor:
        """Effective single-site wavefunction ``S_i @ B_i``, labels [vL, p, vR]."""
        i = i % self.L if self.bc == 'infinite' else i
        return scale_axis(self.Bs[i], self.Ss[i], 'vL')

    def get_theta2(self, i: int) -> SymmetricTensor:
        """Two-site wavefunction on (i, i+1), labels [vL, p0, p1, vR].

        For infinite MPS the site index wraps around the unit cell."""
        j = (i + 1) % self.L if self.bc == 'infinite' else i + 1
        th = self.get_theta1(i).relabelled({'p': 'p0'})
        B2 = self.Bs[j].relabelled({'p': 'p1'})
        theta = tdot(th, B2, 'vR', 'vL')
        # result: codomain [vL, p0], domain [vR, p1] -> canonical split
        return permute_legs(theta, codomain=['vL', 'p0', 'p1'], domain=['vR'])

    def bond_expectation_value(self, op, i: int):
        """<psi| op_{i,i+1} |psi> for a 2-site op (codomain [p0,p1], domain [p0,p1])."""
        theta = self.get_theta2(i)
        op = op.relabelled(['p0', 'p1', 'p1*', 'p0*'])
        thp = permute_legs(theta, codomain=['p0', 'p1'], domain=['vL', 'vR'])
        op_th = compose(op, thp)  # legs [p0, p1, vR, vL]
        op_th = permute_legs(op_th, codomain=['vL', 'p0', 'p1'], domain=['vR'])
        return inner(theta, op_th, do_dagger=True)

    def entanglement_entropy(self) -> list[float]:
        """Von Neumann entropy at each bond (qdim-weighted for non-abelian)."""
        res = []
        bonds = range(self.L) if self.bc == 'infinite' else range(1, self.L)
        for i in bonds:
            S = self.Ss[i]
            p = S * S
            p = (1. / float(p.sum())) * p
            res.append(entropy(p, n=1))
        return res

    def correlation_function(self, op_i, i: int, op_j, j: int):
        """<psi| op_i op_j |psi> for single-site operators, i < j.

        Transfer-matrix contraction left to right (planar rearrangements only).
        Charge-raising/-lowering operators (``ChargedTensor``, e.g. ``Sp``/``Sm``
        under Sz conservation) are supported in pairs: the hidden charge legs
        propagate through the transfer matrix and pair up at site j.
        """
        assert i < j
        if isinstance(op_i, ChargedTensor) or isinstance(op_j, ChargedTensor):
            assert isinstance(op_i, ChargedTensor) and isinstance(op_j, ChargedTensor), \
                'charged operators only pair with charged operators'
            return self._charged_correlation(op_i, i, op_j, j)
        theta = self.get_theta1(i)
        oi = op_i.relabelled(['p', 'p*'])
        thp = permute_legs(theta, codomain=['p'], domain=['vL', 'vR'])
        op_th = permute_legs(compose(oi, thp), codomain=['vL', 'p'], domain=['vR'])
        E = tdot(dagger(theta), op_th, ['vL*', 'p*'], ['vL', 'p'])  # [vR*; vR]
        for k in range(i + 1, j):
            E = tdot(E, self.Bs[k], 'vR', 'vL')
            E = tdot(dagger(self.Bs[k]), E, ['vL*', 'p*'], ['vR*', 'p'])
        Bj = self.Bs[j]
        oj = op_j.relabelled(['p', 'p*'])
        Bp = permute_legs(Bj, codomain=['p'], domain=['vL', 'vR'])
        op_B = permute_legs(compose(oj, Bp), codomain=['vL', 'p'], domain=['vR'])
        E = tdot(E, op_B, 'vR', 'vL')
        E = tdot(dagger(Bj), E, ['vL*', 'p*', 'vR*'], ['vR*', 'p', 'vR'])
        return _as_scalar(E)

    def _charged_correlation(self, op_i, i: int, op_j, j: int):
        """Transfer contraction with the hidden charge legs kept open, then
        contracted with the operators' charged states at the end (on the host)."""
        if op_i.charged_state is None or op_j.charged_state is None:
            raise ValueError('charged correlation needs charged_state on both ops')
        bang = type(op_i)._CHARGE_LEG_LABEL
        oi = op_i.invariant_part.relabelled({bang: '!i'})  # ['p', 'p*', '!i']
        oj = op_j.invariant_part.relabelled({bang: '!j'})
        theta = self.get_theta1(i)
        t = tdot(oi, theta, 'p*', 'p')            # [p, !i, vL, vR]
        E = tdot(dagger(theta), t, ['vL*', 'p*'], ['vL', 'p'])  # [vR*; ... !i, vR]
        for k in range(i + 1, j):
            E = tdot(E, self.Bs[k], 'vR', 'vL')
            E = tdot(dagger(self.Bs[k]), E, ['vL*', 'p*'], ['vR*', 'p'])
        Bj = self.Bs[j]
        t = tdot(E, Bj, 'vR', 'vL')               # [vR*, !i, p, vR]
        t = tdot(t, oj, 'p', 'p*')                # [vR*, !i, vR, p, !j]
        res = tdot(dagger(Bj), t, ['vL*', 'p*', 'vR*'], ['vR*', 'p', 'vR'])
        # res: 2-leg invariant tensor on the charge legs [!i, !j]
        res = permute_legs(res, codomain=['!i', '!j'], domain=[])
        bb = res.backend.block_backend
        dense = bb.to_numpy(res.to_dense_block())
        si = op_i.backend.block_backend.to_numpy(op_i.charged_state)
        sj = op_j.backend.block_backend.to_numpy(op_j.charged_state)
        axes = [res.labels.index('!i'), res.labels.index('!j')]
        if axes == [1, 0]:
            dense = dense.T
        return complex(si @ dense @ sj) if np.iscomplexobj(dense) \
            else float(si @ dense @ sj)

    def expectation_value_mpo(self, mpos) -> float:
        """<psi| MPO |psi> for a finite MPO (one ``[wL, p, wR, p*]`` tensor per
        site, boundary-selected at the ends, e.g. ``model.H_mpo``)."""
        return self._mpo_expectation([mpos])

    def mpo_variance(self, mpos) -> float:
        """Variance <(O - <O>)^2> of a finite MPO: the standard DMRG convergence
        diagnostic (small variance => eigenstate)."""
        e = self._mpo_expectation([mpos])
        e2 = self._mpo_expectation([mpos, mpos])
        return float(np.real(e2 - e * e))

    def _mpo_expectation(self, layers):
        """<psi| prod(layers) |psi> by a left-to-right environment contraction.

        Valid in any gauge: bra and ket use the same site tensors
        ``[theta1(0), B_1, ..., B_{L-1}]`` which multiply out to the state; also for a
        state of nonzero total charge, whose last bond is 1-dim in a nontrivial sector
        (``cyten_tpu``'s fails there, as its ``item`` wants trivial legs). The ket is
        contracted onto the environment (``tdot(E, M)``, as :meth:`overlap` does): in
        the other order a graded symmetry's braids cost a sign per odd leg crossed,
        and fermionic states of odd parity, and two layers, came out wrong
        (``cyten_tpu/algorithms/mps.py:381``)."""
        assert self.bc == 'finite'
        L = self.L
        n_lay = len(layers)
        sym = self.Bs[0].symmetry
        triv = ElementarySpace(sym, sym.trivial_sector[None, :])
        V0 = self.Bs[0].get_leg_co_domain('vL')
        bb = self.backend.block_backend
        dtype = self.Bs[0].dtype

        def ones_func(shape, coupled):
            return bb.ones(shape, dtype)

        w_labels = [f'w{k}' for k in range(n_lay)]
        E = SymmetricTensor.from_sector_block_func(
            ones_func, [V0], [V0] + [triv] * n_lay, backend=self.backend,
            labels=[['vR*'], ['vR'] + w_labels])
        for i in range(L):
            M = self.get_theta1(0) if i == 0 else self.Bs[i]
            t = tdot(E, M, 'vR', 'vL')   # [vR*] + [w0, w1, ..., p, vR]
            for k, mpo in enumerate(layers):
                Wk = mpo[i].relabelled({'wL': f'w{k}L', 'wR': f'w{k}R'})
                t = tdot(t, Wk, ['p', w_labels[k]], ['p*', f'w{k}L'])
                t = t.relabelled({f'w{k}R': w_labels[k]})
            E = tdot(dagger(M), t, ['vL*', 'p*'], ['vR*', 'p'])
        if not all(l.is_trivial for l in E.legs):
            # a charged boundary (nonzero total charge): the legs left are 1-dim, the
            # last bond in a nontrivial sector, so the value is E's one entry
            return E.to_numpy().item()
        return _as_scalar(E)

    def norm_squared(self):
        S = self.Ss[0]
        return float(np.sum(np.abs(S.diag_numpy) ** 2))

    def overlap(self, other: SimpleMPS):
        """<self | other>, assuming matching site legs."""
        assert self.L == other.L
        t_self = dagger(self.get_theta1(0))
        t_other = other.get_theta1(0)
        E = tdot(t_self, t_other, ['vL*', 'p*'], ['vL', 'p'])  # [vR* ; vR]
        for i in range(1, self.L):
            E = tdot(E, other.Bs[i], 'vR', 'vL')
            E = tdot(dagger(self.Bs[i]), E, ['vL*', 'p*'], ['vR*', 'p'])
        if isinstance(E, Tensor) and not all(l.is_trivial for l in E.legs):
            # charged boundary (nonzero total charge): the final [vR*; vR]
            # pair is 1-dim but in a nontrivial sector, closed by a trace
            E = trace(permute_legs(E, codomain=['vR'], domain=['vR*']))
        return _as_scalar(E)

    def bond_dimensions(self) -> list[int]:
        return [int(B.get_leg_co_domain('vL').dim) for B in self.Bs] \
            + [int(self.Bs[-1].domain.factors[0].dim)]

    def max_chi(self) -> int:
        return max(self.bond_dimensions())

    def canonicalize(self, normalize: bool = True):
        """Restore exact right-canonical B form with true Schmidt values (in place).

        Two passes over the finite chain: a left-to-right QR sweep into
        left-isometric form, then a right-to-left SVD sweep that right-canonicalizes
        every site and collects the singular values.
        """
        assert self.bc == 'finite', 'canonicalize: finite MPS only'
        L = self.L
        # pass 1: left-to-right QR -> left-isometric A's, center carried in T
        As = []
        T = self.get_theta1(0)  # S_0 B_0, codomain [vL, p], domain [vR]
        for i in range(L - 1):
            Q, R = qr(T, new_labels=['vR', 'vL'])
            As.append(Q)
            T = tdot(R, self.Bs[i + 1], 'vR', 'vL')
            T = permute_legs(T, codomain=['vL', 'p'], domain=['vR'])
        # pass 2: right-to-left SVD -> right-isometric B's + Schmidt values
        for i in range(L - 1, 0, -1):
            Tp = permute_legs(T, codomain=['vL'], domain=['vR', 'p'])
            U, S, Vh = svd(Tp, new_labels=['vR', 'vL'])
            if normalize:
                S = (1. / norm(S)) * S
            self.Bs[i] = permute_legs(Vh, codomain=['vL', 'p'], domain=['vR'])
            self.Ss[i] = S.relabelled(['vL', 'vL*'])
            carry = scale_axis(U, S, 'vR')
            T = tdot(As[i - 1], carry, 'vR', 'vL')
            T = permute_legs(T, codomain=['vL', 'p'], domain=['vR'])
        # site 0: T == S_0 B_0 of the canonicalized state
        self.Bs[0] = scale_axis(T, pinv(self.Ss[0], cutoff=1e-14), 'vL')
        return self

    # --- infinite chains ----------------------------------------------------------------

    def canonicalize_infinite(self, n_cells: int = None, method: str = None,
                              tol: float = 0.0):
        """Restore canonical B form of an infinite MPS (in place).

        Two methods:

        ``'fixed_point'`` (default): the transfer-matrix gauge fix (Orus & Vidal, PRB
        78, 155117 (2008)). Arnoldi (scipy's ARPACK on the host, each matvec's
        contractions on the tensors' device) finds the dominant left/right fixed points
        of the unit-cell transfer operator; their Hermitian square roots
        ``sigma_L = Y^dag Y``, ``rho_R = X X^dag`` and the SVD ``Y X = U S V^dag`` fix
        the boundary gauge (``S`` = the boundary Schmidt values); one QR and one SVD
        pass through the cell then canonicalize the interior.

        ``'window'`` (used when ``n_cells`` is given): unroll ``n_cells`` copies of the
        cell into a finite MPS, run the finite canonicalization, read the central cell
        back. Boundary effects decay like ``lambda_2^(n_cells/2)``; the fallback for
        non-injective states (degenerate transfer spectrum).
        """
        assert self.bc == 'infinite'
        if method is None:
            method = 'window' if n_cells is not None else 'fixed_point'
        if method == 'fixed_point':
            return self._canonicalize_fixed_point(tol)
        if method != 'window':
            raise ValueError(f'unknown method {method!r}')
        return self._canonicalize_window(16 if n_cells is None else n_cells)

    def _canonicalize_window(self, n_cells: int = 16):
        L = self.L
        fin = SimpleMPS([self.Bs[i % L] for i in range(n_cells * L)],
                        [self.Ss[i % L] for i in range(n_cells * L)], bc='finite')
        fin.canonicalize()
        mid = (n_cells // 2) * L
        # the cell must wrap: bond mid and bond mid+L need identical leg spaces
        if not fin.Bs[mid].get_leg_co_domain('vL') == \
                fin.Bs[mid + L].get_leg_co_domain('vL'):
            raise ValueError('canonicalize_infinite: cell bonds did not converge to '
                             'equal spaces; increase n_cells')
        self.Bs = [fin.Bs[mid + i] for i in range(L)]
        self.Ss = [fin.Ss[mid + i] for i in range(L)]
        return self

    def _transfer_fixed_points(self, tol: float):
        """Dominant (eta, rho_R, sigma_L) of the unit-cell transfer operator.

        Both fixed points are returned Hermitian, PSD-projected and with unit trace, as
        square tensors ``[v; v*]`` on the cell-boundary bond. ARPACK runs on the host;
        each matvec carries one flat vector to the device and back.
        """
        import scipy.sparse.linalg as spla

        L, Bs = self.L, self.Bs
        bond = Bs[0].get_leg_co_domain('vL')
        backend = self.backend
        is_real = not Bs[0].dtype.is_complex

        def apply_right(rho):
            # rho: codomain [bond] 'vL', domain [bond] 'vL*' (right-env layout)
            t = rho
            for i in range(L - 1, -1, -1):
                x = tdot(Bs[i], t, 'vR', 'vL')             # [vL, p, vL*]
                t = tdot(x, dagger(Bs[i]), ['p', 'vL*'], ['p*', 'vR*'])
                t = permute_legs(t, codomain=['vL'], domain=['vL*'])
            return t

        def apply_left(sig):
            # sig: codomain [bond] 'vR*', domain [bond] 'vR' (left-env layout)
            t = sig
            for i in range(L):
                x = tdot(t, Bs[i], 'vR', 'vL')             # [vR*, p, vR]
                t = tdot(dagger(Bs[i]), x, ['vL*', 'p*'], ['vR*', 'p'])
                t = permute_legs(t, codomain=['vR*'], domain=['vR'])
            return t

        rho0 = eye([bond], backend=backend, labels=['vL', 'vL*'],
                   dtype=Bs[0].dtype).as_SymmetricTensor()
        sig0 = eye([bond], backend=backend, labels=['vR*', 'vR'],
                   dtype=Bs[0].dtype).as_SymmetricTensor()
        shape = rho0.shape
        dim = int(np.prod(shape))

        def solve(apply_fn, t0):
            if dim < 3:  # chi = 1: any vector spans the space
                t = t0
                for _ in range(3):
                    t2 = apply_fn(t)
                    eta = complex(inner(t, t2, do_dagger=True)) \
                        / complex(inner(t, t, do_dagger=True))
                    t = (1. / float(norm(t2))) * t2
                return eta, t

            def mv(flat):
                blk = np.ascontiguousarray(flat.reshape(shape))
                t = SymmetricTensor.from_dense_block(
                    blk, t0.codomain, t0.domain, backend, t0.labels, tol=None)
                return np.asarray(apply_fn(t).to_numpy(),
                                  dtype=np.complex128).reshape(-1)

            op = spla.LinearOperator((dim, dim), matvec=mv, dtype=np.complex128)
            v0 = np.asarray(t0.to_numpy(), dtype=np.complex128).reshape(-1)
            vals, vecs = spla.eigs(op, k=1, which='LM', v0=v0, tol=tol)
            t = SymmetricTensor.from_dense_block(
                np.ascontiguousarray(vecs[:, 0].reshape(shape)), t0.codomain,
                t0.domain, backend, t0.labels, tol=None)
            return complex(vals[0]), t

        def hermitize(t):
            tr = complex(trace(t))
            if abs(tr) > 1e-300:     # fix the Arnoldi phase: positive trace
                t = (abs(tr) / tr) * t
            dg = dagger(t).set_labels(t.labels)
            t = linear_combination(0.5, t, 0.5, dg)
            if is_real and t.dtype.is_complex:
                t = SymmetricTensor.from_dense_block(
                    np.ascontiguousarray(np.real(t.to_numpy())),
                    t.codomain, t.domain, backend, t.labels, tol=None)
            return (1. / float(np.real(complex(trace(t))))) * t

        eta_r, rho_R = solve(apply_right, rho0)
        eta_l, sig_L = solve(apply_left, sig0)
        eta = 0.5 * (abs(eta_r) + abs(eta_l))
        return eta, hermitize(rho_R), hermitize(sig_L)

    def _canonicalize_fixed_point(self, tol: float = 0.0, dead_cutoff: float = 1e-12):
        L, Bs = self.L, self.Bs
        eta, rho_R, sig_L = self._transfer_fixed_points(tol)

        def drop_dead(U, S, Vh):
            """Truncate numerically dead directions (relative ``dead_cutoff``): they
            carry no state weight, but their pseudo-inverted 1/S rows would leave
            non-isometric tensors behind."""
            if float(S.min()) >= dead_cutoff * float(S.max()):
                return U, S, Vh
            mask, _, _ = truncate_singular_values(S, svd_min=dead_cutoff * float(S.max()))
            return svd_apply_mask(U, S, Vh, mask)

        def sqrt_factors(rho):
            """rho = F F^dag with F = V sqrt(w); also pinv(F) = pinv(sqrt(w)) V^dag."""
            W, V = eigh(rho, new_labels=['e', 'e*'])
            sq = sqrt(abs(W))        # PSD projection: |w| differs only at noise level
            cut = float(sq.max()) * 1e-7   # sqrt of the eigenvalue noise floor
            F = scale_axis(V, sq, -1)
            Finv = scale_axis(dagger(V), pinv(sq, cutoff=cut), 0)
            return F, Finv

        X, Xinv = sqrt_factors(rho_R)       # rho_R = X X^dag
        Yd, Ydinv = sqrt_factors(sig_L)     # sig_L = Y^dag Y, Yd = Y^dag
        Y = dagger(Yd)
        Yinv = dagger(Ydinv)
        U, S, Vh = svd(compose(Y, X), new_labels=['vR', 'vL'])
        U, S, Vh = drop_dead(U, S, Vh)
        S = (1. / float(norm(S))) * S
        g_left = compose(Vh, Xinv).relabelled(['vL', 'vR'])
        g_right = scale_axis(compose(Yinv, U), S, -1)
        g_right = (1. / np.sqrt(eta)) * g_right.relabelled(['vL', 'vR'])

        Bt = list(Bs)
        B0 = tdot(g_left, Bt[0], 'vR', 'vL')
        Bt[0] = permute_legs(B0, codomain=['vL', 'p'], domain=['vR'])
        Bl = tdot(Bt[L - 1], g_right, 'vR', 'vL')
        Bt[L - 1] = permute_legs(Bl, codomain=['vL', 'p'], domain=['vR'])
        S_bound = S.relabelled(['vL', 'vL*'])

        # interior: one QR pass (left-isometric As) + one SVD pass, seeded by the now
        # exact boundary gauge on both ends (cf. the finite canonicalize)
        As = []
        T = scale_axis(Bt[0], S_bound, 'vL')
        for i in range(L - 1):
            Q, R = qr(T, new_labels=['vR', 'vL'])
            As.append(Q)
            T = tdot(R, Bt[i + 1], 'vR', 'vL')
            T = permute_legs(T, codomain=['vL', 'p'], domain=['vR'])
        new_Bs = [None] * L
        new_Ss = [None] * L
        new_Ss[0] = S_bound
        for i in range(L - 1, 0, -1):
            Tp = permute_legs(T, codomain=['vL'], domain=['vR', 'p'])
            Ui, Si, Vhi = svd(Tp, new_labels=['vR', 'vL'])
            Ui, Si, Vhi = drop_dead(Ui, Si, Vhi)
            Si = (1. / float(norm(Si))) * Si
            new_Bs[i] = permute_legs(Vhi, codomain=['vL', 'p'], domain=['vR'])
            new_Ss[i] = Si.relabelled(['vL', 'vL*'])
            T = tdot(As[i - 1], scale_axis(Ui, Si, 'vR'), 'vR', 'vL')
            T = permute_legs(T, codomain=['vL', 'p'], domain=['vR'])
        T = (1. / float(norm(T))) * T
        # T == S_bound @ B_0 up to fixed-point noise. Factor by (phase-fixed) LQ rather
        # than pinv(S): the L factor reabsorbs the noise instead of amplifying it by 1/S
        # in near-dead directions, so B_0 is exactly row-isometric.
        Tp = permute_legs(T, codomain=['vL'], domain=['vR', 'p'])
        Lf, Q = lq(Tp, new_labels=['vR', 'vL'])
        Lf, Q = _fix_lq_phases(Lf, Q)
        new_Bs[0] = permute_legs(Q, codomain=['vL', 'p'], domain=['vR'])
        self.Bs = new_Bs
        self.Ss = new_Ss
        return self

    def correlation_length(self, n_ev: int = 6) -> float:
        """Correlation length of an infinite MPS, in units of sites.

        ``xi = -L_cell / ln |lambda_2 / lambda_1|`` from the two dominant
        transfer-matrix eigenvalues (all charge sectors: the map acts on the dense
        blocks, on their device, and ARPACK on the host sees one flat vector a matvec).
        Requires ``bc='infinite'`` and a droppable symmetry.
        """
        assert self.bc == 'infinite'
        import scipy.sparse.linalg as spla
        import torch

        Bs = [B.to_dense_block().to(torch.complex128) for B in self.Bs]  # [vL, p, vR]
        chi = int(Bs[0].shape[0])

        def tmap(flat):
            E = torch.from_numpy(np.ascontiguousarray(flat, dtype=np.complex128))
            E = E.to(Bs[0].device).reshape(chi, chi)
            for B in Bs:
                t = torch.tensordot(E, B, dims=([1], [0]))                  # [a, p, y]
                E = torch.tensordot(B.conj(), t, dims=([0, 1], [0, 1]))     # [x, y]
            return E.reshape(-1).cpu().numpy()

        if chi * chi <= 16:  # dense fallback for tiny bonds
            M = np.column_stack([tmap(e) for e in np.eye(chi * chi)])
            lam = np.linalg.eigvals(M)
        else:
            op = spla.LinearOperator((chi * chi, chi * chi), matvec=tmap, dtype=complex)
            lam = spla.eigs(op, k=min(n_ev, chi * chi - 2), which='LM',
                            return_eigenvectors=False)
        lam = np.sort(np.abs(lam))[::-1]
        if len(lam) < 2 or lam[1] < 1e-14:
            return 0.0
        return float(-self.L / np.log(lam[1] / lam[0]))

    # --- measurements -----------------------------------------------------------------

    def site_expectation_value(self, op, i: int):
        """<psi| op_i |psi> for a single-site operator (codomain [p], domain [p]).

        Planar rearrangements and the structural inner product only (anyon-safe).
        """
        theta = self.get_theta1(i)
        op = op.relabelled(['p', 'p*'])
        thp = permute_legs(theta, codomain=['p'], domain=['vL', 'vR'])
        op_th = compose(op, thp)  # legs [p, vR, vL]
        op_th = permute_legs(op_th, codomain=['vL', 'p'], domain=['vR'])
        return inner(theta, op_th, do_dagger=True)

    def apply_local_op(self, op, i: int, canonicalize: bool = True) -> SimpleMPS:
        """Apply a single-site operator at site ``i``; returns a NEW SimpleMPS.

        ``op`` is a SymmetricTensor (codomain ``[p]``, domain ``[p]``). The result is
        NOT normalized (its norm is physical); with ``canonicalize`` (finite bc only)
        the canonical B form and Schmidt values are restored.
        """
        res = self.copy()
        op = op.relabelled(['p', 'p*'])
        B = permute_legs(self.Bs[i], codomain=['p'], domain=['vL', 'vR'])
        new_B = compose(op, B)  # codomain [p], domain [vL, vR]
        res.Bs[i] = permute_legs(new_B, codomain=['vL', 'p'], domain=['vR'])
        if canonicalize and self.bc == 'finite':
            res.canonicalize(normalize=False)
        return res


def _fix_lq_phases(Lf, Q):
    """Make L's diagonal real-positive (absorbing phases into Q).

    ``A = L Q`` with ``Lf`` [rows; new] and ``Q`` [new; cols]: rescale ``L <- L D^dagger``
    (columns) and ``Q <- D Q`` (rows), where ``D`` holds the phases of ``diag(L)``: the
    LQ mirror of :func:`~cyten_tpu_torch.algorithms.idmrg._fix_qr_phases`.
    """
    from .idmrg import _diag_phases

    lbl = Lf.labels[-1]
    D = _diag_phases(Lf, [lbl, f'{lbl}*'])
    Dc = complex_conj(D) if Lf.dtype.is_complex else D
    return scale_axis(Lf, Dc, -1), scale_axis(Q, D, 0)


def _as_scalar(res):
    if isinstance(res, Tensor):
        return item(res)
    return res


def split_truncate_theta(theta, chi_max: int, eps: float, normalize: bool = True,
                         pad_to_multiple: int = None, method: str = 'exact',
                         rng=None, Vh_prev=None, n_oversample: int = 16):
    """Split a two-site wavefunction and truncate.

    Parameters
    ----------
    theta
        Two-site wavefunction, labels [vL, p0, p1, vR] (any codomain/domain split).
    chi_max, eps
        Truncation: keep at most chi_max singular values, discard those below eps.
    pad_to_multiple
        Round the kept count of each sector up to a multiple of this (chi bucketing).
    method : 'exact' | 'randomized' | 'adaptive'
        'exact': the per-sector SVD of theta (``torch.linalg.svd``), truncated by
        host-side slices (:func:`~cyten_tpu_torch.tensors.adaptive.fused_truncated_svd`,
        as ``cyten_tpu`` takes it for its jit backends). 'randomized':
        the GEMM/QR randomized range finder
        (:func:`~cyten_tpu_torch.tensors.randomized.randomized_truncated_svd`).
        'adaptive': warm-started from ``Vh_prev`` with ``n_oversample`` columns of
        per-sector rank head-room
        (:func:`~cyten_tpu_torch.tensors.adaptive.adaptive_truncated_svd`), whose
        only SVD runs at the kept-rank size; 'exact' where ``Vh_prev`` is None.
    rng
        The numpy generator of the sketch methods' random columns.
    Vh_prev
        For ``method='adaptive'``: the previous right isometry, a ``B`` tensor with
        labels [vL, p, vR] or already shaped [kept | vR, p1].

    Returns
    -------
    A : left-isometric tensor, labels [vL, p0, vR]  (codomain [vL, p0], domain [vR])
    S : DiagonalTensor of singular values on the new bond
    B : right-isometric tensor, labels [vL, p1, vR] (codomain [vL, p1], domain [vR])
    err : truncation error
    """
    if method not in ('exact', 'randomized', 'adaptive'):
        raise ValueError(f'unknown method {method!r}')
    theta = permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    if method == 'adaptive' and Vh_prev is None:
        method = 'exact'
    if method == 'adaptive':
        if 'p' in Vh_prev.labels:  # a B tensor [vL, p | vR]: the Vh form
            Vh_prev = permute_legs(Vh_prev.relabelled({'p': 'p1'}),
                                   codomain=['vL'], domain=['vR', 'p1'])
        U, S, Vh, err, _ = adaptive_truncated_svd(
            theta, Vh_prev, chi_max=chi_max, svd_min=eps, n_oversample=n_oversample,
            new_labels=('vR', 'vL'), pad_to_multiple=pad_to_multiple, rng=rng,
            normalize_to=1. if normalize else None)
    elif method == 'randomized':
        U, S, Vh, err, _ = randomized_truncated_svd(
            theta, chi_max=chi_max, svd_min=eps, new_labels=['vR', 'vL'],
            pad_to_multiple=pad_to_multiple, rng=rng,
            normalize_to=1. if normalize else None)
    else:
        U, S, Vh, err, _ = fused_truncated_svd(
            theta, chi_max=chi_max, svd_min=eps, new_labels=('vR', 'vL'),
            pad_to_multiple=pad_to_multiple, normalize_to=1. if normalize else None)
    A = U.relabelled({'p0': 'p'})
    B = permute_legs(Vh, codomain=['vL', 'p1'], domain=['vR']).relabelled({'p1': 'p'})
    return A, S, B, err


def _register_mps_serialization():
    """SimpleMPS in the typed persistence schema (tools.hdf5_io / tools.checkpoint)."""
    from ..tools.hdf5_io import from_tree, register_tree_type

    register_tree_type(
        'SimpleMPS', SimpleMPS,
        lambda m: {'Bs': m.Bs, 'Ss': m.Ss, 'bc': m.bc},
        lambda tree: SimpleMPS(from_tree(tree['Bs']), from_tree(tree['Ss']),
                               bc=str(tree['bc'])))


_register_mps_serialization()
