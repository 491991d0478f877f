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
    ChargedTensor, DiagonalTensor, SymmetricTensor, Tensor, compose, dagger, entropy,
    inner, item, norm, permute_legs, pinv, qr, scale_axis, svd, tdot, trace,
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
