"""Finite matrix-product states in right-canonical (B) form.

The counterpart of ``cyten_tpu/algorithms/mps.py``: ``SimpleMPS`` (product, singlet
and fusion-pair states, two-site wavefunctions, bond expectation values) and
``split_truncate_theta`` (:664) with the exact per-sector SVD. All contractions are
label-based ``tdot`` and ``compose`` calls.

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
    DiagonalTensor, SymmetricTensor, compose, inner, permute_legs, scale_axis, tdot,
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

    def bond_dimensions(self) -> list[int]:
        return [int(B.get_leg_co_domain('vL').dim) for B in self.Bs] \
            + [int(self.Bs[-1].domain.factors[0].dim)]

    def max_chi(self) -> int:
        return max(self.bond_dimensions())


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
