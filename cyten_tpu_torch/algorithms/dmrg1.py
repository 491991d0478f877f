"""Single-site DMRG with subspace expansion (DMRG3S).

The counterpart of ``cyten_tpu/algorithms/dmrg1.py``: strictly single-site sweeps
following Hubig, McCulloch, Schollwoeck & Wolf, PRB 91, 155115 (2015). After each local
Lanczos optimization the bond is enlarged with the mixing term ``alpha * LP . theta . W``
(right moves; mirrored for left moves) before the truncating SVD, so the bond dimension
can grow even though only one site is optimized at a time. Cost per site is
O(chi^3 d w) instead of the two-site engine's O(chi^3 d^2 w).

The subspace-expansion bookkeeping is exact: with ``A~ = [theta, alpha*P]`` on an
enlarged bond and ``B~ = [[B], [0]]`` the global state is unchanged,
``A~ . B~ == theta . B``; the expansion only enriches what the truncating SVD of ``A~``
can keep. Every ``tdot`` and ``compose`` on the abelian backend runs its block products
as one grouped-GEMM kernel launch, as in the two-site engine.
"""

from __future__ import annotations

import numpy as np

from ..tensors import (
    SymmetricTensor, apply_mask, apply_mask_DiagonalTensor, combine_legs, compose,
    dagger, eigh, fuser_tensor, norm, permute_legs, pinv, scale_axis, sqrt, svd,
    svd_apply_mask, tdot, tensor_from_grid, truncate_singular_values,
)
from ..tensors.krylov_based import lanczos
from ..tensors.sparse import LinearOperator
from .dmrg import DMRGEngine, _with_precision
from .mps import SimpleMPS

__all__ = ['HEffective1', 'DMRG1SEngine']


def _heff1_matvec_impl(LP, RP, W, theta):
    """LP -- W -- RP applied to a one-site wavefunction [vL, p; vR]."""
    x = tdot(theta, LP, 'vL', 'vR')                    # [p, vR, vR*, wR]
    x = tdot(x, W, ['p', 'wR'], ['p*', 'wL'])          # [vR, vR*, p, wR]
    x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])        # [vR*, p, vL*]
    x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
    return permute_legs(x, codomain=['vL', 'p'], domain=['vR'])


class HEffective1(LinearOperator):
    """Effective single-site Hamiltonian ``LP -- W -- RP``.

    ``matmul_precision`` sets the precision of the matvec's f32 products
    (:func:`~cyten_tpu_torch.algorithms.dmrg._with_precision`); ``use_jit`` is accepted
    for ``cyten_tpu``'s signature and has no effect, as in
    :class:`~cyten_tpu_torch.algorithms.dmrg.HEffective`.
    """

    def __init__(self, LP, RP, W, use_jit: bool = None, matmul_precision: str = None):
        self.LP = LP
        self.RP = RP
        self.W = W
        self.use_jit = use_jit
        self.matmul_precision = matmul_precision
        self._matvec = _with_precision(_heff1_matvec_impl, matmul_precision)
        LinearOperator.__init__(self, dtype=W.dtype)

    def matvec(self, theta):
        return self._matvec(self.LP, self.RP, self.W, theta)


def _uses_pipes(backend) -> bool:
    """Abelian backends direct-sum pipe legs exactly (block_ind_map is a permutation of
    the public basis); fusion-tree backends need the explicit CG-aware fuser instead
    (the fused basis is not a permutation)."""
    from ..backends.fusion_tree import FusionTreeBackend

    return not isinstance(backend, FusionTreeBackend)


def _expansion_right(LP, W, theta, alpha):
    """Mixing term ``alpha * LP . theta . W`` as [vL, p; (vR.wR)].

    ``pipe_dualities=True`` makes the combined domain leg a ket space, matching the MPS
    bond-leg convention so it can direct-sum with theta's vR leg. On fusion-tree
    backends the combined leg is produced by an explicit unitary fuser isometry (flat
    ElementarySpace leg) instead of pipe metadata."""
    t = tdot(LP, theta, 'vR', 'vL')                     # [vR*, wR, p, vR]
    t = tdot(t, W, ['p', 'wR'], ['p*', 'wL'])           # [vR*, vR, p, wR]
    t = t.relabelled({'vR*': 'vL'})
    t = permute_legs(t, codomain=['vL', 'p'], domain=['wR', 'vR'])
    if _uses_pipes(t.backend):
        t = combine_legs(t, ['vR', 'wR'], pipe_dualities=True)
    else:
        S = fuser_tensor(t.domain.factors, backend=t.backend, dtype=t.dtype,
                         labels=[t.domain_labels[0], t.domain_labels[1], 'vR'])
        t = compose(t, S)
    return alpha * t


def _expansion_left(RP, W, theta, alpha):
    """Mixing term ``alpha * theta . W . RP`` as [(vL.wL); vR, p]."""
    t = tdot(theta, RP, 'vR', 'vL')                     # [vL, p, wL, vL*]
    t = tdot(t, W, ['p', 'wL'], ['p*', 'wR'])           # [vL, vL*, wL, p]
    t = t.relabelled({'vL*': 'vR'})
    t = permute_legs(t, codomain=['vL', 'wL'], domain=['vR', 'p'])
    if _uses_pipes(t.backend):
        t = combine_legs(t, ['vL', 'wL'])
    else:
        # dagger primes the labels, so 'vL*' below becomes the result's 'vL'
        S = fuser_tensor(t.codomain.factors, backend=t.backend, dtype=t.dtype,
                         labels=[t.codomain_labels[0], t.codomain_labels[1], 'vL*'])
        t = compose(dagger(S), t)
    return alpha * t


class DMRG1SEngine(DMRGEngine):
    """Strictly single-site DMRG sweeps with subspace expansion.

    The options of :class:`DMRGEngine` that ``cyten_tpu``'s one-site engine takes
    (``mesh=`` raises, as there); dynamic sweeps only. The mixing:

    - ``alpha``: initial expansion amplitude (default 1e-3),
    - ``alpha_decay``: multiplied onto alpha after every sweep (default 0.5),
    - ``alpha_min``: expansion switched off below this (default 1e-12),
    - ``mixer``: ``'expand'`` enlarges the bond with the mixing term directly (exact
      bookkeeping; the combined bond.mpo leg uses pipe metadata on abelian backends and
      an explicit unitary fuser isometry on fusion-tree backends, so non-abelian
      symmetries work too) or ``'density_matrix'`` (White's perturbation:
      eigendecompose ``theta theta^† + P P^†`` on the [vL, p] side, for every symmetry
      backend including anyonic). Default: ``'expand'`` for symmetric braiding
      (abelian, fermions, SU(2)), else ``'density_matrix'``.
    """

    def __init__(self, psi: SimpleMPS, model, chi_max: int = 32, eps: float = 1e-12,
                 lanczos_options: dict = None, pad_chi_multiple: int = None,
                 jit_env_updates: bool = None, mesh=None,
                 shard_axis_name: str = 'mult', alpha: float = 1e-3,
                 alpha_decay: float = 0.5, alpha_min: float = 1e-12,
                 mixer: str = None, matmul_precision: str = None):
        DMRGEngine.__init__(self, psi, model, chi_max=chi_max, eps=eps,
                            lanczos_options=lanczos_options,
                            pad_chi_multiple=pad_chi_multiple,
                            jit_env_updates=jit_env_updates, mesh=mesh,
                            shard_axis_name=shard_axis_name,
                            matmul_precision=matmul_precision)
        self.alpha = alpha
        self.alpha_decay = alpha_decay
        self.alpha_min = alpha_min
        if mixer is None:
            sym = psi.Bs[0].symmetry
            mixer = 'expand' if sym.has_symmetric_braid else 'density_matrix'
        if mixer not in ('expand', 'density_matrix'):
            raise ValueError(f'unknown mixer {mixer!r}')
        self.mixer = mixer

    def sweep(self) -> float:
        L = self.psi.L
        for i in range(L - 1):
            self.update_site(i, move_right=True)
        for i in range(L - 1, 0, -1):
            self.update_site(i, move_right=False)
        if self.alpha > self.alpha_min:
            self.alpha = max(self.alpha * self.alpha_decay, self.alpha_min)
        return self.E

    def run(self, n_sweeps: int = 10, tol: float = 1e-10, verbose: bool = False
            ) -> float:
        """Sweep until the energy is converged AND the mixing has decayed.

        The Lanczos energy converges before the state does (each sweep still injects an
        O(alpha) perturbation), so convergence additionally requires
        ``alpha <= alpha_min``."""
        E_old = np.inf
        for sweep in range(n_sweeps):
            E = self.sweep()
            if verbose:
                print(f'sweep {sweep + 1}: E = {E:.12f}, '
                      f'max chi = {self.psi.max_chi()}, alpha = {self.alpha:.2e}')
            if abs(E - E_old) < tol and self.alpha <= self.alpha_min:
                break
            E_old = E
        return self.E

    def update_site(self, i: int, move_right: bool):
        psi = self.psi
        W = self.model.H_mpo[i]
        Heff = HEffective1(self.LPs[i], self.RPs[i], W,
                           matmul_precision=self.matmul_precision)
        E, theta, n_iter = lanczos(Heff, psi.get_theta1(i), self.lanczos_options)
        self.E = E
        if self.mixer == 'density_matrix' and self.alpha > self.alpha_min:
            if move_right:
                self._move_right_dm(i, theta)
            else:
                self._move_left_dm(i, theta)
        elif move_right:
            self._move_right(i, theta)
        else:
            self._move_left(i, theta)

    def _truncate(self, S):
        """The mask of the kept values of ``S``, its error and the kept norm."""
        mask, err, new_norm = truncate_singular_values(
            S, chi_max=self.chi_max, svd_min=self.eps,
            pad_to_multiple=self.pad_chi_multiple)
        self.trunc_err = max(self.trunc_err, err)
        return mask, new_norm

    def _move_right(self, i: int, theta):
        psi = self.psi
        theta = permute_legs(theta, codomain=['vL', 'p'], domain=['vR'])
        expand = self.alpha > self.alpha_min
        if expand:
            P = _expansion_right(self.LPs[i], self.model.H_mpo[i], theta, self.alpha)
            theta_exp = tensor_from_grid([[theta, P]], row_leg='vL', col_leg='vR')
        else:
            theta_exp = theta
        U, S, Vh = svd(theta_exp, new_labels=['vR', 'vL'])
        mask, new_norm = self._truncate(S)
        U, S, Vh = svd_apply_mask(U, S, Vh, mask)
        S = (1. / new_norm) * S
        A = U  # [vL, p; vR], left-isometric
        # Bs[i+1] <- Vh . [[B], [0]]; exact: the zero rows carry the expansion
        B_next = psi.Bs[i + 1]
        if expand:
            B_next = self._stacked_B(B_next, P.domain.factors[0], stack_on='vL')
        psi.Bs[i + 1] = permute_legs(tdot(Vh, B_next, 'vR', 'vL'),
                                     codomain=['vL', 'p'], domain=['vR'])
        psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
        Sinv = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        self.update_LP(i, A)

    def _move_left(self, i: int, theta):
        psi = self.psi
        theta = permute_legs(theta, codomain=['vL'], domain=['vR', 'p'])
        expand = self.alpha > self.alpha_min
        if expand:
            P = _expansion_left(self.RPs[i], self.model.H_mpo[i], theta, self.alpha)
            theta_exp = tensor_from_grid([[theta], [P]], row_leg='vL', col_leg='vR')
        else:
            theta_exp = theta
        U, S, Vh = svd(theta_exp, new_labels=['vR', 'vL'])
        mask, new_norm = self._truncate(S)
        U, S, Vh = svd_apply_mask(U, S, Vh, mask)
        S = (1. / new_norm) * S
        B = permute_legs(Vh, codomain=['vL', 'p'], domain=['vR'])  # right-isometric
        psi.Bs[i] = B
        # Bs[i-1] is stored in B form as S_{i-1}^-1 A_{i-1} S_i^old, so absorbing the
        # carry U S into it first strips the old bond values: theta1(i-1) comes out as
        # A_{i-1} . U|_old . S (the centre of the unchanged global state)
        Sinv_old = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Ss[i] = S.relabelled(['vL', 'vL*'])
        # Bs[i-1] <- (B_{i-1} S_old^-1, 0-padded) . U . S; the zero columns kill the
        # expansion rows of U exactly
        B_prev = scale_axis(psi.Bs[i - 1], Sinv_old, 'vR')
        if expand:
            B_prev = self._stacked_B(B_prev, P.codomain.factors[0], stack_on='vR')
        carry = scale_axis(U, S, 'vR')
        psi.Bs[i - 1] = tdot(B_prev, carry, 'vR', 'vL')
        self.update_RP(i, B)

    def _move_right_dm(self, i: int, theta):
        """Right move with White's density-matrix mixer (any symmetry backend).

        rho = theta theta^† + P P^† on [vL, p]; its top-chi eigenvectors define the new
        left isometry A. P is the mixing term with (wR, vR) left open: no leg
        combination or direct sum is formed, so this path also works for non-abelian
        and anyonic symmetries. The eigenvectors (``torch.linalg.eigh`` per sector) are
        fixed up to a phase, and within degenerate sectors up to a rotation."""
        psi = self.psi
        theta = permute_legs(theta, codomain=['vL', 'p'], domain=['vR'])
        rho = compose(theta, dagger(theta))
        t = tdot(self.LPs[i], theta, 'vR', 'vL')            # [vR*, wR, p, vR]
        t = tdot(t, self.model.H_mpo[i], ['p', 'wR'], ['p*', 'wL'])
        P = self.alpha * permute_legs(t.relabelled({'vR*': 'vL'}),
                                      codomain=['vL', 'p'], domain=['wR', 'vR'])
        rho = rho + compose(P, dagger(P))
        W, V = eigh(rho, new_labels='c')                     # V: [vL, p; c]
        S = sqrt(abs(W))
        mask, new_norm = self._truncate(S)
        A = apply_mask(V, mask, 'c').relabelled({'c': 'vR'})  # [vL, p; vR]
        S = (1. / new_norm) * apply_mask_DiagonalTensor(S, mask)
        carry = compose(dagger(A), theta)                    # [vR*; vR]
        carry = carry.relabelled({'vR*': 'vL'})
        carry = (1. / norm(carry)) * carry
        S = S.relabelled(['vL', 'vL*'])
        psi.Bs[i + 1] = permute_legs(
            tdot(scale_axis(carry, pinv(S, cutoff=1e-14), 'vL'), psi.Bs[i + 1],
                 'vR', 'vL'),
            codomain=['vL', 'p'], domain=['vR'])
        psi.Ss[i + 1] = S
        Sinv = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        self.update_LP(i, A)

    def _move_left_dm(self, i: int, theta):
        """Left move with the density-matrix mixer (mirror of _move_right_dm)."""
        psi = self.psi
        theta = permute_legs(theta, codomain=['vL'], domain=['vR', 'p'])
        rho = compose(dagger(theta), theta)
        t = tdot(theta, self.RPs[i], 'vR', 'vL')             # [vL, p, wL, vL*]
        t = tdot(t, self.model.H_mpo[i], ['p', 'wL'], ['p*', 'wR'])
        P = self.alpha * permute_legs(t.relabelled({'vL*': 'vR'}),
                                      codomain=['vL', 'wL'], domain=['vR', 'p'])
        rho = rho + compose(dagger(P), P)
        W, V = eigh(rho, new_labels='c')                     # V: [.; c] on (vR, p)
        S = sqrt(abs(W))
        mask, new_norm = self._truncate(S)
        V = apply_mask(V, mask, 'c')
        S = (1. / new_norm) * apply_mask_DiagonalTensor(S, mask)
        B = dagger(V).relabelled({'c*': 'vL'})               # [vL; vR, p]
        B = permute_legs(B, codomain=['vL', 'p'], domain=['vR'])
        carry = compose(theta, V).relabelled({'c': 'vR'})    # [vL; vR]
        carry = (1. / norm(carry)) * carry
        Sinv_old = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = B
        psi.Ss[i] = S.relabelled(['vL', 'vL*'])
        B_prev = scale_axis(psi.Bs[i - 1], Sinv_old, 'vR')
        psi.Bs[i - 1] = permute_legs(tdot(B_prev, carry, 'vR', 'vL'),
                                     codomain=['vL', 'p'], domain=['vR'])
        self.update_RP(i, B)

    def _stacked_B(self, B, X, stack_on: str):
        """Stack ``B`` with a zero tensor carrying the expansion leg ``X``.

        ``X`` is the combined (bond.mpo) leg of the mixing term P itself, so the stacked
        direct sum is identical (including internal basis order) to the enlarged bond of
        ``theta_exp = [theta, P]``. For right moves (stack_on='vL') returns
        [[B], [0_X]]; for left moves [[B, 0_X]].
        """
        Xe = X.as_ElementarySpace(is_dual=False)
        if stack_on == 'vL':
            Z = SymmetricTensor.from_zero(
                [Xe, B.get_leg_co_domain('p')], [B.domain.factors[0]],
                backend=B.backend, labels=['vL', 'p', 'vR'], dtype=B.dtype)
            return tensor_from_grid([[B], [Z]], row_leg='vL', col_leg='vR')
        Z = SymmetricTensor.from_zero(
            [B.get_leg_co_domain('vL'), B.get_leg_co_domain('p')], [Xe],
            backend=B.backend, labels=['vL', 'p', 'vR'], dtype=B.dtype)
        return tensor_from_grid([[B, Z]], row_leg='vL', col_leg='vR')
