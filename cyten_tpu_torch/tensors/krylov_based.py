"""Host-driven Lanczos ground-state search on tensors.

The counterpart of ``cyten_tpu/tensors/krylov_based.py``'s ``LanczosGroundState`` and
``lanczos`` (:262). The matvec runs on the tensors' device; the small
(N_max x N_max) Krylov eigenproblem is solved host-side with numpy — it is tiny and
controls data-dependent convergence decisions.
"""

from __future__ import annotations

import numpy as np

from ._functions import inner, norm, scalar_multiply
from ._tensors import Tensor
from .sparse import LinearOperator

__all__ = ['KrylovBased', 'LanczosGroundState', 'lanczos']


class KrylovBased:
    """Shared machinery for Krylov-subspace algorithms.

    Options (passed as dict, like the reference's): N_min, N_max, P_tol, E_tol,
    min_gap, cutoff, reortho.
    """

    def __init__(self, H: LinearOperator, psi0: Tensor, options: dict = None):
        self.H = H
        self.psi0 = psi0
        options = options or {}
        self.N_min = options.get('N_min', 3)
        self.N_max = options.get('N_max', 20)
        # None disables the energy-difference criterion (default: the
        # previous np.inf default made |E - E_old| < E_tol ALWAYS true, so
        # every solve silently stopped at N_min iterations)
        self.E_tol = options.get('E_tol', None)
        self.P_tol = options.get('P_tol', 1e-14)
        self.min_gap = options.get('min_gap', 1e-12)
        self.cutoff = options.get('cutoff', 1e-12)
        self.reortho = options.get('reortho', False)


class LanczosGroundState(KrylovBased):
    """Lanczos ground-state search for hermitian operators."""

    def run(self) -> tuple[float, Tensor, int]:
        """Returns ``(E0, psi0, N_iterations)``."""
        H, psi = self.H, self.psi0
        psi_norm = norm(psi)
        assert psi_norm > 0, 'zero initial vector'
        q = scalar_multiply(1. / psi_norm, psi)
        basis = [q]
        alphas: list[float] = []
        betas: list[float] = []
        E_old = None
        theta = None
        for k in range(self.N_max):
            w = H.matvec(basis[-1])
            alpha = float(np.real(inner(basis[-1], w)))
            alphas.append(alpha)
            w = w - scalar_multiply(alpha, basis[-1])
            if len(basis) > 1:
                w = w - scalar_multiply(betas[-1], basis[-2])
            if self.reortho:
                for b in basis[:-1]:
                    w = w - scalar_multiply(inner(b, w), b)
            beta = norm(w)
            # solve the small tridiagonal problem
            T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
            evals, evecs = np.linalg.eigh(T)
            E = evals[0]
            v0 = evecs[:, 0]
            converged = False
            if beta < self.cutoff:
                converged = True
            if k + 1 >= self.N_min:
                if self.E_tol is not None and E_old is not None \
                        and abs(E - E_old) < self.E_tol:
                    converged = True
                # Ritz residual estimate: |beta * v0[-1]|
                if abs(beta * v0[-1]) ** 2 < self.P_tol:
                    converged = True
            E_old = E
            if converged or k == self.N_max - 1:
                theta = scalar_multiply(complex(v0[0]) if np.iscomplexobj(v0)
                                        else float(v0[0]), basis[0])
                for coeff, b in zip(v0[1:], basis[1:]):
                    theta = theta + scalar_multiply(
                        complex(coeff) if np.iscomplexobj(v0) else float(coeff), b)
                theta_norm = norm(theta)
                if theta_norm > 0:
                    theta = scalar_multiply(1. / theta_norm, theta)
                return float(E), theta, k + 1
            betas.append(float(beta))
            basis.append(scalar_multiply(1. / beta, w))
        raise RuntimeError('unreachable')


def lanczos(H: LinearOperator, psi0: Tensor, options: dict = None
            ) -> tuple[float, Tensor, int]:
    """Ground state of a hermitian operator via Lanczos. Returns (E0, psi0, N)."""
    if (options or {}).get('fused'):
        raise NotImplementedError('fused (static-mode) Lanczos is not ported yet')
    return LanczosGroundState(H, psi0, options).run()
