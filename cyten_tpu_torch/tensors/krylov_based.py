"""Lanczos ground-state search on tensors: host-driven, or fused with no host sync.

The counterpart of ``cyten_tpu/tensors/krylov_based.py``'s ``LanczosGroundState``,
``lanczos`` (:262) and the fused solver of static mode (``lanczos_fused``,
``fused_lanczos_impl``, ``_close_structure``; :270-404). The matvec runs on the
tensors' device. The host-driven solver reads every alpha and beta on the host and
stops when converged; the fused solver runs a fixed number of iterations whose
scalars stay on the device. Both solve the small Krylov eigenproblem with numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ._functions import inner, linear_combination, norm, scalar_multiply
from ._tensors import Tensor
from .sparse import LinearOperator

__all__ = ['KrylovBased', 'LanczosGroundState', 'lanczos', 'lanczos_fused',
           'fused_lanczos_impl']


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
    """Ground state of a hermitian operator via Lanczos. Returns (E0, psi0, N).

    ``options={'fused': True, 'N_max': N}`` runs :func:`lanczos_fused`."""
    if (options or {}).get('fused'):
        return lanczos_fused(H, psi0, options)
    return LanczosGroundState(H, psi0, options).run()


# --- fused (static-mode) Lanczos ---------------------------------------------------------


def _device_inner(a, b):
    """``Re <a|b>`` of two abelian tensors as a 0-d tensor on their device: the
    per-block products are summed there and nothing is read by the host (bf16
    blocks accumulate in f32)."""
    bb = a.backend.block_backend
    lookup = {tuple(r): n for n, r in enumerate(b.data.block_inds)}
    terms = [bb.inner(blk, b.data.blocks[lookup[tuple(r)]], do_dagger=True)
             for blk, r in zip(a.data.blocks, a.data.block_inds) if tuple(r) in lookup]
    if not terms:
        return torch.zeros((), dtype=torch.float64, device=bb.device)
    res = torch.stack(terms).sum()
    return res.real if res.is_complex() else res


def _device_norm(t):
    """Frobenius norm of an abelian tensor (block-sparse or diagonal) as a 0-d tensor
    on its device, with no host sync (bf16 blocks accumulate in f32)."""
    bb = t.backend.block_backend
    if not t.data.blocks:
        return torch.zeros((), dtype=torch.float64, device=bb.device)
    return torch.sqrt(torch.stack([bb.norm_sq(blk) for blk in t.data.blocks]).sum())


def _union_embed(t, other):
    """Embed `t` into the union of its and `other`'s block structure (zero-filled).

    Both must be SymmetricTensors on the same legs with BlockSparseData-style
    data (rows of block indices + a block list).
    """
    from ..backends.data import BlockSparseData

    a, b = t.data, other.data
    rows = {tuple(r): ('a', n) for n, r in enumerate(a.block_inds)}
    for n, r in enumerate(b.block_inds):
        rows.setdefault(tuple(r), ('b', n))
    bb = t.backend.block_backend
    blocks, inds = [], []
    for r, (src, n) in rows.items():
        if src == 'a':
            blocks.append(a.blocks[n])
        else:
            blocks.append(bb.zeros(bb.get_shape(b.blocks[n]), a.dtype))
        inds.append(r)
    data = BlockSparseData(blocks, np.array(inds, np.intp).reshape(len(inds), -1), a.dtype)
    res = t.copy(deep=False)
    res.data = data
    return res


def _structure_key(t):
    return t.data.block_inds.tobytes()


def _close_structure(H, psi0, max_rounds: int = 4):
    """Grow psi0's block structure until it is a fixed point of H.matvec, so that
    every Krylov vector of the fused solver has the same blocks."""
    psi = psi0
    for _ in range(max_rounds):
        w = H.matvec(psi)
        if _structure_key(w) == _structure_key(psi):
            return psi
        psi = _union_embed(psi, w)
    raise ValueError('matvec block structure did not close; cannot fuse')


def _tridiagonal_ground_state(alphas: np.ndarray, betas: np.ndarray):
    """Lowest eigenpair ``(E, coefficients)`` of the fixed-length Lanczos matrix.

    A vanishing ``beta_k`` means the Krylov space closed at k, and the later alphas
    are garbage: their couplings are dropped and their diagonal entries shifted above
    the valid spectrum by a Gershgorin bound (not by a huge constant, which would
    spoil the eigensolver's accuracy).
    """
    valid = np.cumprod(np.concatenate([[True], betas[:-1] > 1e-12])).astype(bool)
    a_v = np.where(valid, alphas, 0.)
    bound = np.max(np.abs(a_v)) + 2. * np.max(betas) + 1.
    off = np.where(valid[1:], betas[:-1], 0.)
    T = np.diag(np.where(valid, alphas, bound)) + np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    return float(evals[0]), evecs[:, 0]


def lanczos_fused(H, psi0: Tensor, options: dict = None) -> tuple[float, Tensor, int]:
    """Fixed-length Lanczos ground-state search with no host sync in its loop.

    Grows ``psi0``'s block structure to a fixed point of ``H.matvec`` (one extra
    matvec per round), then runs :func:`fused_lanczos_impl` for ``options['N_max']``
    (default 20) iterations. Returns ``(E0, psi0, N)``.
    """
    N = int((options or {}).get('N_max', 20))
    psi0 = _close_structure(H, psi0)
    E, theta = fused_lanczos_impl(H, psi0, N)
    return E, theta, N


def fused_lanczos_impl(H, psi0, N: int):
    """``N`` Lanczos iterations queued on the device, then one host sync.

    The counterpart of ``cyten_tpu``'s ``fused_lanczos_impl``, a ``lax.scan`` there.
    Here it is a Python loop whose scalars (alpha, beta, the 1/beta scale) stay 0-d
    tensors on the device, so the host never waits inside the loop. After the loop
    the alphas and betas are read in one sync, the N x N tridiagonal problem is
    solved on the host, and the Ritz vector is rebuilt from the stored basis (N
    state copies in device memory).

    ``psi0``'s block structure must be a fixed point of ``H.matvec`` (see
    :func:`_close_structure`). Returns ``(E, theta)``: E a host float, theta
    normalised.
    """
    v = scalar_multiply(1. / _device_norm(psi0), psi0)
    basis, alphas, betas = [], [], []
    v_prev = beta_prev = None
    for k in range(N):
        w = H.matvec(v)
        alpha = _device_inner(v, w)
        w = linear_combination(1., w, -alpha, v)
        if v_prev is not None:
            w = linear_combination(1., w, -beta_prev, v_prev)
        beta = _device_norm(w)
        basis.append(v)
        alphas.append(alpha)
        betas.append(beta)
        if k + 1 < N:
            # after Krylov closure (beta ~ 0) the next vector is zero, not w/tiny:
            # amplified roundoff would otherwise leak into the reconstruction
            scale = torch.where(beta > 1e-12, 1. / beta.clamp_min(1e-30), 0.)
            v_prev, v, beta_prev = v, scalar_multiply(scale, w), beta
    ab = torch.stack([torch.stack(alphas).double(), torch.stack(betas).double()])
    ab = ab.cpu().numpy()  # the solve's one host sync
    E, coeffs = _tridiagonal_ground_state(ab[0], ab[1])
    theta = scalar_multiply(float(coeffs[0]), basis[0])
    for c, b in zip(coeffs[1:], basis[1:]):
        theta = linear_combination(1., theta, float(c), b)
    theta = scalar_multiply(1. / _device_norm(theta).clamp_min(1e-30), theta)
    return E, theta
