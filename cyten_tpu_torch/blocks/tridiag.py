"""The Ritz problem of the fused Lanczos: lowest eigenpair of its tridiagonal matrix.

Not the port of a Pallas kernel: :func:`tridiagonal_ground_state` launches
``csrc/tridiag.cu``, which takes the place of ``jnp.linalg.eigh`` inside
``cyten_tpu``'s jitted fused Lanczos (``cyten_tpu/tensors/krylov_based.py:386-397``).
It reads nothing on the host, so a static bond update whose Lanczos ends in it can be
captured in a CUDA graph; ``torch.linalg.eigh`` on CUDA syncs to check its result.

:func:`tridiagonal_ground_state` takes the plain version,
:func:`tridiagonal_ground_state_plain`, only for tensors on the CPU. On CUDA it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ._kernels import call, count, function

__all__ = ['tridiagonal_ground_state', 'tridiagonal_ground_state_plain', 'MAX_N']

MAX_N = 64  # the kernel's one CTA holds at most this many Lanczos steps


def tridiagonal_ground_state_plain(alphas: torch.Tensor, betas: torch.Tensor):
    """``(E, coefficients)``, f64, of the fixed-length Lanczos matrix with diagonal
    ``alphas`` and couplings ``betas[:-1]``.

    A vanishing ``beta_k`` means the Krylov space closed at k, and the later alphas
    are garbage: their couplings are dropped and their diagonal entries shifted above
    the valid spectrum by a Gershgorin bound (not by a huge constant, which would
    spoil the eigensolver's accuracy). The eigenvector's largest-magnitude entry is
    made positive.
    """
    a, b = alphas.double(), betas.double()
    valid = torch.cumprod(torch.cat([torch.ones_like(b[:1]), (b[:-1] > 1e-12).double()]),
                          0).bool()
    bound = torch.where(valid, a, 0.).abs().max() + 2. * b.max() + 1.
    off = torch.where(valid[1:], b[:-1], 0.)
    T = torch.diag(torch.where(valid, a, bound)) + torch.diag(off, 1) + torch.diag(off, -1)
    evals, evecs = torch.linalg.eigh(T)
    v = evecs[:, 0]
    v = torch.where(v[v.abs().argmax()] < 0, -v, v)
    return evals[0], v


def tridiagonal_ground_state(alphas: torch.Tensor, betas: torch.Tensor):
    """``(E, coefficients)`` as :func:`tridiagonal_ground_state_plain` computes them:
    a 0-d f64 tensor and an f64 vector of ``N = len(alphas)`` entries, on the
    tensors' device. On CUDA one launch of ``csrc/tridiag.cu`` (``N <= MAX_N``),
    with no host sync; on the CPU the plain version."""
    if alphas.device.type == 'cpu' and betas.device.type == 'cpu':
        return tridiagonal_ground_state_plain(alphas, betas)
    if not (alphas.is_cuda and betas.device == alphas.device):
        raise NotImplementedError(f'tridiagonal_ground_state: no kernel for '
                                  f'{alphas.device} and {betas.device}')
    n = alphas.shape[0] if alphas.ndim == 1 else -1
    if n < 1 or betas.shape != alphas.shape or n > MAX_N:
        raise ValueError(f'tridiagonal_ground_state: need two vectors of 1 to {MAX_N} '
                         f'entries, got {tuple(alphas.shape)} and {tuple(betas.shape)}')
    if alphas.is_complex() or betas.is_complex():
        raise NotImplementedError('tridiagonal_ground_state: real Lanczos matrices only')
    ab = torch.stack([alphas, betas]).to(torch.float64).contiguous()
    out = torch.empty(n + 1, dtype=torch.float64, device=alphas.device)
    call(function('tridiag', 'cyten_tridiag_ground_state'),
         (ab.data_ptr(), n, out.data_ptr()), alphas.get_device(), 'tridiag')
    count(tridiagonal_ground_state)
    return out[0], out[1:]


tridiagonal_ground_state.launches = 0  # kernel launches, counted where it is launched
