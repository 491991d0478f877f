"""The Ritz problem of the fused Lanczos: lowest eigenpair of its tridiagonal matrix.

Not the port of a Pallas kernel: :func:`tridiagonal_ground_state` launches
``csrc/tridiag.cu``, which takes the place of ``jnp.linalg.eigh`` inside
``cyten_tpu``'s jitted fused Lanczos (``cyten_tpu/tensors/krylov_based.py:386-397``).
It reads nothing on the host, so a static bond update whose Lanczos ends in it can be
captured in a CUDA graph; ``torch.linalg.eigh`` on CUDA syncs to check its result.
The kernel reads the Lanczos scalars from the ``[2, N]`` buffer the fused Lanczos
writes them into, in f64 or f32, so nothing is gathered or cast before the launch.

:func:`tridiagonal_ground_state` takes the plain version,
:func:`tridiagonal_ground_state_plain`, only for tensors on the CPU. On CUDA it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ._kernels import call, count, function

__all__ = ['tridiagonal_ground_state', 'tridiagonal_ground_state_plain', 'MAX_N']

MAX_N = 64  # the kernel's one warp holds two Lanczos steps a lane
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}


def tridiagonal_ground_state_plain(ab: torch.Tensor):
    """``(E, coefficients)``, f64, of the fixed-length Lanczos matrix with diagonal
    ``ab[0]`` (the alphas) and couplings ``ab[1, :-1]`` (the betas).

    A vanishing ``beta_k`` means the Krylov space closed at k, and the later alphas
    are garbage: their couplings are dropped and their diagonal entries shifted above
    the valid spectrum by a Gershgorin bound (not by a huge constant, which would
    spoil the eigensolver's accuracy). The eigenvector's largest-magnitude entry is
    made positive.
    """
    a, b = ab[0].double(), ab[1].double()
    valid = torch.cumprod(torch.cat([torch.ones_like(b[:1]), (b[:-1] > 1e-12).double()]),
                          0).bool()
    bound = torch.where(valid, a, 0.).abs().max() + 2. * b.max() + 1.
    off = torch.where(valid[1:], b[:-1], 0.)
    T = torch.diag(torch.where(valid, a, bound)) + torch.diag(off, 1) + torch.diag(off, -1)
    evals, evecs = torch.linalg.eigh(T)
    v = evecs[:, 0]
    v = torch.where(v[v.abs().argmax()] < 0, -v, v)
    return evals[0], v


def tridiagonal_ground_state(ab: torch.Tensor):
    """``(E, coefficients)`` as :func:`tridiagonal_ground_state_plain` computes them
    from the contiguous ``[2, N]`` f64 or f32 buffer ``ab`` (alphas, then betas, which
    are norms): a 0-d f64 tensor and an f64 vector of N entries, on ``ab``'s device.
    On CUDA one launch of ``csrc/tridiag.cu`` (``N <= MAX_N``), with no host sync; on
    the CPU the plain version."""
    if ab.device.type == 'cpu':
        return tridiagonal_ground_state_plain(ab)
    if not ab.is_cuda:
        raise NotImplementedError(f'tridiagonal_ground_state: no kernel for {ab.device}')
    if ab.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f'tridiagonal_ground_state: the kernel takes float64 '
                                  f'or float32, not {ab.dtype}')
    n = ab.shape[1] if ab.ndim == 2 and ab.shape[0] == 2 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError(f'tridiagonal_ground_state: need a [2, N] buffer with 1 <= N <= '
                         f'{MAX_N}, got {tuple(ab.shape)}')
    if not ab.is_contiguous():
        raise ValueError('tridiagonal_ground_state: the kernel takes a contiguous buffer')
    out = torch.empty(n + 1, dtype=torch.float64, device=ab.device)
    call(function('tridiag', 'cyten_tridiag_ground_state'),
         (ab.data_ptr(), _DTYPE_CODE[ab.dtype], n, out.data_ptr()), ab.get_device(),
         'tridiag')
    count(tridiagonal_ground_state)
    return out[0], out[1:]


tridiagonal_ground_state.launches = 0  # kernel launches, counted where it is launched
