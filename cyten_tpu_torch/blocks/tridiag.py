"""The Krylov problems of the fused Lanczos solvers, on the card.

Neither is the port of a Pallas kernel. :func:`tridiagonal_ground_state` (the lowest
eigenpair of the fixed-length Lanczos matrix) takes the place of ``jnp.linalg.eigh``
inside ``cyten_tpu``'s jitted fused Lanczos (``cyten_tpu/tensors/krylov_based.py:386-397``);
:func:`tridiagonal_evolve` (the coefficients of ``exp(delta T) e_0``) that of
``jnp.linalg.eigh`` and the phase product of its fused Lanczos evolution (``:458-460``).
Both launch ``csrc/tridiag.cu`` and read nothing on the host, so a static bond update
or a fused TDVP site step that ends in them can be captured in a CUDA graph;
``torch.linalg.eigh`` on CUDA syncs to check its result. The kernels read the Lanczos
scalars from the ``[2, N]`` buffer the fused Lanczos writes them into, in f64 or f32,
so nothing is gathered or cast before a launch.

Each wrapper takes its plain version (:func:`tridiagonal_ground_state_plain`,
:func:`tridiagonal_evolve_plain`) only for tensors on the CPU. On CUDA it launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from ._kernels import call, count, function

__all__ = ['tridiagonal_ground_state', 'tridiagonal_ground_state_plain',
           'tridiagonal_evolve', 'tridiagonal_evolve_plain', 'MAX_N']

MAX_N = 64  # the kernel's one warp holds two Lanczos steps a lane
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1}


def _masked_matrix(ab: torch.Tensor) -> torch.Tensor:
    """The f64 Lanczos matrix of ``ab`` as ``cyten_tpu``'s fused solvers build it: the
    diagonal ``ab[0]`` and couplings ``ab[1, :-1]``, where a vanishing ``beta_k`` means
    the Krylov space closed at k and the later alphas are garbage: their couplings are
    dropped and their diagonal entries shifted above the valid spectrum by a
    Gershgorin bound (not by a huge constant, which would spoil the eigensolver's
    accuracy)."""
    a, b = ab[0].double(), ab[1].double()
    valid = torch.cumprod(torch.cat([torch.ones_like(b[:1]), (b[:-1] > 1e-12).double()]),
                          0).bool()
    bound = torch.where(valid, a, 0.).abs().max() + 2. * b.max() + 1.
    off = torch.where(valid[1:], b[:-1], 0.)
    return torch.diag(torch.where(valid, a, bound)) + torch.diag(off, 1) + torch.diag(off, -1)


def _check_buffer(name: str, ab: torch.Tensor) -> int:
    """N of the ``[2, N]`` buffer ``ab`` on CUDA, which the kernel takes (raises else)."""
    if not ab.is_cuda:
        raise NotImplementedError(f'{name}: no kernel for {ab.device}')
    if ab.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f'{name}: the kernel takes float64 or float32, not '
                                  f'{ab.dtype}')
    n = ab.shape[1] if ab.ndim == 2 and ab.shape[0] == 2 else -1
    if not 1 <= n <= MAX_N:
        raise ValueError(f'{name}: need a [2, N] buffer with 1 <= N <= {MAX_N}, got '
                         f'{tuple(ab.shape)}')
    if not ab.is_contiguous():
        raise ValueError(f'{name}: the kernel takes a contiguous buffer')
    return n


def tridiagonal_ground_state_plain(ab: torch.Tensor):
    """``(E, coefficients)``, f64, of the fixed-length Lanczos matrix with diagonal
    ``ab[0]`` (the alphas) and couplings ``ab[1, :-1]`` (the betas).

    The matrix is masked where the Krylov space closed (:func:`_masked_matrix`). The
    eigenvector's largest-magnitude entry is made positive.
    """
    evals, evecs = torch.linalg.eigh(_masked_matrix(ab))
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
    n = _check_buffer('tridiagonal_ground_state', ab)
    out = torch.empty(n + 1, dtype=torch.float64, device=ab.device)
    call(function('tridiag', 'cyten_tridiag_ground_state'),
         (ab.data_ptr(), _DTYPE_CODE[ab.dtype], n, out.data_ptr()), ab.get_device(),
         'tridiag')
    count(tridiagonal_ground_state)
    return out[0], out[1:]


tridiagonal_ground_state.launches = 0  # kernel launches, counted where it is launched


def _is_complex(delta) -> bool:
    return complex(delta).imag != 0


def tridiagonal_evolve_plain(ab: torch.Tensor, delta, nrm0: torch.Tensor) -> torch.Tensor:
    """The N coefficients ``nrm0 V (exp(delta lambda) * V[0, :]^*)`` of the fixed-length
    Lanczos matrix of ``ab`` (masked where the Krylov space closed,
    :func:`_masked_matrix`; ``T = V diag(lambda) V^T``): ``nrm0 exp(delta T) e_0``,
    the reference's formula (``cyten_tpu/tensors/krylov_based.py:458-460``) with
    ``torch.linalg.eigh``. complex128 where ``delta`` has an imaginary part, else f64."""
    evals, evecs = torch.linalg.eigh(_masked_matrix(ab))
    if _is_complex(delta):
        phase = torch.exp(complex(delta) * evals.to(torch.complex128))
        evecs = evecs.to(torch.complex128)
    else:
        phase = torch.exp(float(complex(delta).real) * evals)
    return evecs @ (phase * evecs[0, :].conj()) * nrm0.to(evecs.dtype)


def tridiagonal_evolve(ab: torch.Tensor, delta, nrm0: torch.Tensor) -> torch.Tensor:
    """The coefficients of :func:`tridiagonal_evolve_plain` from the contiguous
    ``[2, N]`` f64 or f32 buffer ``ab`` (alphas, then betas, which are norms), the
    number ``delta`` (real, or complex in real time) and the 0-d start norm ``nrm0``
    of ``ab``'s dtype, both on one device: N entries, complex128 where ``delta`` has
    an imaginary part, else f64. On CUDA one launch of ``csrc/tridiag.cu``
    (``N <= MAX_N``), with no host sync; on the CPU the plain version."""
    if ab.device.type == 'cpu':
        return tridiagonal_evolve_plain(ab, delta, nrm0)
    n = _check_buffer('tridiagonal_evolve', ab)
    if nrm0.device != ab.device or nrm0.dtype != ab.dtype or nrm0.numel() != 1:
        raise ValueError('tridiagonal_evolve: nrm0 must be one number of ab\'s dtype on '
                         'its device')
    delta = complex(delta)
    cplx = _is_complex(delta)
    out = torch.empty(n, dtype=torch.complex128 if cplx else torch.float64,
                      device=ab.device)
    call(function('tridiag', 'cyten_tridiag_evolve'),
         (ab.data_ptr(), nrm0.data_ptr(), _DTYPE_CODE[ab.dtype], n, delta.real, delta.imag,
          int(cplx), out.data_ptr()), ab.get_device(), 'tridiag_evolve')
    count(tridiagonal_evolve)
    return out


tridiagonal_evolve.launches = 0  # kernel launches, counted where it is launched
