"""Steady-state truncated SVD: GEMMs, thin QR and small rotations, warm-started.

The counterpart of ``cyten_tpu/tensors/steady.py``. A converged DMRG sweep revisits
each bond with a slightly rotated theta, and in static mode the kept per-sector
multiplicities are frozen, so the right isometry of the previous visit (the current
``B`` tensor) is a good warm start. This module computes the rank-frozen truncated
SVD

    theta  ~=  U S Vh     (U, Vh isometric; S positive diagonal)

in four steps:

1. subspace (power) iteration from the warm start:  V <- qr(theta^dag theta V)
2. Rayleigh-Ritz:  T = (theta V)^dag (theta V), nearly diagonal
3. first-order Jacobi sweeps per sector: R ~= qr(I + E/(D_j - D_i)); degenerate
   clusters stay mixed, which is harmless (any orthonormal basis of a degenerate
   cluster is a valid singular basis)
4. U = theta V S^+, polished to an isometry by Newton-Schulz (GEMMs only); a block
   the polish leaves far from one is replaced by its thin QR
   (``_orthonormal_columns``)

Every ``compose`` is one grouped-GEMM launch on the abelian backend; the QRs go to
``torch.linalg.qr``. Nothing here reads a value on the host, so on the card the
whole SVD queues without a host sync apart from what the QRs themselves need.
The subspace converges to the dominant singular subspace at rate
``(sigma_{k+1} / sigma_k)^2`` per power iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import Dtype
from ._functions import compose, dagger, linear_combination, qr, scale_axis
from ._tensors import DiagonalTensor, SymmetricTensor
from .krylov_based import _device_norm

__all__ = ['steady_truncated_svd']


def _rotation_blocks(T, n_jacobi: int, eps: float):
    """Per-sector cleanup rotations diagonalising the nearly diagonal PSD ``T``.

    Returns (rotation blocks [kept -> kept], diagonal entries of the rotated T).
    bf16 blocks are rotated in f32 and cast back (the factorisation policy of the
    block backends); the outputs keep the storage dtype, S included, since a wider S
    would promote B again through ``scale_axis`` downstream.
    """
    half = T.dtype == Dtype.bfloat16
    R_blocks = []
    diags = []
    for blk in T.data.blocks:
        k = blk.shape[0]
        if k == 0:
            R_blocks.append(blk)
            diags.append(blk[:0, 0])
            continue
        Tc = blk.float() if half else blk
        R_tot = None
        for _ in range(n_jacobi):
            D = torch.diagonal(Tc)
            E = Tc - torch.diag(D)
            den = D[None, :] - D[:, None]
            scale = torch.max(torch.abs(D)) + 1e-30
            safe = torch.abs(den) > eps * scale
            W = torch.where(safe, E / torch.where(safe, den, 1.), 0.)
            Q, _ = torch.linalg.qr(torch.eye(k, dtype=W.dtype, device=W.device) + W)
            Tc = Q.conj().T @ Tc @ Q
            R_tot = Q if R_tot is None else R_tot @ Q
        if R_tot is None:
            R_tot = torch.eye(k, dtype=Tc.dtype, device=Tc.device)
        d = torch.diagonal(Tc)
        if half:
            R_tot = R_tot.to(torch.bfloat16)
            d = d.to(torch.bfloat16)
        R_blocks.append(R_tot)
        diags.append(d)
    return R_blocks, diags


def _orthonormal_columns(U, S):
    """``U`` where its columns are orthonormal (or zero) to 0.1 in every sector;
    else its orthonormal factor, by a QR that takes the columns in the order of the
    values ``S`` (the largest first, so that the dominant columns stay as they are and
    the others lose what they share with them), each column of Q turned by the phase
    of R's diagonal, a zero column (a value the pseudo-inverse dropped) kept zero.

    Newton-Schulz converges only for singular values of ``U`` below sqrt(3). Where the
    Jacobi step leaves a cluster of small values mixed (they count as degenerate
    against the largest value of their sector), their columns of ``B S^+`` carry what
    the warm start left of the dominant directions, divided by a small value: they are
    far from orthogonal, the polish cannot repair them, and the left isometry of a
    static bond update then blows up the next environment (a spin-1 chain at chi 1024:
    E to -1e15 within one sweep). The choice is made on the device, so nothing is read
    on the host and the update can still be captured in a graph.

    Q alone would not do: where the polish holds but has not converged (a warm start
    far from theta's subspace, one or two polish steps), U is near an isometry but not
    one to rounding, and Q then differs from it by as much. Such a U is
    ``cyten_tpu``'s, which the parity tests hold entry by entry
    (``tests/test_torch_static.py``, ``tests/test_torch_bench.py``'s Hubbard step).
    """
    from ..backends.data import BlockSparseData, DiagonalBlockData

    if not U.data.blocks:
        return U
    # P: the permutation of each sector's columns that sorts its values, largest first
    dtype = U.data.blocks[0].dtype
    perms = [torch.eye(len(s), dtype=dtype, device=s.device)[
        :, torch.argsort(s.real, descending=True)] for s in S.data.blocks]
    kept = S.leg
    rows = np.stack([S.data.block_inds, S.data.block_inds], axis=1)
    P = SymmetricTensor(BlockSparseData(perms, rows, U.data.dtype, is_sorted=True),
                        [kept], [kept], U.backend, ['a', 'b'])
    Q, R = qr(compose(U, P))
    if Q.domain != U.domain:  # a sector with fewer rows than columns: no isometry
        return U
    phases = []
    for blk in R.data.blocks:
        d = torch.diagonal(blk)
        mag = torch.abs(d)
        phases.append(torch.where(mag > 0, d / torch.where(mag > 0, mag, 1.), 0.))
    Ph = DiagonalTensor(DiagonalBlockData(phases, R.data.block_inds[:, 0].copy(),
                                          R.data.dtype, is_sorted=True),
                        Q.domain.factors[0], U.backend, ['a', 'a*'])
    Q = compose(scale_axis(Q, Ph, -1), dagger(P))
    Q.labels = U.labels
    G = compose(dagger(U), U)
    dev = []
    for blk in G.data.blocks:
        live = torch.diagonal(blk).real > 0.5
        dev.append(torch.amax(torch.abs(blk - torch.diag(live.to(blk.dtype)))))
    bad = (torch.stack(dev).amax() > 0.1).to(dev[0].dtype)
    # U + bad (Q - U): Q where the polish failed, U itself where it held
    return linear_combination(1., U, bad, linear_combination(1., Q, -1., U))


def _with_kept_sectors(T, V):
    """``T`` with a zero block for each sector of the kept leg that ``V`` holds and
    ``T`` lacks.

    A sector of the frozen allocation in which theta has no block (one kept with
    zero weight: eps=0 keeps zero singular values) gets no block in ``thp V`` and so
    none in ``T``. Without one there, the sector would drop out of S and of the
    rotated V, and Vh would stop being an isometry on it. With a zero block its
    singular values are zero, its rotation the identity and its right vectors V's
    own. (``cyten_tpu``'s steady SVD, ``tensors/steady.py:126``, drops it.)
    """
    from ..backends.data import BlockSparseData

    have = set(T.data.block_inds[:, 0].tolist())
    missing = {}  # kept-sector index -> multiplicity, as V's blocks index the kept leg
    for row, blk in zip(V.data.block_inds, V.data.blocks):
        if int(row[-1]) not in have:
            missing[int(row[-1])] = blk.shape[-1]
    if not missing:
        return T
    bb = T.backend.block_backend
    blocks = list(T.data.blocks) + [bb.zeros((m, m), T.data.dtype) for m in missing.values()]
    rows = np.concatenate([T.data.block_inds,
                           np.repeat(np.array(list(missing), np.intp)[:, None], 2, axis=1)])
    order = np.argsort(rows[:, 0], kind='stable')
    data = BlockSparseData([blocks[k] for k in order], rows[order], T.data.dtype,
                           is_sorted=True)
    return SymmetricTensor(data, T.codomain, T.domain, T.backend, T.labels)


def steady_truncated_svd(thp, Vh_prev, n_power: int = 1, n_jacobi: int = 2,
                         ns_polish: int = 2, eps: float = 1e-6,
                         new_labels=('vR', 'vL')):
    """Truncated SVD of ``thp`` with the rank allocation (and warm start) of
    ``Vh_prev``.

    Parameters
    ----------
    thp : SymmetricTensor
        The wavefunction as a morphism codomain -> domain (e.g. [vL, p0 | vR, p1]).
    Vh_prev : SymmetricTensor
        Right isometry from the previous visit: codomain [kept], domain =
        ``thp.domain``. Its codomain leg fixes the kept per-sector multiplicities
        (static-mode chi allocation).
    n_power, n_jacobi, ns_polish, eps
        Iteration counts of the three cleanup stages and the relative gap below
        which two values count as degenerate; the defaults suffice near convergence.

    Returns
    -------
    U : SymmetricTensor   codomain = thp.codomain, domain [kept]
    S : DiagonalTensor    on the kept leg (unnormalised)
    Vh : SymmetricTensor  codomain [kept], domain = thp.domain
    err : 0-d tensor      relative discarded weight sqrt(1 - |S|^2 / |thp|^2)
    """
    from ..backends.data import BlockSparseData, DiagonalBlockData

    backend = thp.backend
    V = dagger(Vh_prev)                       # domain -> kept   (as morphism)
    # subspace iteration toward the dominant right-singular subspace
    for _ in range(n_power):
        B = compose(thp, V)                   # [codomain | kept]
        Z = compose(dagger(thp), B)           # [domain | kept]
        V, _ = qr(Z)
    B = compose(thp, V)
    T = _with_kept_sectors(compose(dagger(B), B), V)  # [kept | kept], nearly diagonal
    R_blocks, diag_vals = _rotation_blocks(T, n_jacobi, eps)
    R_data = BlockSparseData(R_blocks, T.data.block_inds.copy(), T.data.dtype,
                             is_sorted=True)
    R = SymmetricTensor(R_data, T.codomain, T.domain, backend, T.labels)
    B = compose(B, R)
    V = compose(V, R)
    kept_leg = V.domain.factors[0]
    # singular values: sqrt of the (cleaned) Rayleigh quotients
    s_blocks = [torch.sqrt(torch.clamp_min(d.real, 0.)) for d in diag_vals]
    diag_inds = np.array([int(i) for i, _ in T.data.block_inds], dtype=np.intp)
    S_data = DiagonalBlockData(s_blocks, diag_inds, T.data.dtype.to_real, is_sorted=True)
    S = DiagonalTensor(S_data, kept_leg, backend, [new_labels[1], f'{new_labels[1]}*'])
    # U = B S^+  (then Newton-Schulz polish back to exact isometry). The
    # pseudo-inverse drops the values whose weight s^2 is below the working
    # precision relative to the largest, s < sqrt(eps) * s_max: their columns of B
    # are roundoff, 1/s would blow it up past what the polish can repair, and U
    # would stop being an isometry. Their columns of U are zero, as for s = 0.
    # (cyten_tpu cuts at an absolute 1e-30, steady.py:144, and loses the isometry
    # on such spectra: ROADMAP.md Queue 3.)
    s_max = torch.stack([b.max() for b in s_blocks if b.numel()]).max()
    cut = s_max * torch.finfo(s_max.dtype).eps ** 0.5
    inv_blocks = [torch.where(b > cut, 1. / torch.where(b > cut, b, 1.), 0.)
                  for b in s_blocks]
    Sinv = DiagonalTensor(
        DiagonalBlockData(inv_blocks, diag_inds.copy(), S.data.dtype, is_sorted=True),
        kept_leg, backend, S.labels)
    U = scale_axis(B, Sinv, -1)
    for _ in range(ns_polish):
        G = compose(dagger(U), U)
        U = linear_combination(1.5, U, -0.5, compose(U, G))
    U = _orthonormal_columns(U, S)
    Vh = dagger(V)
    U = U.relabelled({U.labels[-1]: new_labels[0]})
    Vh = Vh.relabelled({Vh.labels[0]: new_labels[1]})
    ratio = _device_norm(S) ** 2 / _device_norm(thp) ** 2
    err = torch.sqrt(torch.clamp_min(1. - ratio, 0.))
    return U, S, Vh, err
