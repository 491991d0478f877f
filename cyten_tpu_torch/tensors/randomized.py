"""Randomized truncated SVD: the growth-phase complement to ``tensors/steady.py``.

The counterpart of ``cyten_tpu/tensors/randomized.py``. When only the top ``chi``
singular triplets are needed (DMRG truncation with ``chi_max`` well below the block
dimensions), the randomized range finder [Halko, Martinsson & Tropp, SIAM Rev. 53,
217 (2011)] computes them with GEMMs, thin QRs and one *small* SVD:

    1. sketch        Y = A Ω,      Ω random with ~(chi + p) columns per sector
    2. power iters   Y <- A (A† Q),  Q = qr(Y)      (sharpen the spectrum)
    3. project       B = Q† A       (small: (chi+p) x n per sector)
    4. small SVD     B = U_B S Vh,  U = Q U_B

Everything is written with tensor operations (compose, qr, svd), so the per-sector
sketch sizes follow from the symmetry structure, and on the abelian backend every
GEMM is one grouped-GEMM launch. The tail weight missed by the sketch is accounted
exactly via ||A||^2 - ||S||^2, so the reported truncation error is an upper bound.

Ω is drawn with ``SymmetricTensor.from_random_normal(..., rng=)`` from a numpy
generator, block by block in the order ``cyten_tpu`` draws them: the same generator
gives both packages the same Ω. ``cyten_tpu`` runs the range finder as one
``jax.jit`` program (``_get_jitted_range_finder``); here it runs eagerly. Its
``fused`` parameter, which chose that program, is accepted in ``cyten_tpu``'s place
and has no job.
"""

from __future__ import annotations

import numpy as np

from ..symmetries import ElementarySpace
from ._functions import (
    _decomposition_prepare, _svd_new_labels, compose, dagger, norm, qr,
    scalar_multiply, split_legs, svd, svd_apply_mask, truncate_singular_values,
)
from ._tensors import SymmetricTensor

__all__ = ['randomized_truncated_svd']


def _range_finder(prepped, omega, n_power: int, new_leg_dual: bool):
    """Sketch, power iterations, projection and small SVD (steps 1-4)."""
    Y = compose(prepped, omega)
    Q, _ = qr(Y)
    for _ in range(int(n_power)):
        Z = compose(dagger(prepped), Q)
        Qz, _ = qr(Z)
        Y = compose(prepped, Qz)
        Q, _ = qr(Y)
    B = compose(dagger(Q), prepped)
    U_B, S, Vh = svd(B, new_leg_dual=new_leg_dual)
    U = compose(Q, U_B)
    return U, S, Vh


def randomized_truncated_svd(tensor, chi_max: int, new_labels=None,
                             new_leg_dual: bool = False, n_oversample: int = 16,
                             n_power: int = 1, sector_ranks=None, rng=None,
                             normalize_to: float = None, chi_min=None,
                             degeneracy_tol=None, trunc_cut=None, svd_min=None,
                             pad_to_multiple: int = None, fused: bool = None):
    """Truncated SVD via a randomized range finder: ``(U, S, Vh, err, renormalize)``,
    the convention of :func:`~cyten_tpu_torch.tensors.truncated_svd`.

    Parameters
    ----------
    chi_max : int
        Global truncation budget (as in :func:`truncate_singular_values`). Also
        caps the per-sector sketch size at ``chi_max + n_oversample``.
    n_oversample : int
        Extra sketch columns per sector; improves the top-``chi`` accuracy.
    n_power : int
        Power (subspace) iterations. 1-2 suffice for DMRG-like decaying spectra.
    sector_ranks : dict[tuple, int] | int | None
        Optional per-sector rank hints, keyed by sector tuples of the new leg. The
        sketch size of a sector is ``min(mult, hint + n_oversample)``.
    rng : np.random.Generator | None
        Randomness source for the sketch Ω (a fresh generator if None).
    fused : bool | None
        Accepted in ``cyten_tpu``'s place; no job here (the module note).

    If the sketch reduces no sector (small tensors), this is the exact truncated
    SVD. The reported ``err`` includes the weight outside the sketched subspace.
    """
    if rng is None:
        rng = np.random.default_rng()
    a, b, c, d = _svd_new_labels(new_labels)
    prepped, new_leg, comb_cod, comb_dom = _decomposition_prepare(tensor, new_leg_dual)
    sym = prepped.symmetry

    # per-sector sketch sizes
    mults = np.asarray(new_leg.multiplicities, int)
    caps = np.full(len(mults), int(chi_max) + int(n_oversample), dtype=int)
    if sector_ranks is not None:
        if isinstance(sector_ranks, int):
            caps = np.minimum(caps, sector_ranks + n_oversample)
        else:
            for i, sec in enumerate(new_leg.sector_decomposition):
                hint = sector_ranks.get(tuple(int(x) for x in sec))
                if hint is not None:
                    caps[i] = min(caps[i], int(hint) + n_oversample)
    sketch_mults = np.minimum(mults, np.maximum(caps, 1))
    if np.all(sketch_mults >= mults):
        # no reduction anywhere: the exact path is cheaper
        U, S, Vh = svd(tensor, new_labels=new_labels, new_leg_dual=new_leg_dual)
        mask, err, new_norm = truncate_singular_values(
            S, chi_max=chi_max, chi_min=chi_min, degeneracy_tol=degeneracy_tol,
            trunc_cut=trunc_cut, svd_min=svd_min, pad_to_multiple=pad_to_multiple)
        U, S, Vh = svd_apply_mask(U, S, Vh, mask)
        if normalize_to is None:
            return U, S, Vh, err, 1.
        renormalize = normalize_to / float(new_norm)
        return U, scalar_multiply(renormalize, S), Vh, err, renormalize

    G = ElementarySpace.from_sector_decomposition(
        sym, new_leg.sector_decomposition.copy(), sketch_mults, is_dual=new_leg.is_dual)
    omega = SymmetricTensor.from_random_normal(
        list(prepped.domain.factors), [G], backend=prepped.backend, rng=rng,
        dtype=prepped.dtype)
    U, S, Vh = _range_finder(prepped, omega, n_power, new_leg_dual)
    norm_S_all_sq = float(norm(S)) ** 2  # total computed weight (qdim-weighted)

    # global truncation over the computed values
    mask, err, new_norm = truncate_singular_values(
        S, chi_max=chi_max, chi_min=chi_min, degeneracy_tol=degeneracy_tol,
        trunc_cut=trunc_cut, svd_min=svd_min, pad_to_multiple=pad_to_multiple)
    U, S, Vh = svd_apply_mask(U, S, Vh, mask)

    # the weight the sketch did not capture, exactly via norms: discarded by the
    # truncation plus missed by the sketch, relative to the whole tensor
    norm_t_sq = float(norm(prepped)) ** 2
    disc_sq = max(norm_S_all_sq - float(new_norm) ** 2, 0.)
    missed_sq = max(norm_t_sq - norm_S_all_sq, 0.)
    err_total = float(np.sqrt((disc_sq + missed_sq) / max(norm_t_sq, 1e-300)))

    if normalize_to is None:
        renormalize = 1.
    else:
        renormalize = normalize_to / float(new_norm)
        S = scalar_multiply(renormalize, S)

    # labels and split legs as truncated_svd / svd leave them
    U = U.copy(deep=False)
    U.labels = [*prepped.codomain_labels, a]
    S = S.copy(deep=False)
    S.labels = [b, c]
    Vh = Vh.copy(deep=False)
    Vh.labels = [d, *reversed(prepped.domain_labels)]
    if comb_cod:
        U = split_legs(U, 0)
    if comb_dom:
        Vh = split_legs(Vh, -1)
    return U, S, Vh, err_total, renormalize
