"""Rank-adaptive warm-started truncated SVD for the growth phase of DMRG.

The counterpart of ``cyten_tpu/tensors/adaptive.py``. The steady SVD
(``tensors/steady.py``) freezes the per-sector ranks; the randomized SVD
(``tensors/randomized.py``) adapts them but sketches ``chi_max + p`` columns per
sector from scratch. This is the middle ground the growth phase wants:

    sketch  =  previous visit's right isometry  ⊕  p fresh random columns

Per sector the previous kept rank ``k_c`` is warm and only the ``p`` head-room
columns are cold, so one power iteration suffices and the sketch is ``k_c + p`` per
sector instead of ``chi_max + p``:

1. ``V0 = qr([V_prev | Ω])``            thin QR, warm ⊕ random, orthonormal
2. ``V  <- qr(θ† (θ V))``  (n_power ×)  two GEMMs and a thin QR per iteration
3. ``B = θ V;  B = Q R``                thin QR; R is (k_c+p)² per sector
4. ``R = U_R S W†``                     the SVD of the SMALL square R only
5. ``U = Q U_R;  Vh = (V W)†``          exact isometries by construction

Ranks adapt: the truncation runs on the computed spectrum, and per visit a sector
can grow by up to ``p`` (new sectors appear with up to ``p`` values: the random
columns cover every candidate bond sector). The weight outside the sketch is
accounted exactly via ``||θ||² - ||S_all||²``.

Ω is drawn with ``SymmetricTensor.from_random_normal(..., rng=)`` from a numpy
generator in ``cyten_tpu``'s order, so one generator gives both packages one Ω.

Where ``cyten_tpu``'s ``jax.jit`` wrappers went. ``_get_jitted_chain`` and
``_get_jitted_exact`` compiled :func:`_factor_chain` and the exact SVD as one program
each; here both run eagerly, every GEMM of them one grouped-GEMM launch. Their
``fused`` parameter, which chose the compiled program, is accepted in
``cyten_tpu``'s place and has no job. ``_apply_mask_cached`` and ``_phase2_run``
compiled one program per mask pattern; here the cache keyed by the mask's content
(:func:`_mask_cache_key`) keeps the mask resolved to host-side slices
(:class:`~cyten_tpu_torch.tensors._functions._PrefixMask`), so that applying it reads
nothing from the device.
"""

from __future__ import annotations

import numpy as np

from ..symmetries import ElementarySpace
from ._functions import (
    _PrefixMask, compose, dagger, norm, qr, scalar_multiply, svd, svd_apply_mask,
    tensor_from_grid, truncate_singular_values,
)
from ._tensors import SymmetricTensor, _dual_label_list

__all__ = ['adaptive_truncated_svd', 'fused_truncated_svd']


def _sketch_extra_leg(thp, warm_leg, n_extra: int):
    """ElementarySpace of fresh sketch columns: for every candidate bond sector c
    (present in both the codomain and domain fusion of ``thp``), ``n_extra``
    columns, capped so warm + extra never exceeds the exact bond rank
    ``min(cod_mult_c, dom_mult_c)``. Returns None if no sector needs columns."""
    cod = {tuple(int(x) for x in s): int(m) for s, m in
           zip(thp.codomain.sector_decomposition, thp.codomain.multiplicities)}
    warm = {tuple(int(x) for x in s): int(m)
            for s, m in zip(warm_leg.sector_decomposition, warm_leg.multiplicities)}
    secs, mults = [], []
    for s, m_dom in zip(thp.domain.sector_decomposition, thp.domain.multiplicities):
        key = tuple(int(x) for x in s)
        m_cod = cod.get(key)
        if m_cod is None:
            continue
        full = min(int(m_dom), m_cod)
        extra = min(n_extra, max(full - warm.get(key, 0), 0))
        if extra > 0:
            secs.append(s)
            mults.append(extra)
    if not secs:
        return None
    return ElementarySpace.from_sector_decomposition(
        thp.symmetry, np.asarray(secs), np.asarray(mults, int), is_dual=warm_leg.is_dual)


def _factor_chain(thp, Vh_prev, omega, n_power: int):
    """The sketch assembly and the GEMM/QR/small-SVD pipeline, everything before the
    truncation decision. Returns ``(V, Q, U_R, S, Vh_R, |S|^2, |thp|^2)``.

    Without ``omega`` the sketch is ``Vh_prev``'s dagger as it is: a DMRG B tensor is
    a right isometry already (its dagger has orthonormal columns), and n_power >= 1
    re-orthonormalizes anyway. ``cyten_tpu``'s ``assume_isometry=False``, which
    took a QR of it first, has no caller and is not ported."""
    V = dagger(Vh_prev)                         # thp.domain <- [kept_prev]
    if omega is not None:
        V, _ = qr(tensor_from_grid([[V, omega]]))
    for _ in range(int(n_power)):
        B = compose(thp, V)                     # [codomain | sketch]
        Z = compose(dagger(thp), B)             # [domain | sketch]
        V, _ = qr(Z)
    B = compose(thp, V)
    # factor through a thin QR so that the only SVD runs on the SMALL square R
    Q, R = qr(B)                                # R: [q | sketch], (k_c+p)-sized
    U_R, S, Vh_R = svd(R)
    return V, Q, U_R, S, Vh_R, norm(S) ** 2, norm(thp) ** 2


_MASK_CACHE: dict = {}
_MASK_CACHE_MAX = 512


def _mask_cache_key(mask):
    """The key of a mask's content: its boolean pattern (the host copy that
    :func:`truncate_singular_values` attaches) and the full signature of its large
    leg, so that one pattern on two legs gets two entries. None where the mask has
    no host pattern."""
    bools = getattr(mask, '_host_bools', None)
    if bools is None:
        return None
    leg = mask.large_leg
    return (str(leg.symmetry), tuple(map(tuple, leg.sector_decomposition.tolist())),
            tuple(int(m) for m in leg.multiplicities), bool(leg.is_dual), bools)


def _resolved(mask):
    """``mask`` as a :class:`_PrefixMask`, cached by its content (least recently used
    goes first), or None where it has no host pattern, keeps more than a prefix or is
    not block-sparse (the no-symmetry backend's one dense block)."""
    key = _mask_cache_key(mask)
    if key is None or not hasattr(mask.data, 'block_inds'):
        return None
    if key in _MASK_CACHE:
        _MASK_CACHE[key] = _MASK_CACHE.pop(key)  # most recently used
        return _MASK_CACHE[key]
    try:
        found = _PrefixMask(mask)
    except ValueError:
        found = None
    _MASK_CACHE[key] = found
    while len(_MASK_CACHE) > _MASK_CACHE_MAX:
        _MASK_CACHE.pop(next(iter(_MASK_CACHE)))
    return found


def _apply_mask_cached(U, S, Vh, mask):
    """``svd_apply_mask(U, S, Vh, mask)``, by host-side slices where the mask's
    content resolves to a prefix of each sector (:func:`_resolved`)."""
    prefix = _resolved(mask)
    if prefix is None:
        return svd_apply_mask(U, S, Vh, mask)
    return prefix.apply(U, S, Vh)


def fused_truncated_svd(thp, chi_max: int = None, new_labels=('vR', 'vL'),
                        chi_min=None, degeneracy_tol=None, trunc_cut=None,
                        svd_min=None, pad_to_multiple: int = None,
                        normalize_to: float = None, fused: bool = None):
    """The exact truncated SVD in the two phases of the adaptive path: the
    per-sector SVD, the truncation decision on the host, and the mask applied by
    host-side slices cached by its content. Numerically the result of
    :func:`~cyten_tpu_torch.tensors.truncated_svd`. ``fused`` is accepted and has
    no job (the module note).

    Returns ``(U, S, Vh, err, renormalize)``."""
    U, S, Vh = svd(thp)
    a, b = new_labels
    U = U.copy(deep=False)
    U.labels = [*U.labels[:-1], a]
    S = S.relabelled([b, f'{b}*'])
    Vh = Vh.copy(deep=False)
    Vh.labels = [b, *Vh.labels[1:]]
    mask, err, new_norm = truncate_singular_values(
        S, chi_max=chi_max, chi_min=chi_min, degeneracy_tol=degeneracy_tol,
        trunc_cut=trunc_cut, svd_min=svd_min, pad_to_multiple=pad_to_multiple)
    U, S, Vh = _apply_mask_cached(U, S, Vh, mask)
    if normalize_to is None:
        renormalize = 1.
    else:
        renormalize = normalize_to / float(new_norm)
        S = scalar_multiply(renormalize, S)
    return U, S, Vh, err, renormalize


def _phase2(Q, U_R, S, Vh_R, V, mask):
    """The mask applied and the two output products (the phase after the
    truncation decision)."""
    U_R, S, Vh_R = _apply_mask_cached(U_R, S, Vh_R, mask)
    U = compose(Q, U_R)
    Vh = compose(Vh_R, dagger(V))
    return U, S, Vh


def adaptive_truncated_svd(thp, Vh_prev, chi_max: int, n_oversample: int = 16,
                           n_power: int = 1, new_labels=('vR', 'vL'),
                           chi_min=None, degeneracy_tol=None, trunc_cut=None,
                           svd_min=None, pad_to_multiple: int = None,
                           normalize_to: float = None, rng=None,
                           fused: bool = None):
    """Truncated SVD of ``thp``, warm-started from the previous visit's ``Vh_prev``
    with ``n_oversample`` columns of per-sector rank head-room.

    Parameters
    ----------
    thp : SymmetricTensor
        The wavefunction as a morphism codomain -> domain (e.g. [vL, p0 | vR, p1]).
    Vh_prev : SymmetricTensor
        Right isometry from the previous visit of this bond (in DMRG: the current
        ``B`` tensor as ``[kept] <- thp.domain``). Its per-sector ranks seed the
        sketch; they do not freeze the result.
    chi_max, chi_min, degeneracy_tol, trunc_cut, svd_min, pad_to_multiple
        Truncation constraints, as in :func:`truncate_singular_values`.
    n_power : int
        Subspace (power) iterations after the warm start.
    rng : np.random.Generator | None
        Randomness source for the fresh columns Ω (a fresh generator if None).
    fused : bool | None
        Accepted in ``cyten_tpu``'s place; no job here (the module note).

    Returns ``(U, S, Vh, err, renormalize)``, the convention of
    ``randomized_truncated_svd``; ``err`` includes the weight outside the sketch.
    """
    if rng is None:
        rng = np.random.default_rng()
    omega = None
    G = _sketch_extra_leg(thp, Vh_prev.codomain.factors[0], int(n_oversample))
    if G is not None:
        omega = SymmetricTensor.from_random_normal(
            list(Vh_prev.domain.factors), [G], backend=thp.backend, rng=rng,
            dtype=thp.dtype)
        omega.labels = _dual_label_list(Vh_prev.labels)  # those of dagger(Vh_prev)
    V, Q, U_R, S, Vh_R, nS_sq, nt_sq = _factor_chain(thp, Vh_prev, omega, int(n_power))
    a, b = new_labels
    U_R = U_R.copy(deep=False)
    U_R.labels = [*U_R.labels[:-1], a]
    S = S.relabelled([b, f'{b}*'])
    Vh_R = Vh_R.copy(deep=False)
    Vh_R.labels = [b, *Vh_R.labels[1:]]
    norm_S_all_sq = float(nS_sq)                # computed weight (qdim-weighted)

    mask, err, new_norm = truncate_singular_values(
        S, chi_max=chi_max, chi_min=chi_min, degeneracy_tol=degeneracy_tol,
        trunc_cut=trunc_cut, svd_min=svd_min, pad_to_multiple=pad_to_multiple)
    U, S, Vh = _phase2(Q, U_R, S, Vh_R, V, mask)
    # the error exactly: discarded by the truncation plus missed by the sketch
    norm_t_sq = float(nt_sq)
    disc_sq = max(norm_S_all_sq - float(new_norm) ** 2, 0.)
    missed_sq = max(norm_t_sq - norm_S_all_sq, 0.)
    err_total = float(np.sqrt((disc_sq + missed_sq) / max(norm_t_sq, 1e-300)))

    if normalize_to is None:
        renormalize = 1.
    else:
        renormalize = normalize_to / float(new_norm)
        S = scalar_multiply(renormalize, S)

    U = U.relabelled({U.labels[-1]: a})
    S = S.relabelled([b, f'{b}*'])
    Vh = Vh.relabelled({Vh.labels[0]: b})
    return U, S, Vh, err_total, renormalize
