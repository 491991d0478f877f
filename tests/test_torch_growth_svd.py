"""The growth-phase SVDs of the PyTorch port against cyten_tpu: the randomized and the
adaptive truncated SVD, the exact one in the adaptive path's two phases, and the
sketch methods of split_truncate_theta.

Both packages draw the random columns Ω block by block from a numpy generator in the
same order, so one seed gives both the same Ω (test_same_omega_from_one_seed). The
inputs are made in cyten_tpu and carried over exactly (test_torch_interop.to_port).
Singular values are compared at f64 to 1e-12; singular vectors, which a degenerate or
sign-flipped pair may rotate, by their projectors. cyten_tpu runs on its numpy blocks:
the same functions as on its jax blocks, eagerly, where they compile a program each.
"""

BACKEND = 'numpy'  # cyten_tpu's block backend here

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms.mps import split_truncate_theta as jax_split_truncate_theta
from cyten_tpu.tensors.adaptive import adaptive_truncated_svd as jax_adaptive
from cyten_tpu.tensors.adaptive import fused_truncated_svd as jax_fused
from cyten_tpu.tensors.randomized import randomized_truncated_svd as jax_randomized

from cyten_tpu_torch.algorithms.mps import split_truncate_theta
from cyten_tpu_torch.tensors import (
    compose, dagger, permute_legs, svd, svd_apply_mask, truncate_singular_values,
)
from cyten_tpu_torch.tensors.adaptive import (
    _MASK_CACHE, _apply_mask_cached, adaptive_truncated_svd, fused_truncated_svd,
)
from cyten_tpu_torch.tensors.randomized import randomized_truncated_svd
from test_torch_interop import to_port


def _decaying_tensor(rng, mults=(24, 40, 24), decay=0.85):
    """A cyten_tpu U(1) tensor [a | b] on three sectors with a geometrically
    decaying singular spectrum in each (tests/test_randomized_svd.py)."""
    backend = ct.get_backend(ct.u1_symmetry, BACKEND)
    V = ct.ElementarySpace(ct.u1_symmetry, [[-1], [0], [1]], list(mults))
    T = ct.SymmetricTensor.from_random_normal([V], [V], backend=backend, rng=rng,
                                              labels=['a', 'b'])
    U, S, Vh = ct.svd(T)

    def func(shape, coupled):
        vals = decay ** (np.arange(shape[0]) + rng.uniform(0, 0.3, size=shape[0]))
        return backend.block_backend.as_block(np.sort(vals)[::-1].copy(),
                                              ct.dtypes.Dtype.float64)

    S2 = ct.DiagonalTensor.from_sector_block_func(func, S.leg, backend=backend)
    return ct.compose(ct.compose(U, S2.as_SymmetricTensor()), Vh)


def _theta(rng, chi=24):
    """A two-site wavefunction [vL, p0, p1, vR] of cyten_tpu with a decaying spectrum
    across its bond, and a right isometry B [vL, p | vR] near its top subspace."""
    from test_torch_dmrg import build_workload

    *_, theta = build_workload(ct.get_backend(ct.u1_symmetry, BACKEND), chi=chi,
                               seed=int(rng.integers(1 << 30)))
    thp = ct.permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    U, S, Vh = ct.svd(thp, new_labels=['vR', 'vL'])

    def func(shape, coupled):  # no two sectors share a value: truncation has no ties
        vals = 0.7 ** (np.arange(shape[0]) + rng.uniform(0, 0.5, size=shape[0]))
        return S.backend.block_backend.as_block(np.sort(vals)[::-1].copy(),
                                                ct.dtypes.Dtype.float64)

    S2 = ct.DiagonalTensor.from_sector_block_func(func, S.leg, backend=S.backend,
                                                  labels=S.labels)
    thp = ct.compose(ct.compose(U, S2.as_SymmetricTensor()), Vh)
    theta = ct.permute_legs(thp, codomain=['vL', 'p0', 'p1'], domain=['vR'])
    # the previous visit's B: the top 6 of a nearby state, kept per sector
    noisy = thp + 1e-3 * ct.SymmetricTensor.from_random_normal(
        thp.codomain, thp.domain, backend=thp.backend, rng=rng, labels=thp.labels)
    _, _, Vh_prev, _, _ = ct.truncated_svd(noisy, new_labels=['vR', 'vL'], chi_max=6)
    B = ct.permute_legs(Vh_prev, codomain=['vL', 'p1'], domain=['vR']).relabelled(
        {'p1': 'p'})
    return theta, B


def _values(S):
    """The singular values of each sector, sorted, as ``{sector: array}``."""
    leg = S.leg
    out = {}
    for blk, i in zip(S.data.blocks, S.data.block_inds):
        out[tuple(int(x) for x in leg.sector_decomposition[int(i)])] = np.sort(
            np.asarray(blk, np.float64).reshape(-1))
    return out


def _assert_values_equal(S_port, S_ref, tol=1e-12):
    got, ref = _values(S_port), _values(S_ref)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=tol, err_msg=str(k))


def _assert_projector_equal(X_port, X_ref, right=False, tol=1e-10):
    """The projector onto the columns of X (X X†) or, with ``right``, onto its rows
    (X† X), equal in both packages."""
    if right:
        P, P_ref = compose(dagger(X_port), X_port), ct.compose(ct.dagger(X_ref), X_ref)
    else:
        P, P_ref = compose(X_port, dagger(X_port)), ct.compose(X_ref, ct.dagger(X_ref))
    np.testing.assert_allclose(P.to_numpy(), np.asarray(P_ref.to_numpy()), rtol=0, atol=tol)


def test_same_omega_from_one_seed():
    backend = ct.get_backend(ct.u1_symmetry, BACKEND)
    V = ct.ElementarySpace(ct.u1_symmetry, [[-1], [0], [1]], [5, 3, 4])
    G = ct.ElementarySpace(ct.u1_symmetry, [[0], [1]], [2, 2])
    ref = ct.SymmetricTensor.from_random_normal([V, V], [G], backend=backend,
                                                rng=np.random.default_rng(3))
    port = to_port(ref)
    got = type(port).from_random_normal(port.codomain, port.domain, backend=port.backend,
                                        rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(ref.to_numpy()))


@pytest.mark.parametrize('n_power, sector_ranks', [(1, None), (2, None), (2, 8),
                                                   (1, {(0,): 6, (1,): 3})])
def test_randomized_svd_matches_cyten_tpu(n_power, sector_ranks):
    T_ref = _decaying_tensor(np.random.default_rng(20))
    T = to_port(T_ref)
    kw = dict(chi_max=16, n_oversample=12, n_power=n_power, normalize_to=1.,
              sector_ranks=sector_ranks)
    U, S, Vh, err, renorm = randomized_truncated_svd(T, rng=np.random.default_rng(21), **kw)
    U_r, S_r, Vh_r, err_r, renorm_r = jax_randomized(T_ref, rng=np.random.default_rng(21),
                                                     **kw)
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12 and abs(renorm - renorm_r) < 1e-12
    _assert_projector_equal(U, U_r)
    _assert_projector_equal(Vh, Vh_r, right=True)
    assert U.labels == U_r.labels and Vh.labels == Vh_r.labels


def test_randomized_svd_without_reduction_is_exact():
    """A sketch that reduces no sector takes the exact path, in both packages."""
    T_ref = _decaying_tensor(np.random.default_rng(22), mults=(6, 8, 5))
    T = to_port(T_ref)
    _, S, _, err, _ = randomized_truncated_svd(T, chi_max=10, rng=np.random.default_rng(0))
    _, S_r, _, err_r, _ = jax_randomized(T_ref, chi_max=10, rng=np.random.default_rng(0))
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12


@pytest.mark.parametrize('chi_max', [8, 40])
def test_adaptive_svd_matches_cyten_tpu(chi_max):
    """Warm start from a B of six values per sector, with head-room: ranks grow by up
    to n_oversample (chi_max=40) or are cut (chi_max=8)."""
    theta_ref, B_ref = _theta(np.random.default_rng(23))
    thp_ref = ct.permute_legs(theta_ref, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    Vh_prev_ref = ct.permute_legs(B_ref.relabelled({'p': 'p1'}), codomain=['vL'],
                                  domain=['vR', 'p1'])
    thp, Vh_prev = to_port(thp_ref), to_port(Vh_prev_ref)
    kw = dict(chi_max=chi_max, n_oversample=4, svd_min=1e-14, normalize_to=1.)
    U, S, Vh, err, renorm = adaptive_truncated_svd(thp, Vh_prev,
                                                   rng=np.random.default_rng(24), **kw)
    U_r, S_r, Vh_r, err_r, renorm_r = jax_adaptive(thp_ref, Vh_prev_ref,
                                                   rng=np.random.default_rng(24), **kw)
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12 and abs(renorm - renorm_r) < 1e-12
    _assert_projector_equal(U, U_r)
    _assert_projector_equal(Vh, Vh_r, right=True)
    assert U.labels == U_r.labels and S.labels == S_r.labels and Vh.labels == Vh_r.labels


def test_fused_truncated_svd_matches_cyten_tpu():
    theta_ref, _ = _theta(np.random.default_rng(25))
    thp_ref = ct.permute_legs(theta_ref, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    kw = dict(chi_max=10, svd_min=1e-14, pad_to_multiple=4, normalize_to=1.)
    U, S, Vh, err, renorm = fused_truncated_svd(to_port(thp_ref), **kw)
    U_r, S_r, Vh_r, err_r, renorm_r = jax_fused(thp_ref, **kw)
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12 and abs(renorm - renorm_r) < 1e-12
    _assert_projector_equal(U, U_r)
    _assert_projector_equal(Vh, Vh_r, right=True)


@pytest.mark.parametrize('method', ['exact', 'randomized', 'adaptive'])
def test_split_truncate_theta_methods_match_cyten_tpu(method):
    theta_ref, B_ref = _theta(np.random.default_rng(26), chi=48)
    kw = dict(chi_max=12, eps=1e-14, pad_to_multiple=2)
    A, S, B, err = split_truncate_theta(to_port(theta_ref), method=method,
                                        rng=np.random.default_rng(27),
                                        Vh_prev=to_port(B_ref), **kw)
    A_r, S_r, B_r, err_r = jax_split_truncate_theta(theta_ref, method=method,
                                                    rng=np.random.default_rng(27),
                                                    Vh_prev=B_ref, **kw)
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12
    assert A.labels == A_r.labels and B.labels == B_r.labels
    _assert_projector_equal(A, A_r)
    # B [vL, p | vR] as [vL | vR, p]: its rows are orthonormal
    _assert_projector_equal(permute_legs(B, codomain=['vL'], domain=['vR', 'p']),
                            ct.permute_legs(B_r, codomain=['vL'], domain=['vR', 'p']),
                            right=True)


def test_mask_cache_keys_on_content():
    """Masks of equal content share one host resolution, applied with no device
    read; it gives svd_apply_mask's result. Another pattern gets another entry."""
    T = to_port(_decaying_tensor(np.random.default_rng(28), mults=(6, 8, 5)))
    U, S, Vh = svd(T, new_labels=['x', 'y'])
    _MASK_CACHE.clear()
    masks = [truncate_singular_values(S, chi_max=chi)[0] for chi in (7, 7, 9)]
    results = [_apply_mask_cached(U, S, Vh, m) for m in masks]
    assert len(_MASK_CACHE) == 2
    for m, got in zip(masks, results):
        for a, b in zip(got, svd_apply_mask(U, S, Vh, m)):
            np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


@pytest.mark.parametrize('name', ['fused', 'adaptive', 'randomized'])
def test_svds_take_fused_in_the_reference_place(name):
    """Each SVD takes cyten_tpu's parameters in its order, ``fused`` last, and a call
    written for cyten_tpu with ``fused=False`` gives cyten_tpu's result (the port's
    ``fused`` has no job)."""
    import inspect

    port, ref = {'fused': (fused_truncated_svd, jax_fused),
                 'adaptive': (adaptive_truncated_svd, jax_adaptive),
                 'randomized': (randomized_truncated_svd, jax_randomized)}[name]
    assert (list(inspect.signature(port).parameters)
            == list(inspect.signature(ref).parameters))
    assert list(inspect.signature(port).parameters)[-1] == 'fused'
    theta_ref, B_ref = _theta(np.random.default_rng(29))
    thp_ref = ct.permute_legs(theta_ref, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    kw = dict(chi_max=10, svd_min=1e-14, normalize_to=1., fused=False)
    args = (thp_ref,)
    if name == 'adaptive':
        args += (ct.permute_legs(B_ref.relabelled({'p': 'p1'}), codomain=['vL'],
                                 domain=['vR', 'p1']),)
    if name != 'fused':
        kw['rng'] = np.random.default_rng(30)
    U, S, Vh, err, renorm = port(*map(to_port, args), **kw)
    if name != 'fused':
        kw['rng'] = np.random.default_rng(30)
    U_r, S_r, Vh_r, err_r, renorm_r = ref(*args, **kw)
    _assert_values_equal(S, S_r)
    assert abs(err - err_r) < 1e-12 and abs(renorm - renorm_r) < 1e-12
    _assert_projector_equal(U, U_r)
    _assert_projector_equal(Vh, Vh_r, right=True)
