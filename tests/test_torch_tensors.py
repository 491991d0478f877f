"""Tensor operations of the PyTorch port against cyten_tpu, on the same inputs.

Random U(1) and U(1) x Z2 tensors are drawn once in cyten_tpu (numpy RNG, float64) and
carried over exactly (test_torch_interop.export_tensor). cyten_tpu runs on its numpy
block backend, and for U(1) also on its jax block backend (on the CPU, as its own
tests run it). Both
packages then run the same operation; results are compared through ``to_numpy()`` at
float64 with ``rtol = atol = 1e-12``, the tolerance of
``cyten_tpu/testing/asserting.py:14``. Factorizations are compared through what is
unique about them (singular values, the reconstructed products, isometry), since
singular vectors are fixed only up to a sign per column.
"""

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.tensors as jt

import cyten_tpu_torch.tensors as pt
from test_torch_interop import random_u1_tensor, to_port

TOL = dict(rtol=1e-12, atol=1e-12)
SYMS = {'U1': ct.u1_symmetry, 'U1xZ2': ct.u1_symmetry * ct.z2_symmetry}


@pytest.fixture(params=[('U1', 'numpy'), ('U1xZ2', 'numpy'), ('U1', 'jax')],
                ids=lambda p: '-'.join(p))
def pair(request):
    """(cyten_tpu tensor, port tensor) and a second, contractible pair."""
    rng = np.random.default_rng(11)
    sym_name, block_backend = request.param
    t = random_u1_tensor(rng, SYMS[sym_name], backend=block_backend)
    # the second tensor's codomain is t's domain: compose/tdot partners
    legs = list(t.domain.factors)
    extra = ct.ElementarySpace.from_defining_sectors(
        t.symmetry, t.codomain.factors[0].defining_sectors, [2] * t.codomain.factors[0].num_sectors)
    u = ct.SymmetricTensor.from_random_normal(legs, [extra], backend=t.backend,
                                              labels=['d*', 'c*', 'e'], rng=rng)
    return (t, to_port(t)), (u, to_port(u))


def _close(port_res, jax_res):
    np.testing.assert_allclose(port_res.to_numpy(), jax_res.to_numpy(), **TOL)


def test_tdot(pair):
    (t, tp), (u, up) = pair
    _close(pt.tdot(tp, up, ['c', 'd'], ['c*', 'd*']), jt.tdot(t, u, ['c', 'd'], ['c*', 'd*']))
    # a single contracted leg in the middle of both operands: permuted operands
    _close(pt.tdot(tp, up, 'd', 'd*'), jt.tdot(t, u, 'd', 'd*'))


def test_compose(pair):
    (t, tp), (u, up) = pair
    _close(pt.compose(tp, up), jt.compose(t, u))


def test_permute_legs(pair):
    (t, tp), _ = pair
    kw = dict(codomain=['d', 'a'], domain=['b', 'c'])
    _close(pt.permute_legs(tp, **kw), jt.permute_legs(t, **kw))


def test_norm_inner_scale_axis(pair):
    (t, tp), _ = pair
    assert abs(pt.norm(tp) - jt.norm(t)) <= 1e-12 * jt.norm(t)
    t2 = jt.scalar_multiply(0.5, t) + t
    tp2 = to_port(t2)
    ref = jt.inner(t, t2, do_dagger=True)
    assert abs(pt.inner(tp, tp2, do_dagger=True) - ref) <= 1e-12 * abs(ref)
    # without the dagger, the second operand lives on the swapped (co)domain
    ref = jt.inner(t, jt.dagger(t2), do_dagger=False)
    assert abs(pt.inner(tp, pt.dagger(tp2), do_dagger=False) - ref) <= 1e-12 * abs(ref)
    rng = np.random.default_rng(5)
    leg = t.get_leg_co_domain('b')
    diag = jt.DiagonalTensor.from_random_normal(leg, backend=t.backend, rng=rng)
    _close(pt.scale_axis(tp, to_port(diag), 'b'), jt.scale_axis(t, diag, 'b'))


def _svd_checks(Up, Sp, Vp, U, S, V, matrix_p):
    np.testing.assert_allclose(Sp.diag_numpy, np.asarray(S.diag_numpy), **TOL)
    rec_p = pt.compose(pt.scale_axis(Up, Sp, -1), Vp)
    rec_j = jt.compose(jt.scale_axis(U, S, -1), V)
    _close(rec_p, rec_j)
    eye = np.eye(Up.to_numpy().shape[-1])
    UU = pt.compose(pt.dagger(Up), Up).to_numpy()
    np.testing.assert_allclose(UU, eye, **TOL)


def test_svd(pair):
    (t, tp), _ = pair
    m = jt.permute_legs(t, codomain=['a', 'b'], domain=['c', 'd'])
    mp = pt.permute_legs(tp, codomain=['a', 'b'], domain=['c', 'd'])
    m = jt.combine_to_matrix(m, ['a', 'b'], ['c', 'd'])
    mp = pt.combine_to_matrix(mp, ['a', 'b'], ['c', 'd'])
    U, S, V = jt.svd(m)
    Up, Sp, Vp = pt.svd(mp)
    _svd_checks(Up, Sp, Vp, U, S, V, mp)
    _close(pt.compose(pt.scale_axis(Up, Sp, -1), Vp), m)  # reconstructs the input


def test_truncated_svd(pair):
    (t, tp), _ = pair
    m = jt.combine_to_matrix(t, ['a', 'b'], ['c', 'd'])
    mp = pt.combine_to_matrix(tp, ['a', 'b'], ['c', 'd'])
    kw = dict(chi_max=5, svd_min=1e-14, normalize_to=1.)
    U, S, V, err, renorm = jt.truncated_svd(m, **kw)
    Up, Sp, Vp, err_p, renorm_p = pt.truncated_svd(mp, **kw)
    assert Sp.leg.dim == S.leg.dim == 5
    assert abs(err_p - err) <= 1e-12 and abs(renorm_p - renorm) <= 1e-12 * renorm
    _svd_checks(Up, Sp, Vp, U, S, V, mp)


def test_qr(pair):
    (t, tp), _ = pair
    m = jt.combine_to_matrix(t, ['a', 'b'], ['c', 'd'])
    mp = pt.combine_to_matrix(tp, ['a', 'b'], ['c', 'd'])
    Q, R = jt.qr(m)
    Qp, Rp = pt.qr(mp)
    _close(pt.compose(Qp, Rp), jt.compose(Q, R))
    _close(pt.compose(Qp, Rp), m)
    # Householder QR on both sides (LAPACK geqrf): the same R up to column signs
    np.testing.assert_allclose(np.abs(Rp.to_numpy()), np.abs(R.to_numpy()), **TOL)


def test_pinv():
    rng = np.random.default_rng(7)
    leg = ct.ElementarySpace(ct.u1_symmetry, [[-1], [0], [2]], [3, 2, 4])
    be = ct.get_backend(ct.u1_symmetry, 'numpy')
    S = jt.DiagonalTensor.from_random_normal(leg, backend=be, rng=rng)
    diag = np.asarray(S.diag_numpy).copy()
    diag[[1, 4]] = [1e-16, 0.]  # below the cutoff: inverted to 0
    S = jt.DiagonalTensor.from_diag(diag, leg, backend=be)
    _close(pt.pinv(to_port(S), cutoff=1e-15), jt.pinv(S, cutoff=1e-15))
