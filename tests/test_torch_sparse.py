"""The linear operators of the PyTorch port (cyten_tpu_torch/tensors/sparse.py) against
cyten_tpu's on the same tensors.

The tensors are drawn in cyten_tpu (numpy block backend) from a numpy seed and carried
over exactly (test_torch_interop.to_port); each operator's matvec is held to the
reference's to 1e-12, the tensor-op tolerance of cyten_tpu/testing/asserting.py:14.
"""

import inspect

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu import tensors as ref
from cyten_tpu_torch import tensors as port
from cyten_tpu_torch.tools import math as port_math
from test_torch_interop import to_port

TOL = 1e-12


@pytest.fixture(scope='module')
def setup():
    """A hermitian U(1) operator H [a | a*], vectors v, o1, o2 [a] and a second
    operator G, drawn as tests/test_sparse.py draws them."""
    leg = ct.ElementarySpace(ct.u1_symmetry, [[-1], [0], [1]], [2, 3, 2])
    be = ct.get_backend(ct.u1_symmetry, 'numpy')
    rng = np.random.default_rng(42)
    H = ct.SymmetricTensor.from_random_normal([leg], [leg], backend=be, rng=rng,
                                              labels=['a', 'a*'])
    H = 0.5 * (H + H.hc)
    G = ct.SymmetricTensor.from_random_normal([leg], [leg], backend=be, rng=rng,
                                              labels=['a', 'a*'])
    vecs = [ct.SymmetricTensor.from_random_normal([leg], [], backend=be, rng=rng,
                                                  labels=['a']) for _ in range(3)]
    return {'H': H, 'G': G, 'v': vecs[0], 'o1': vecs[1], 'o2': vecs[2]}


def _pair(setup, *names):
    return [(setup[n], to_port(setup[n])) for n in names]


def _close(got, want):
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=TOL, atol=TOL)


# each case: (ref, port) -> the pair of operators built by the module's classes
OPERATORS = {
    'tensor': lambda m, H, G, o: m.TensorLinearOperator(H, which_legs=['a']),
    'sum': lambda m, H, G, o: m.SumLinearOperator(m.TensorLinearOperator(H),
                                                  m.TensorLinearOperator(G)),
    'add': lambda m, H, G, o: m.TensorLinearOperator(H) + m.TensorLinearOperator(G),
    'shifted': lambda m, H, G, o: m.ShiftedLinearOperator(m.TensorLinearOperator(H),
                                                          2.5),
    'projected': lambda m, H, G, o: m.ProjectedLinearOperator(
        m.TensorLinearOperator(H), o),
    'penalty': lambda m, H, G, o: m.ProjectedLinearOperator(
        m.TensorLinearOperator(H), o, penalty=3.),
    'adjoint': lambda m, H, G, o: m.TensorLinearOperator(G).adjoint(),
    'wrapper': lambda m, H, G, o: m.NumpyArrayLinearOperator(
        m.TensorLinearOperator(H), o[0]),
}


@pytest.mark.parametrize('case', list(OPERATORS))
def test_matvec_matches_cyten_tpu(setup, case):
    (rH, pH), (rG, pG), (rv, pv), (r1, p1), (r2, p2) = _pair(setup, 'H', 'G', 'v',
                                                             'o1', 'o2')
    r_op = OPERATORS[case](ref, rH, rG, [r1, r2])
    p_op = OPERATORS[case](port, pH, pG, [p1, p2])
    assert type(p_op).__name__ == type(r_op).__name__
    _close(p_op.matvec(pv), r_op.matvec(rv))
    if case in ('projected', 'penalty'):
        # the projected vectors: gram_schmidt of [o1, o2]
        for a, b in zip(p_op.ortho_vecs, r_op.ortho_vecs):
            _close(a, b)
        if case == 'projected':
            w = p_op.matvec(pv)
            assert all(abs(port.inner(o, w)) < 1e-12 for o in p_op.ortho_vecs)
            _close(p_op.project(pv), r_op.project(rv))


def test_gram_schmidt_drops_a_near_null_vector(setup):
    (rv, pv), (r1, p1) = _pair(setup, 'v', 'o1')
    # the third vector lies in the span of the first two up to 1e-16
    r3 = ref.linear_combination(2., rv, -3., r1) + 1e-16 * r1
    p3 = port.linear_combination(2., pv, -3., p1) + 1e-16 * p1
    got = port.gram_schmidt([pv, p1, p3])
    want = ref.gram_schmidt([rv, r1, r3])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _close(a, b)
    for i, a in enumerate(got):
        for j, b in enumerate(got):
            assert abs(port.inner(a, b) - float(i == j)) < 1e-12


def test_numpy_array_operator_lowest_eigenvector(setup):
    (rH, pH), (rv, pv) = _pair(setup, 'H', 'v')
    got_vals, got = port.HermitianNumpyArrayLinearOperator(
        port.TensorLinearOperator(pH), pv).eigenvectors(num_ev=1, which='SA', v0=pv)
    want_vals, want = ref.HermitianNumpyArrayLinearOperator(
        ref.TensorLinearOperator(rH), rv).eigenvectors(num_ev=1, which='SA', v0=rv)
    # ARPACK on the same operator from the same start vector; the eigenvalue of the
    # symmetric subspace (the charge-0 block of H, as v lives there) to solver precision
    np.testing.assert_allclose(got_vals, want_vals, rtol=1e-10)
    block = rH.to_numpy()[2:5, 2:5]
    np.testing.assert_allclose(got_vals[0], np.linalg.eigvalsh(block)[0], rtol=1e-10)
    g, w = got[0].to_numpy(), want[0].to_numpy()
    np.testing.assert_allclose(g * np.sign(g @ w), w, atol=1e-8)
    np.testing.assert_allclose(port.TensorLinearOperator(pH).matvec(got[0]).to_numpy(),
                               got_vals[0] * g, atol=1e-10)


@pytest.mark.parametrize('fn', ['speigs', 'speigsh'])
def test_sparse_eigensolvers_match_cyten_tpu(fn):
    from cyten_tpu.tools import math as ref_math

    rng = np.random.default_rng(3)
    A = rng.normal(size=(12, 12))
    A = A + A.T
    for k in (2, 11):  # scipy's solver, and the dense fallback near the dimension
        w, v = getattr(port_math, fn)(A, k)
        w_ref, v_ref = getattr(ref_math, fn)(A, k)
        np.testing.assert_allclose(np.sort(np.real(w)), np.sort(np.real(w_ref)),
                                   rtol=1e-10)


@pytest.mark.parametrize('name', ['TensorLinearOperator', 'SumLinearOperator',
                                  'ShiftedLinearOperator', 'ProjectedLinearOperator',
                                  'NumpyArrayLinearOperator', 'gram_schmidt'])
def test_signature_is_the_references(name):
    got = inspect.signature(getattr(port, name))
    want = inspect.signature(getattr(ref, name))
    assert [(p.name, p.default) for p in got.parameters.values()] == \
        [(p.name, p.default) for p in want.parameters.values()]
