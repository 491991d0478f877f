"""The anyonic categories of the PyTorch port (``cyten_tpu_torch/symmetries/anyons.py``)
against cyten_tpu's, to 1e-12 (``cyten_tpu/testing/asserting.py:14``).

Each property is one parametrised test, one case per category: the fusion outcomes,
N symbols, quantum dimensions, Frobenius-Schur indicators, twists and S matrix over
all sectors, and the F, R, B and C symbols over every admissible set of sectors. The
categories are built the same way in both packages (Fibonacci in both handednesses)
and the module-level instances are compared as they are.
"""

import itertools

import numpy as np
import pytest

import cyten_tpu.symmetries as ref

import cyten_tpu_torch.symmetries as port

TOL = 1e-12

# name -> (class name, constructor arguments)
CATEGORIES = {
    'Z3_n1': ('ZNAnyonCategory', dict(N=3, n=1)),
    'Z4_n3': ('ZNAnyonCategory', dict(N=4, n=3)),
    'Z2^(1/2)_n0': ('ZNAnyonCategory2', dict(N=2, n=0)),
    'Z4^(1/2)_n1': ('ZNAnyonCategory2', dict(N=4, n=1)),
    'D(Z3)': ('QuantumDoubleZNAnyonCategory', dict(N=3)),
    'toric_code': ('ToricCodeCategory', {}),
    'fibonacci_left': ('FibonacciAnyonCategory', dict(handedness='left')),
    'fibonacci_right': ('FibonacciAnyonCategory', dict(handedness='right')),
    'ising_nu1': ('IsingAnyonCategory', dict(nu=1)),
    'ising_nu3': ('IsingAnyonCategory', dict(nu=3)),
    'SU2_2_left': ('SU2_kAnyonCategory', dict(k=2, handedness='left')),
    'SU2_3_right': ('SU2_kAnyonCategory', dict(k=3, handedness='right')),
    'SU3_3': ('SU3_3AnyonCategory', {}),
}
INSTANCES = ['fibonacci_anyon_category', 'ising_anyon_category', 'toric_code_category',
             'double_semion_category', 'semion_category']
CASES = [*CATEGORIES, *INSTANCES]


def pair(name):
    """The category ``name`` in cyten_tpu and in the port, as Symmetry objects."""
    if name in INSTANCES:
        return getattr(ref, name), getattr(port, name)
    cls, kwargs = CATEGORIES[name]
    return (getattr(ref, cls)(**kwargs).as_Symmetry(),
            getattr(port, cls)(**kwargs).as_Symmetry())


def outcomes(sym, a, b):
    return [np.asarray(c) for c in sym.fusion_outcomes(a, b)]


def f_tuples(sym):
    """Every admissible ``(a, b, c, d, e, f)`` of ``f_symbol``: e in b x c, d in
    a x e, f in a x b with d in f x c."""
    secs = list(sym.all_sectors())
    for a, b, c in itertools.product(secs, repeat=3):
        for e in outcomes(sym, b, c):
            for d in outcomes(sym, a, e):
                for f in outcomes(sym, a, b):
                    if any(np.array_equal(d, x) for x in outcomes(sym, f, c)):
                        yield a, b, c, d, e, f


def c_tuples(sym):
    """Every admissible ``(a, b, c, d, e, f)`` of ``c_symbol``: e in a x b, d in
    e x c, f in a x c with d in f x b."""
    secs = list(sym.all_sectors())
    for a, b, c in itertools.product(secs, repeat=3):
        for e in outcomes(sym, a, b):
            for d in outcomes(sym, e, c):
                for f in outcomes(sym, a, c):
                    if any(np.array_equal(d, x) for x in outcomes(sym, f, b)):
                        yield a, b, c, d, e, f


def r_tuples(sym):
    secs = list(sym.all_sectors())
    for a, b in itertools.product(secs, repeat=2):
        for c in outcomes(sym, a, b):
            yield a, b, c


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize('name', CASES)
def test_sectors_and_fusion_outcomes(name):
    r, p = pair(name)
    assert repr(p) == repr(r)
    assert p.braiding_style == r.braiding_style and p.fusion_style == r.fusion_style
    np.testing.assert_array_equal(p.all_sectors(), r.all_sectors())
    np.testing.assert_array_equal(p.trivial_sector, r.trivial_sector)
    secs = list(r.all_sectors())
    for a, b in itertools.product(secs, repeat=2):
        np.testing.assert_array_equal(p.fusion_outcomes(a, b), r.fusion_outcomes(a, b))
    for a in secs:
        np.testing.assert_array_equal(p.dual_sector(a), r.dual_sector(a))


@pytest.mark.parametrize('name', CASES)
def test_n_symbols(name):
    r, p = pair(name)
    for a, b, c in r_tuples(r):
        assert p.n_symbol(a, b, c) == r.n_symbol(a, b, c)


@pytest.mark.parametrize('name', CASES)
def test_quantum_dimensions(name):
    r, p = pair(name)
    secs = r.all_sectors()
    close(p.batch_qdim(secs), r.batch_qdim(secs))
    close([p.qdim(a) for a in secs], [r.qdim(a) for a in secs])
    close(p.total_qdim(), r.total_qdim())


@pytest.mark.parametrize('name', CASES)
def test_frobenius_schur_indicators(name):
    r, p = pair(name)
    for a in r.all_sectors():
        assert p.frobenius_schur(a) == r.frobenius_schur(a)


@pytest.mark.parametrize('name', CASES)
def test_topological_twists(name):
    r, p = pair(name)
    close([p.topological_twist(a) for a in r.all_sectors()],
          [r.topological_twist(a) for a in r.all_sectors()])


@pytest.mark.parametrize('name', CASES)
def test_s_matrix(name):
    r, p = pair(name)
    close(p.s_matrix(), r.s_matrix())


@pytest.mark.parametrize('name', CASES)
def test_f_symbols(name):
    r, p = pair(name)
    n = 0
    for args in f_tuples(r):
        close(p.f_symbol(*args), r.f_symbol(*args))
        n += 1
    assert n > 0


@pytest.mark.parametrize('name', CASES)
def test_r_symbols(name):
    r, p = pair(name)
    for args in r_tuples(r):
        close(p.r_symbol(*args), r.r_symbol(*args))


@pytest.mark.parametrize('name', CASES)
def test_b_symbols(name):
    r, p = pair(name)
    for args in r_tuples(r):
        close(p.b_symbol(*args), r.b_symbol(*args))


@pytest.mark.parametrize('name', CASES)
def test_c_symbols(name):
    r, p = pair(name)
    n = 0
    for args in c_tuples(r):
        close(p.c_symbol(*args), r.c_symbol(*args))
        n += 1
    assert n > 0


def test_fibonacci_handedness_conjugates_the_braids():
    """The two Fibonacci handednesses differ only by complex conjugation of R (and so
    of the twists), in the port as in cyten_tpu."""
    left = port.FibonacciAnyonCategory('left')
    right = port.FibonacciAnyonCategory('right')
    tau = np.array([1])
    for c in left.fusion_outcomes(tau, tau):
        close(right.r_symbol(tau, tau, c), np.conj(left.r_symbol(tau, tau, c)))
    close(right.topological_twist(tau), np.conj(left.topological_twist(tau)))
    assert not left.is_equivalent_to(right)
    assert port.fibonacci_anyon_category.is_equivalent_to(left.as_Symmetry())
