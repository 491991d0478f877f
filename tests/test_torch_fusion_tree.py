"""The fusion-tree backend of the PyTorch port against cyten_tpu, on random SU(2)
tensors.

Each tensor is drawn once in cyten_tpu (its numpy block backend) from a numpy seed
and carried over exactly (``tools/interop.py``). Both packages then apply the same
operation; results agree to 1e-12 (f64 tensor ops,
``cyten_tpu/testing/asserting.py:14``). The port applies tree-move plans
index-batched (``_apply_plan_grouped``), each class of plan entries through a dense
coefficient product or, above ``tree_moves.GROUPED_MAX_BLOCK`` elements, entry by
entry; both modes are held against the reference.
"""

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.tensors as jt

import cyten_tpu_torch.tensors as pt
from cyten_tpu_torch.backends import FusionTreeBackend, tree_moves
from test_torch_interop import export_tensor, to_port

TOL = dict(rtol=1e-12, atol=1e-12)
SECTORS = np.array([[0], [1], [2], [3]])


@pytest.fixture(params=[False, True], ids=['grouped', 'grouped_sparse'])
def grouped(request, monkeypatch):
    """Plan application with each class's coefficients as one dense product (the
    mode of small sub-blocks) or, with the limit set to 0, entry by entry (the mode
    of sub-blocks above ``GROUPED_MAX_BLOCK``)."""
    if request.param:
        monkeypatch.setattr(tree_moves, 'GROUPED_MAX_BLOCK', 0)
    tree_moves.batched_program.cache_clear()
    yield request.param
    tree_moves.batched_program.cache_clear()


def _leg(rng, is_dual=False, sectors=SECTORS):
    mults = rng.integers(1, 3, size=len(sectors))
    return ct.ElementarySpace(ct.su2_symmetry, sectors, mults, is_dual=is_dual)


def _backend():
    return ct.get_backend(ct.su2_symmetry, 'numpy')


def random_su2(rng, codomain, domain, labels):
    return ct.SymmetricTensor.from_random_normal(codomain, domain, backend=_backend(),
                                                 labels=labels, rng=rng)


def _four_leg(seed=0, values_seed=None):
    """A random [a, b | d, c] tensor with a dual leg on each side: legs from
    ``seed``, values from ``values_seed`` (default: the same)."""
    rng = np.random.default_rng(seed)
    legs = [_leg(rng), _leg(rng, True), _leg(rng), _leg(rng, True)]
    if values_seed is not None:
        rng = np.random.default_rng(values_seed)
    return random_su2(rng, legs[:2], legs[2:], ['a', 'b', 'c', 'd'])


def _same(p, j):
    assert p.labels == j.labels
    np.testing.assert_array_equal(np.asarray(p.data.block_inds),
                                  np.asarray(j.data.block_inds))
    np.testing.assert_allclose(p.to_numpy(), j.to_numpy(), **TOL)


def test_round_trip_exact():
    t = _four_leg()
    p = to_port(t)
    assert isinstance(p.backend, FusionTreeBackend)
    p.test_sanity()
    assert export_tensor(t)['symmetry'] == ['SU2']
    np.testing.assert_array_equal(p.to_numpy(), t.to_numpy())  # no arithmetic


PERMUTATIONS = [
    (['a'], ['c', 'd', 'b']),      # bend b down
    (['a', 'b', 'c'], ['d']),      # bend c up
    (['b', 'a'], ['c', 'd']),      # braid in the codomain
    (['d', 'a'], ['c', 'b']),      # bends and braids
    ([], ['a', 'b', 'c', 'd'][::-1]),  # everything down
    (['c', 'd', 'a', 'b'], []),    # everything up, cyclically
]


@pytest.mark.parametrize('codomain, domain', PERMUTATIONS)
def test_permute_legs(grouped, codomain, domain):
    t = _four_leg(1)
    _same(pt.permute_legs(to_port(t), codomain, domain),
          jt.permute_legs(t, codomain, domain))


def test_compose_is_one_grouped_gemm(grouped, monkeypatch):
    """``compose`` sends its per-coupled-sector pairs as one grouped-GEMM call,
    each pair with its own output."""
    import cyten_tpu_torch.backends.fusion_tree as ft

    rng = np.random.default_rng(2)
    a, b, x, c = _leg(rng), _leg(rng), _leg(rng), _leg(rng)
    A = random_su2(rng, [a, b], [x], ['a', 'b', 'x'])
    B = random_su2(rng, [x], [c], ['x*', 'c'])
    calls = []

    def counting(As, Bs, out_ids=None, n_out=None, pairs=None):
        calls.append(len(pairs[0]))
        return ft_grouped(As, Bs, out_ids, n_out, pairs)

    ft_grouped = ft.grouped_matmul
    monkeypatch.setattr(ft, 'grouped_matmul', counting)
    got = pt.compose(to_port(A), to_port(B))
    assert calls == [len(got.data.blocks)] and calls[0] > 1
    _same(got, jt.compose(A, B))


def test_tdot(grouped):
    rng = np.random.default_rng(3)
    a, b, c, d, e = (_leg(rng) for _ in range(5))
    T1 = random_su2(rng, [a, b], [c], ['a', 'b', 'c'])
    T2 = random_su2(rng, [c, d], [e], ['c*', 'd', 'e'])
    _same(pt.tdot(to_port(T1), to_port(T2), 'c', 'c*'), jt.tdot(T1, T2, 'c', 'c*'))
    T3 = random_su2(rng, [a.dual, b.dual], [e], ['a*', 'b*', 'e'])
    _same(pt.tdot(to_port(T1), to_port(T3), ['a', 'b'], ['a*', 'b*']),
          jt.tdot(T1, T3, ['a', 'b'], ['a*', 'b*']))


def test_norm_and_inner():
    """qdim-weighted norm and inner product, both daggered and not."""
    t, u = _four_leg(4), _four_leg(4, values_seed=5)
    assert abs(pt.norm(to_port(t)) - jt.norm(t)) < 1e-12 * jt.norm(t)
    assert abs(pt.inner(to_port(t), to_port(u)) - jt.inner(t, u)) < 1e-12 * jt.norm(t) * jt.norm(u)
    ud = jt.dagger(u)
    got = pt.inner(to_port(t), to_port(ud), do_dagger=False)
    assert abs(got - jt.inner(t, ud, do_dagger=False)) < 1e-12 * jt.norm(t) * jt.norm(u)
    # the weight is the quantum dimension: norm^2 is sum_c d_c |block_c|^2
    p = to_port(t)
    qd = [p.symmetry.qdim(p.codomain.sector_decomposition[i]) for i, _ in p.data.block_inds]
    weighted = sum(q * float((b ** 2).sum()) for q, b in zip(qd, p.data.blocks))
    assert abs(pt.norm(p) ** 2 - weighted) < 1e-12 * weighted


def test_decompositions(grouped):
    """svd, qr and eigh: the gauge-free parts against cyten_tpu, and the products
    back to the tensor."""
    t = _four_leg(6)
    p = to_port(t)
    U, S, Vh = pt.svd(p, new_labels=['x', 'x*'])
    Uj, Sj, Vhj = jt.svd(t, new_labels=['x', 'x*'])
    np.testing.assert_allclose(np.sort(np.diag(S.to_numpy())),
                               np.sort(np.diag(Sj.to_numpy())), **TOL)
    np.testing.assert_allclose(pt.compose(pt.compose(U, S), Vh).to_numpy(), t.to_numpy(),
                               **TOL)
    Q, R = pt.qr(p, new_labels=['y', 'y*'])
    Qj, Rj = jt.qr(t, new_labels=['y', 'y*'])
    np.testing.assert_allclose(np.abs(R.to_numpy()), np.abs(Rj.to_numpy()), **TOL)
    np.testing.assert_allclose(pt.compose(Q, R).to_numpy(), t.to_numpy(), **TOL)
    H = pt.compose(p, pt.dagger(p))  # hermitian [a, b | b*, a*]
    W, V = pt.eigh(H, new_labels=['z', 'z*'])
    Wj, Vj = jt.eigh(jt.compose(t, jt.dagger(t)), new_labels=['z', 'z*'])
    np.testing.assert_allclose(np.sort(np.diag(W.to_numpy())),
                               np.sort(np.diag(Wj.to_numpy())), **TOL)
    np.testing.assert_allclose(
        pt.compose(pt.compose(V, W), pt.dagger(V)).to_numpy(), H.to_numpy(), **TOL)


def test_other_operations(grouped):
    """The rest of the backend the port keeps: outer products, partial traces,
    scale_axis, truncation masks and the dense conversions."""
    rng = np.random.default_rng(7)
    a, b = _leg(rng), _leg(rng)
    T1 = random_su2(rng, [a], [b], ['a', 'b'])
    T2 = random_su2(rng, [b], [a], ['c', 'd'])
    _same(pt.outer(to_port(T1), to_port(T2)), jt.outer(T1, T2))
    c = _leg(rng, True)
    T = random_su2(rng, [a, b], [c, a], ['a', 'b', 'a*', 'c'])  # a* pairs with a
    _same(pt.partial_trace(to_port(T), ('a', 'a*')), jt.partial_trace(T, ('a', 'a*')))
    t = _four_leg(8)
    _, S, _ = jt.svd(t, new_labels=['x', 'x*'])
    U = random_su2(rng, [a, b], [S.leg], ['a', 'b', 'x'])
    _same(pt.scale_axis(to_port(U), to_port(S), 'x'), jt.scale_axis(U, S, 'x'))
    mask_j, err_j, _ = jt.truncate_singular_values(S, chi_max=3)
    mask_p, err_p, _ = pt.truncate_singular_values(to_port(S), chi_max=3)
    assert abs(err_p - err_j) < 1e-12
    np.testing.assert_array_equal(mask_p.to_numpy(), mask_j.to_numpy())
    dense = t.to_numpy()
    back = pt.SymmetricTensor.from_dense_block(dense, to_port(t).codomain,
                                               to_port(t).domain,
                                               backend=to_port(t).backend,
                                               labels=t.labels)
    _same(back, t)


def _ops():
    """name -> op(tensors module, four-leg tensor, its singular values): the rest of
    the tensor API that reaches the fusion-tree backend."""

    def hermitian(m, t):
        return m.compose(t, m.dagger(t))  # [a, b | b*, a*]

    def masks(m, S):
        """Two masks that keep whole multiplets: the values above the median, and
        those above the lowest third."""
        s = S.to_numpy().diagonal()
        return tuple(m.Mask.from_block_mask(s > np.quantile(s, q), S.leg,
                                            backend=S.backend) for q in (0.5, 0.3))

    return {
        'eye': lambda m, t, S: m.SymmetricTensor.from_eye(t.codomain.factors,
                                                          backend=t.backend),
        'sector_projection': lambda m, t, S: m.SymmetricTensor.from_sector_projection(
            t.codomain, np.array([1]), backend=t.backend),
        'trace': lambda m, t, S: m.trace(hermitian(m, t)),
        'lq': lambda m, t, S: m.compose(*m.lq(t, new_labels=['y', 'y*'])),
        'exp': lambda m, t, S: m.exp(m.scalar_multiply(0.1, hermitian(m, t))),
        'diagonal_ops': lambda m, t, S: m.sqrt(S) + S * S,
        'diagonal_from_tensor': lambda m, t, S: m.DiagonalTensor.from_tensor(
            m.SymmetricTensor.from_eye([S.leg], backend=S.backend)),
        'mask_ops': lambda m, t, S: ((lambda a, b: (a & b) | ~a)(*masks(m, S))
                                     ).as_SymmetricTensor(),
        'apply_and_enlarge': lambda m, t, S: (lambda U, k: m.enlarge_leg(
            m.apply_mask(U, k, 'x'), k, 'x'))(m.svd(t, new_labels=['x', 'x*'])[0],
                                              masks(m, S)[0]),
        'combine_legs': lambda m, t, S: m.combine_legs(t, ['a', 'b']),
        'combine_split': lambda m, t, S: m.split_legs(m.combine_legs(t, ['a', 'b'])),
        'trivial_legs': lambda m, t, S: m.squeeze_legs(
            m.add_trivial_leg(t, 1, label='t'), 't'),
    }


@pytest.mark.parametrize('op', list(_ops()))
def test_tensor_operations(op):
    t = _four_leg(9)
    S = jt.svd(t, new_labels=['x', 'x*'])[1]
    ref = _ops()[op](jt, t, S)
    got = _ops()[op](pt, to_port(t), to_port(S))
    if np.ndim(ref) == 0 and not hasattr(ref, 'to_numpy'):
        assert abs(got - ref) < 1e-12 * max(1., abs(ref))
        return
    assert got.labels == ref.labels
    # 1e-12 relative to the tensor's largest entry (exp reaches 1e2)
    ref = ref.to_numpy()
    np.testing.assert_allclose(got.to_numpy(), ref, rtol=0,
                               atol=1e-12 * max(1., np.abs(ref).max()))
