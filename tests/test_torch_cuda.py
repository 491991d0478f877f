"""The port's CUDA kernels and its static step on the card, against their plain
versions and the CPU.

Marked ``cuda``: they skip without a card. This file imports no JAX at module level,
so it also runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's conftest.py
imports JAX). Its one CPU test, the FLOP count against cyten_tpu, skips there.
"""

import numpy as np
import pytest
import torch

from cyten_tpu_torch import get_backend, u1_symmetry
from cyten_tpu_torch.algorithms.dmrg import HEffective, _get_static_bond_fn
from cyten_tpu_torch.bench import build_step_state, build_workload, step_flops
from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul, grouped_matmul_plain
from cyten_tpu_torch.blocks.probe import scale2, scale2_plain

SHAPES = [(37, 130, 65), (256, 128, 300), (5, 7, 9), (140, 260, 129), (37, 3, 65)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32, torch.bfloat16])
def test_grouped_gemm_matches_plain(card, dtype):
    rng = np.random.default_rng(4)
    As = [torch.from_numpy(rng.normal(size=(M, K))).to(card, dtype) for M, K, N in SHAPES]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).to(card, dtype) for M, K, N in SHAPES]
    out_ids = [0, 1, 2, 3, 0]  # the last pair sums into the first output
    before = grouped_matmul.launches
    got = grouped_matmul(As, Bs, out_ids)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    ref = grouped_matmul_plain(As, Bs, out_ids)
    # relative to each output's largest entry: f64 to rounding, f32 as
    # tests/test_pallas_grouped.py, bf16 to one rounding of the output
    rtol, atol = {torch.float64: (1e-12, 0.), torch.float32: (2e-5, 2e-4),
                  torch.bfloat16: (2e-2, 0.)}[dtype]
    for c, r in zip(got, ref):
        assert c.dtype == dtype and c.shape == r.shape
        err = float((c.double() - r.double()).abs().max())
        assert err <= atol + rtol * float(r.double().abs().max())


# the ragged lists of tests/test_torch_grouped_gemm.py: name -> (shapes, out_ids)
RAGGED = {
    'k_odd': ([(37, 131, 65), (64, 295, 40), (3, 1, 5)], [0, 1, 2]),
    'k_not_multiple_of_8': ([(130, 6, 70), (20, 10, 129), (129, 1462, 3)], [0, 1, 2]),
    'below_one_tile': ([(5, 3, 7), (1, 1, 1), (127, 15, 63), (2, 60, 127)], [0, 1, 2, 3]),
    'twenty_into_one': ([(70, k, 90) for k in range(1, 41, 2)], [0] * 20),
    'all_k_zero': ([(30, 0, 20), (30, 0, 20), (9, 4, 11)], [0, 0, 1]),
    # more table rows than fit in the launch's parameters
    'six_hundred_pairs': ([(9, 1 + k % 7, 5) for k in range(600)], [k // 2 for k in range(600)]),
}
TOL = {torch.float64: (1e-12, 0.), torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-2, 0.)}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(RAGGED))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32, torch.bfloat16])
def test_grouped_gemm_ragged_lists(card, case, dtype):
    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(6)
    As = [torch.from_numpy(rng.normal(size=(M, K))).to(card, dtype) for M, K, N in shapes]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).to(card, dtype) for M, K, N in shapes]
    got = grouped_matmul(As, Bs, out_ids)
    ref = grouped_matmul_plain(As, Bs, out_ids)
    torch.cuda.synchronize()
    rtol, atol = TOL[dtype]  # as in test_grouped_gemm_matches_plain
    for c, r in zip(got, ref):
        assert c.dtype == dtype and c.shape == r.shape
        err = float((c.double() - r.double()).abs().max())
        assert err <= atol + rtol * float(r.double().abs().max())


@pytest.mark.cuda
def test_grouped_gemm_indexed_pairs(card):
    """Distinct operands with ``pairs`` (as the abelian backend passes them) give what
    the expanded pair lists give, in one launch."""
    rng = np.random.default_rng(9)
    As = [torch.from_numpy(rng.normal(size=(70, k))).to(card) for k in (33, 130)]
    Bs = [torch.from_numpy(rng.normal(size=(k, 90))).to(card) for k in (33, 130, 33)]
    a_index, b_index, out_ids = [0, 1, 0, 0], [0, 1, 2, 2], [0, 0, 1, 2]
    before = grouped_matmul.launches
    got = grouped_matmul(As, Bs, out_ids, pairs=(np.array(a_index), np.array(b_index)))
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    ref = grouped_matmul_plain([As[i] for i in a_index], [Bs[i] for i in b_index], out_ids)
    for c, r in zip(got, ref):
        assert float((c - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.cuda
def test_grouped_gemm_strided_rows(card):
    """Operands with a row pitch other than their width are read where they lie."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.normal(size=(70, 40))).to(card)[:, 3:36]
    B = torch.from_numpy(rng.normal(size=(33, 90))).to(card)[:, :81]
    (c,) = grouped_matmul([A], [B])
    torch.cuda.synchronize()
    assert float((c - A @ B).abs().max()) <= 1e-12 * float((A @ B).abs().max())


@pytest.mark.cuda
def test_grouped_gemm_casts_what_it_cannot_read(card):
    """An operand of another dtype or with a column stride is copied once, however
    many pairs read it; the list takes the promoted dtype."""
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.normal(size=(40, 70))).to(card, torch.float32).t()  # [70, 40]
    Bs = [torch.from_numpy(rng.normal(size=(40, n))).to(card) for n in (9, 130)]
    got = grouped_matmul([A], Bs, [0, 1], pairs=(np.array([0, 0]), np.array([0, 1])))
    torch.cuda.synchronize()
    for c, B in zip(got, Bs):
        ref = A.double() @ B
        assert c.dtype == torch.float64
        assert float((c - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
def test_scale2_unaligned_tail(card):
    y = torch.from_numpy(np.random.default_rng(8).normal(size=1031)).to(card, torch.float32)
    for t in (y, y[1:], y[3:1030]):  # n % 4 != 0, and arrays off 16-byte alignment
        assert torch.equal(scale2(t), scale2_plain(t))


@pytest.mark.cuda
def test_grouped_gemm_refuses_complex(card):
    a = torch.zeros(3, 3, dtype=torch.complex128, device=card)
    with pytest.raises(NotImplementedError):
        grouped_matmul([a], [a])


@pytest.mark.cuda
def test_scale2_matches_plain(card):
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(256, 256))).to(
        card, torch.float32)
    before = scale2.launches
    got = scale2(x)
    torch.cuda.synchronize()
    assert scale2.launches == before + 1
    assert torch.equal(got, scale2_plain(x))  # x * 2 is exact in f32
    with pytest.raises(NotImplementedError):
        scale2(x.double())


@pytest.mark.cuda
def test_static_step_card_matches_cpu(card):
    """One steady static bond update of build_step_state at chi=64, f64: the same
    host-drawn inputs on the card and on the CPU."""
    out = {}
    for device in ('cuda', 'cpu'):
        LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
            get_backend(u1_symmetry, device=device), 64)
        before = grouped_matmul.launches
        out[device] = _get_static_bond_fn(10, 'steady')(HEffective(LP, RP, W1, W2), S,
                                                         B1, B2, tmpl, None)
        if device == 'cuda':
            assert grouped_matmul.launches > before
    (E, _, S, *_), (E_cpu, _, S_cpu, *_) = out['cuda'], out['cpu']
    # f64 sums in another order: energies to 1e-9 relative, S to 1e-8
    assert abs(E - E_cpu) < 1e-9 * abs(E_cpu)
    np.testing.assert_allclose(S.to_numpy(), S_cpu.to_numpy(), rtol=0, atol=1e-8)


def test_step_flops_matches_cyten_tpu():
    """The step's FLOP count equals bench.py:759-775's on build_workload(chi=64)."""
    pytest.importorskip('jax')
    import bench as jax_bench
    import cyten_tpu as ct
    from cyten_tpu.tensors import tdot
    from cyten_tpu.tools.flops import tdot_flops

    LP, RP, W1, W2, theta = jax_bench.build_workload(
        ct.get_backend(ct.u1_symmetry, 'numpy'), chi=64)
    ref = tdot_flops(LP, theta, ['vR'], ['vL'])
    x = tdot(LP, theta, 'vR', 'vL')
    ref += tdot_flops(x, W1, ['wR', 'p0'], ['wL', 'p0*'])
    x = tdot(x, W1, ['wR', 'p0'], ['wL', 'p0*'])
    ref += tdot_flops(x, W2, ['wR', 'p1'], ['wL', 'p1*'])
    x = tdot(x, W2, ['wR', 'p1'], ['wL', 'p1*'])
    ref += tdot_flops(x, RP, ['vR', 'wR'], ['vL', 'wL'])
    args = build_workload(get_backend(u1_symmetry, device='cpu'), 64)
    assert step_flops(*args, n_lanczos=10) == ref * 12
