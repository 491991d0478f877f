"""The port's CUDA kernels and its static step on the card, against their plain
versions and the CPU.

Marked ``cuda``: they skip without a card. This file imports no JAX at module level,
so it also runs on a machine without it:
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's conftest.py
imports JAX). Its one CPU test, the FLOP count against cyten_tpu, skips there.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from cyten_tpu_torch import Dtype, get_backend, u1_symmetry
from cyten_tpu_torch.algorithms import (
    DMRGEngine, SimpleMPS, TFIModel, tfi_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import HEffective, _get_static_bond_fn, _GraphedStep
from cyten_tpu_torch.blocks import _kernels
from cyten_tpu_torch.bench import (
    HUBBARD_KINDS, build_step_state, build_workload, recorded_lists, step_flops,
)
from cyten_tpu_torch.blocks.grouped_gemm import (
    grouped_matmul, grouped_matmul_plain, grouped_matmul_plan,
)
from cyten_tpu_torch.blocks.probe import scale2, scale2_plain
from cyten_tpu_torch.blocks.tridiag import (
    tridiagonal_ground_state, tridiagonal_ground_state_plain,
)
from test_torch_tridiag import FAMILIES, check_ground_state

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
    """complex64, which no path of the port produces, has no kind and raises (a
    complex64 operand beside an f32 one too); complex128 has one."""
    a = torch.zeros(3, 3, dtype=torch.complex64, device=card)
    with pytest.raises(NotImplementedError):
        grouped_matmul([a], [a])
    with pytest.raises(NotImplementedError):
        grouped_matmul([a], [a.real.contiguous()])


def _complex_close(got, ref, As, Bs, out_ids):
    """Each element of a complex128 result within 2 K 2^-52 (|A||B|)_ij of the plain
    version's, K the summed depth of the output's pairs (each side's f64 rounding
    is at most half of that)."""
    mag = grouped_matmul_plain([A.abs().double() for A in As],
                               [B.abs().double() for B in Bs], out_ids)
    ks = np.zeros(len(ref))
    np.add.at(ks, np.asarray(out_ids), [A.shape[1] for A in As])
    for c, r, m, k in zip(got, ref, mag, ks):
        assert c.dtype == torch.complex128 and c.shape == r.shape
        assert bool(((c - r).abs() <= 2 * k * 2. ** -52 * m).all())


def _draw(rng, shape, cplx: bool, device):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape) if cplx else rng.normal(size=shape)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(RAGGED))
@pytest.mark.parametrize('sides', ['complex', 'real_x_complex', 'complex_x_real'])
def test_grouped_gemm_complex_ragged_lists(card, case, sides):
    """The complex128 kind on the ragged lists, with both operands complex or one of
    them real (copied to complex128 by the wrapper): one launch, counted as a
    complex128 one, within rounding of the plain version."""
    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(12)
    a_cplx, b_cplx = sides != 'complex_x_real', sides != 'real_x_complex'
    As = [_draw(rng, (M, K), a_cplx, card) for M, K, N in shapes]
    Bs = [_draw(rng, (K, N), b_cplx, card) for M, K, N in shapes]
    kind = grouped_matmul.kinds['complex128']
    before, kind_before = grouped_matmul.launches, kind.launches
    got = grouped_matmul(As, Bs, out_ids)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1 and kind.launches == kind_before + 1
    _complex_close(got, grouped_matmul_plain(As, Bs, out_ids), As, Bs, out_ids)


@pytest.mark.cuda
def test_grouped_gemm_complex_empty_lists(card):
    """An empty list gives no outputs; outputs with no rows are complex128 and
    launch nothing."""
    assert grouped_matmul([], []) == []
    A = torch.zeros(0, 5, dtype=torch.complex128, device=card)
    B = torch.ones(5, 7, dtype=torch.complex128, device=card)
    before = grouped_matmul.launches
    (c,) = grouped_matmul([A], [B])
    assert c.shape == (0, 7) and c.dtype == torch.complex128 and c.is_cuda
    assert grouped_matmul.launches == before


@pytest.mark.cuda
def test_grouped_gemm_complex_reads_conjugate_views(card):
    """A conjugate or negative view (its memory holds the values before that
    operation) and a transposed complex operand give what their values give."""
    rng = np.random.default_rng(13)
    A = _draw(rng, (40, 70), True, card)
    B = _draw(rng, (33, 70), True, card)
    for a, b in ((A.conj(), B.t()), (-A.conj(), B.mH), (A.conj().t().mH, B.t().conj())):
        (c,) = grouped_matmul([a], [b])
        torch.cuda.synchronize()
        ref = a.resolve_conj().resolve_neg() @ b.resolve_conj().resolve_neg()
        assert float((c - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


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
    assert abs(float(E) - float(E_cpu)) < 1e-9 * abs(float(E_cpu))
    np.testing.assert_allclose(S.to_numpy(), S_cpu.to_numpy(), rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize('n, closes', [(1, None), (10, None), (20, None), (10, 4), (20, 11),
                                       (64, None)])
def test_tridiag_matches_plain(card, n, closes):
    """The kernel against its plain version on the CPU: E to 1e-12 relative, the
    coefficients (sign fixed by both) to 1e-10; ``closes``: a vanishing beta there."""
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=n), 0.1 + np.abs(rng.normal(size=n))
    if closes is not None:
        b[closes] = 1e-14
        a[closes + 1:] = 1e3 * rng.normal(size=n - closes - 1)
    ab = torch.from_numpy(np.stack([a, b]))
    before = tridiagonal_ground_state.launches
    E, c = tridiagonal_ground_state(ab.to(card))
    torch.cuda.synchronize()
    assert tridiagonal_ground_state.launches == before + 1
    E_ref, c_ref = tridiagonal_ground_state_plain(ab)
    assert abs(float(E) - float(E_ref)) <= 1e-12 * abs(float(E_ref))
    np.testing.assert_allclose(c.cpu().numpy(), c_ref.numpy(), rtol=0, atol=1e-10)
    with pytest.raises(ValueError):
        tridiagonal_ground_state(torch.zeros(2, 65, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):  # not contiguous
        tridiagonal_ground_state(torch.zeros(10, 2, device=card, dtype=torch.float64).T)
    with pytest.raises(NotImplementedError):
        tridiagonal_ground_state(ab.to(card, torch.bfloat16))


@pytest.mark.cuda
def test_tridiag_matches_plain_past_one_warp(card):
    """N = 33..64, where each lane of the kernel's warp holds two entries, on three
    seeds each, random and with a closing Krylov space: the kernel against its plain
    version."""
    for n in range(33, 65):
        for seed in range(3):
            rng = np.random.default_rng(1000 * n + seed)
            a, b = rng.normal(size=n), 0.1 + np.abs(rng.normal(size=n))
            if seed == 2:
                k = int(rng.integers(1, n - 1))
                b[k] = 1e-14
                a[k + 1:] = 1e3 * rng.normal(size=n - k - 1)
            ab = torch.from_numpy(np.stack([a, b]))
            E, c = tridiagonal_ground_state(ab.to(card))
            E_ref, c_ref = tridiagonal_ground_state_plain(ab)
            assert abs(float(E) - float(E_ref)) <= 1e-12 * abs(float(E_ref)), (n, seed)
            np.testing.assert_allclose(c.cpu().numpy(), c_ref.numpy(), rtol=0, atol=1e-10,
                                       err_msg=f'N={n}, seed {seed}')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_tridiag_families_match_plain(card, dtype):
    """The kernel on every family of tests/test_torch_tridiag.py, from an f64 and an
    f32 buffer, against its plain version on the same values: E to 1e-12 relative;
    the coefficients to 1e-10 where the lowest gap is at least 1e-8 |T|, else the
    residual to 1e-13 |T|. One launch counted per call."""
    for label, ab in FAMILIES:
        t = torch.from_numpy(ab).to(dtype)
        before = tridiagonal_ground_state.launches
        E, c = tridiagonal_ground_state(t.to(card))
        torch.cuda.synchronize()
        assert tridiagonal_ground_state.launches == before + 1
        assert E.dtype == c.dtype == torch.float64
        check_ground_state(E.cpu(), c.cpu().numpy(), t.double().numpy(),
                           ref=tridiagonal_ground_state_plain(t), label=label)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_tridiag_non_finite_input_gives_nan(card, dtype):
    """A non-finite entry of the matrix (a valid alpha, a valid beta, or a NaN beta,
    which closes the space and makes the shift NaN) turns every output NaN; a NaN
    among the garbage alphas after a closing beta does not enter the matrix."""
    rng = np.random.default_rng(3)
    ab = np.stack([rng.normal(size=10), 0.1 + np.abs(rng.normal(size=10))])
    for row, k, value in ((0, 3, np.nan), (1, 2, np.inf), (1, 5, np.nan), (0, 9, np.inf)):
        bad = ab.copy()
        bad[row, k] = value
        E, c = tridiagonal_ground_state(torch.from_numpy(bad).to(card, dtype))
        assert torch.isnan(E) and torch.isnan(c).all(), (row, k, value)
    closed = ab.copy()
    closed[1, 4] = 1e-14
    closed[0, 6] = np.nan
    t = torch.from_numpy(closed).to(dtype)
    E, c = tridiagonal_ground_state(t.to(card))
    check_ground_state(E.cpu(), c.cpu().numpy(), t.double().numpy(),
                       ref=tridiagonal_ground_state_plain(t))


@pytest.mark.cuda
def test_tridiag_captured_without_host_sync(card):
    """The kernel captured in a _kernels.Graph (capture_error_mode='global': a host
    sync would fail the capture), its launch counted at each replay, its result that
    of an eager call."""
    ab = torch.from_numpy(FAMILIES[-1][1]).to(card)
    E_ref, c_ref = tridiagonal_ground_state(ab)
    graph = _kernels.Graph()
    with graph.capture():
        E, c = tridiagonal_ground_state(ab)
    assert graph.launches == {tridiagonal_ground_state: 1}
    before = tridiagonal_ground_state.launches
    graph.replay()
    torch.cuda.synchronize()
    assert tridiagonal_ground_state.launches == before + 1
    assert float(E) == float(E_ref) and torch.equal(c, c_ref)


@pytest.mark.cuda
def test_lanczos_alpha_product_ignores_tf32(card):
    """fused_lanczos_impl writes each f32 alpha by a [1, n] x [n] torch.mv into its
    buffer: the product stays full f32 whatever the f32 matmul precision (TF32 would
    keep about three digits, and the Lanczos recurrence would lose the rest)."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.normal(size=30000)).to(card, torch.float32)
            for _ in range(2))
    out = torch.empty(2, device=card)
    old = torch.get_float32_matmul_precision()
    try:
        for i, precision in enumerate(('highest', 'medium')):
            torch.set_float32_matmul_precision(precision)
            torch.mv(a.view(1, -1), b, out=out[i:i + 1])
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(out[0], out[1])
    assert abs(float(out[0]) - float(a.double() @ b.double())) <= 1e-5 * float(
        a.double().norm() * b.double().norm())


@pytest.mark.cuda
def test_captured_static_bond_matches_eager(card):
    """A steady static bond update of build_step_state at chi=64, f64, captured as a
    CUDA graph and replayed twice (the second time after an eager update has run on
    other inputs) against the eager update on the same inputs: the same arithmetic,
    so to 1e-12; and the launches of the replays are counted."""
    LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(get_backend(u1_symmetry,
                                                                      device='cuda'), 64)
    impl = _get_static_bond_fn(10, 'steady')

    def fn(LP, RP, S, B1, B2, W1, W2):
        return impl(HEffective(LP, RP, W1, W2), S, B1, B2, tmpl, None)

    inputs = (LP, RP, S, B1, B2, W1, W2)
    ref = fn(*inputs)
    graph = _GraphedStep(fn, inputs)
    assert graph.graph.launches[grouped_matmul] > 0
    assert graph.graph.launches[tridiagonal_ground_state] == 1
    for _ in range(2):
        before = grouped_matmul.launches
        got = graph.run(inputs)
        torch.cuda.synchronize()
        assert grouped_matmul.launches == before + graph.graph.launches[grouped_matmul]
        assert abs(float(got[0]) - float(ref[0])) <= 1e-12 * abs(float(ref[0]))
        for g, r in zip(got[1:], ref[1:]):
            assert g.labels == r.labels
            np.testing.assert_allclose(g.to_numpy(), r.to_numpy(), rtol=0, atol=1e-12)
        fn(LP, RP, S, B2, B1, W1, W2)  # other work between the replays


@pytest.mark.cuda
def test_graph_replayed_for_bonds_of_one_structure(card):
    """TFI L=12, g=1.2, chi_max=8 bucketed to multiples of 4, static steady on the
    card: bonds of one structure share one graph, so fewer graphs are captured than
    there are bonds. Two sweeps that only replay graphs against two eager sweeps
    (cuda_graphs=False) from the same state: the same energies (1e-10), at the exact
    energy (1e-8)."""
    L, g = 12, 1.2
    model = TFIModel(L=L, J=1., g=g, conserve='parity', device='cuda')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-14, pad_chi_multiple=4)
    for _ in range(4):
        eng.sweep()
    eng.enable_static_mode(n_lanczos=20, svd_mode='steady')
    # the first static update of a bond gives its tensors their static structure; the
    # first update of each such structure runs eagerly, the next captures
    for _ in range(2):
        eng.sweep()
    graphs = eng.static_graphs()
    assert 0 < len(graphs) < L - 1
    state = (list(psi.Bs), list(psi.Ss), list(eng.LPs), list(eng.RPs))
    before = grouped_matmul.launches
    E_graph = [eng.sweep() for _ in range(2)]
    assert len(eng.static_graphs()) == len(graphs)  # replays only
    assert grouped_matmul.launches > before  # counted through the replays
    psi.Bs, psi.Ss, eng.LPs, eng.RPs = (list(x) for x in state)
    eng.enable_static_mode(n_lanczos=20, svd_mode='steady', cuda_graphs=False)
    E_eager = [eng.sweep() for _ in range(2)]
    np.testing.assert_allclose(E_graph, E_eager, rtol=0, atol=1e-10)
    assert abs(E_graph[-1] - tfi_exact_finite_gs_energy(L, 1., g)) < 1e-8


@pytest.mark.cuda
def test_captured_grouped_gemm_keeps_its_pinned_table(card):
    """A pair list whose table (7200 words) goes through pinned host memory, captured;
    another such list runs eagerly, then the replay is still right: the graph keeps
    its pinned table, which the host cache does not hand out again. The kernel
    launches on the capture stream."""
    rng = np.random.default_rng(9)
    shapes, out_ids = RAGGED['six_hundred_pairs']

    def pair_list():
        As = [torch.from_numpy(rng.normal(size=(M, K))).to(card) for M, K, N in shapes]
        Bs = [torch.from_numpy(rng.normal(size=(K, N))).to(card) for M, K, N in shapes]
        return As, Bs

    As, Bs = pair_list()
    graph = _kernels.Graph()
    with graph.capture():
        assert _kernels._current_stream(0) == torch.cuda.current_stream().cuda_stream
        outs = grouped_matmul(As, Bs, out_ids)
    # one launch, counted for the wrapper and for its kind (f64)
    kind = grouped_matmul.kinds['float64']
    assert graph.launches == {grouped_matmul: 1, kind: 1} and graph.keep
    As2, Bs2 = pair_list()
    other = grouped_matmul(As2, Bs2, out_ids)
    before, kind_before = grouped_matmul.launches, kind.launches
    graph.replay()
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1 and kind.launches == kind_before + 1
    for got, ref in ((outs, grouped_matmul_plain(As, Bs, out_ids)),
                     (other, grouped_matmul_plain(As2, Bs2, out_ids))):
        for c, r in zip(got, ref):
            assert float((c - r).abs().max()) <= 1e-12 * float(r.abs().max())


@pytest.mark.cuda
def test_no_garbage_collection_inside_a_capture(card):
    """A collection inside a capture could destroy another graph left in a reference
    cycle, which is illegal while the stream is captured: Graph.capture holds the
    collector off, and turns it back on after."""
    x = torch.ones(256, device=card)
    scale2(x)
    g = _kernels.Graph()
    assert gc.isenabled()
    with g.capture():
        assert not gc.isenabled()
        y = scale2(x)
    assert gc.isenabled()
    g.replay()
    assert torch.equal(y, x * 2)


@pytest.mark.cuda
def test_kernel_captured_outside_graph_raises(card):
    x = torch.ones(256, device=card)
    scale2(x)  # built and warmed up before the capture
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(g):
            scale2(x)


# the kinds that write f32 from rounded operands: (precision, A dtype, B dtype)
ROUNDED = [('tensorfloat32', torch.float32, torch.float32),
           ('tensorfloat32', torch.bfloat16, torch.float32),
           ('default', torch.float32, torch.float32),
           ('default', torch.float32, torch.bfloat16),
           ('float32', torch.bfloat16, torch.float32),
           ('float32', torch.float32, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(RAGGED))
@pytest.mark.parametrize('precision, a_dtype, b_dtype', ROUNDED)
def test_grouped_gemm_rounded_kinds(card, case, precision, a_dtype, b_dtype):
    """Each converting kind against its plain version: the operands rounded alike and
    the products exact in f32, so the two differ by the order of their f32 sums
    alone: K 2^-23 times the product of the rounded operands' magnitudes."""
    from cyten_tpu_torch.config import config

    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(8)
    As = [torch.from_numpy(rng.normal(size=(M, K))).to(card, a_dtype) for M, K, N in shapes]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).to(card, b_dtype) for M, K, N in shapes]
    kind = precision if precision != 'float32' else 'float32_mixed'
    before = grouped_matmul.kinds[kind].launches
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        got = grouped_matmul(As, Bs, out_ids)
    finally:
        config.matmul_precision = old
    ref = grouped_matmul_plain(As, Bs, out_ids, precision=precision)
    torch.cuda.synchronize()
    assert grouped_matmul.kinds[kind].launches == before + 1
    assert_within_sum_order(got, ref, As, Bs, out_ids, precision)


def assert_within_sum_order(got, ref, As, Bs, out_ids, precision):
    """Kernel (``got``) against plain (``ref``) for an f32 result of operands rounded
    for ``precision``: each element within K_o 2^-23 times the product of the rounded
    operands' magnitudes (K_o the summed depth of output o's pairs)."""
    from cyten_tpu_torch.blocks import grouped_gemm

    mag = grouped_matmul_plain([grouped_gemm._rounded(A, precision).abs().double()
                                for A in As],
                               [grouped_gemm._rounded(B, precision).abs().double()
                                for B in Bs], out_ids)
    ks = np.zeros(len(ref))
    np.add.at(ks, out_ids, [A.shape[1] for A in As])
    for o, (c, r, m) in enumerate(zip(got, ref, mag)):
        assert c.dtype == torch.float32 and c.shape == r.shape
        assert bool(((c.double() - r.double()).abs() <= ks[o] * 2. ** -23 * m).all())


def _misaligned(rng, rows, cols, pitch, dtype, device):
    """A [rows, cols] view with row pitch ``pitch`` whose first element lies one
    element past an aligned address: the staged kinds copy its rows from the aligned
    spans that hold them."""
    buf = torch.from_numpy(rng.normal(size=rows * pitch + 1)).to(device, dtype)
    return buf[1:].view(rows, pitch)[:, :cols]


# the lists the staged kinds' raw staging must get right: name -> a function of (rng,
# A dtype, B dtype, device) giving (As, Bs, out_ids)
def _hard_odd_pitches(rng, a_dtype, b_dtype, device):
    # K = 295 (the chi=4096 list's), odd pitches, bases one element past alignment
    As = [_misaligned(rng, 150, 295, 297, a_dtype, device),
          _misaligned(rng, 37, 131, 133, a_dtype, device)]
    Bs = [_misaligned(rng, 295, 140, 143, b_dtype, device),
          _misaligned(rng, 131, 65, 67, b_dtype, device)]
    return As, Bs, [0, 1]


def _hard_ragged(rng, a_dtype, b_dtype, device):
    # K not a multiple of BK = 32, K = 0 pairs, shared outputs, M < 64 and N < BN
    shapes = [(40, 33, 100), (40, 0, 100), (40, 95, 100), (5, 1, 7), (5, 0, 7), (130, 64, 129)]
    As = [torch.from_numpy(rng.normal(size=(M, K))).to(device, a_dtype) for M, K, N in shapes]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).to(device, b_dtype) for M, K, N in shapes]
    return As, Bs, [0, 0, 0, 1, 1, 2]


HARD = {'odd_pitches': _hard_odd_pitches, 'ragged': _hard_ragged}


STAGED_TILES = {'wide': (128, 256), 'narrow': (128, 128)}


@pytest.fixture(params=list(STAGED_TILES))
def width(request):
    """One of the staged kinds' two tiles, which ``grouped_matmul_plan(width=)``
    forces whatever the list."""
    return request.param
STAGED = [('tensorfloat32', torch.float32, torch.float32),
          ('tensorfloat32', torch.bfloat16, torch.float32),
          ('tensorfloat32', torch.float32, torch.bfloat16),
          ('default', torch.float32, torch.float32),
          ('default', torch.bfloat16, torch.float32),
          ('default', torch.float32, torch.bfloat16),
          ('float32', torch.bfloat16, torch.float32),
          ('float32', torch.float32, torch.bfloat16)]
# the kind each precision runs on a list with a bf16 operand
STAGED_KIND = {'tensorfloat32': 'tensorfloat32', 'default': 'default',
               'float32': 'float32_mixed'}
# the mixed kind's one tile
MIXED_TILE = (128, 128)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(HARD))
@pytest.mark.parametrize('precision, a_dtype, b_dtype', STAGED)
def test_staged_kinds_hard_lists(card, width, case, precision, a_dtype, b_dtype):
    """TF32 and the bf16 pass at each of their tiles, and the mixed kind's three bf16
    passes at its one (which refuses the 'wide' width), on lists whose rows start
    anywhere: the views reach the kernel as they lie (the table holds their own
    pointers and pitches) and the result is the plain version's to within the order
    of the sums."""
    from cyten_tpu_torch.config import config

    As, Bs, out_ids = HARD[case](np.random.default_rng(14), a_dtype, b_dtype, card)
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        if precision == 'float32':
            with pytest.raises(ValueError):
                grouped_matmul_plan(As, Bs, out_ids, width=width)
        outs, launch = grouped_matmul_plan(
            As, Bs, out_ids, width='tiled' if precision == 'float32' else width)
    finally:
        config.matmul_precision = old
    table = launch.operands[2]
    n_out = max(out_ids) + 1
    assert launch.tile == (MIXED_TILE if precision == 'float32' else STAGED_TILES[width])
    assert {(A.data_ptr(), A.stride(0)) for A in As} == set(map(tuple, table[n_out:, 0:2]))
    assert {(B.data_ptr(), B.stride(0)) for B in Bs} == set(map(tuple, table[n_out:, 2:4]))
    kind = grouped_matmul.kinds[STAGED_KIND[precision]]
    before = kind.launches
    launch()
    torch.cuda.synchronize()
    assert kind.launches == before + 1
    ref = grouped_matmul_plain(As, Bs, out_ids, precision=precision)
    assert_within_sum_order(outs, ref, As, Bs, out_ids, precision)


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['tensorfloat32', 'default'])
def test_staged_kinds_replay_in_a_graph(card, width, precision):
    """A staged kind captured in a CUDA graph reads its operands anew at each replay."""
    from cyten_tpu_torch.config import config

    rng = np.random.default_rng(15)
    As, Bs, out_ids = _hard_odd_pitches(rng, torch.float32, torch.float32, card)
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        grouped_matmul_plan(As, Bs, out_ids, width=width)[1]()  # set up before the capture
        graph = _kernels.Graph()
        with graph.capture():
            outs = grouped_matmul_plan(As, Bs, out_ids, width=width)[1]()
    finally:
        config.matmul_precision = old
    assert graph.launches == {grouped_matmul: 1, grouped_matmul.kinds[precision]: 1}
    for _ in range(2):
        for X in (*As, *Bs):
            X.copy_(torch.from_numpy(rng.normal(size=tuple(X.shape))))
        graph.replay()
        torch.cuda.synchronize()
        ref = grouped_matmul_plain(As, Bs, out_ids, precision=precision)
        assert_within_sum_order(outs, ref, As, Bs, out_ids, precision)


def midpoint_operands(rng, shapes):
    """f32 operands whose 13 bits below TF32's last kept bit are 0x1001, just above the
    rounding midpoint, all of one sign: rounding to nearest (cvt.rna, round_tf32) and
    truncation (what wgmma .tf32 does to raw f32 bits) differ by about one TF32 unit
    in every value, the same way."""
    def draw(r, c):
        bits = torch.from_numpy(np.abs(rng.normal(size=(r, c)))).float().view(torch.int32)
        return ((bits & ~0x1FFF) | 0x1001).view(torch.float32)
    return [draw(M, K) for M, K, N in shapes], [draw(K, N) for M, K, N in shapes]


@pytest.mark.cuda
def test_tf32_rounds_above_the_midpoint(card, width):
    """The TF32 kind rounds each operand to nearest before its products: on operands
    just above the midpoint it holds the plain version's bound, which truncated
    operands miss by far (checked here on the CPU), so a kernel that skipped its
    rounding pass fails."""
    from cyten_tpu_torch.blocks import grouped_gemm
    from cyten_tpu_torch.config import config

    shapes = [(150, 295, 140), (70, 40, 90)]
    As, Bs = midpoint_operands(np.random.default_rng(16), shapes)
    out_ids = [0, 1]
    ref = grouped_matmul_plain(As, Bs, out_ids, precision='tensorfloat32')
    truncated = grouped_matmul_plain([(A.view(torch.int32) & ~0x1FFF).view(torch.float32)
                                      for A in As],
                                     [(B.view(torch.int32) & ~0x1FFF).view(torch.float32)
                                      for B in Bs], out_ids)
    with pytest.raises(AssertionError):
        assert_within_sum_order(truncated, ref, As, Bs, out_ids, 'tensorfloat32')
    old = config.matmul_precision
    config.matmul_precision = 'tensorfloat32'
    try:
        got = grouped_matmul_plan([A.to(card) for A in As], [B.to(card) for B in Bs], out_ids,
                                  width=width)[1]()
    finally:
        config.matmul_precision = old
    torch.cuda.synchronize()
    assert grouped_gemm.round_tf32(As[0]).ne(As[0]).all()
    assert_within_sum_order([c.cpu() for c in got], ref, As, Bs, out_ids, 'tensorfloat32')


def mixed_lists(rng, device):
    """The mixed kind's own lists: name -> (As, Bs, out_ids). 'fine_bits': bf16 A
    against f32 B whose values 1 + j 2^-20 lie between bf16 values, so that B's mid and
    lo pieces carry its low bits; 'deep': ragged K of 4096 and more, summed into one
    output; 'per_pair': bf16 x f32, f32 x bf16 and bf16 x bf16 (one pass) in one
    list, with shared outputs; 'f32_pair': the same with a pair of two f32 operands,
    which the f32 kind runs; 'tiny': f32 values from 2^-118 to 2^-108 on either side,
    whose lo pieces need the kernel's scale of 2^24."""
    def draw(shape, dtype):
        return torch.from_numpy(rng.normal(size=shape)).to(device, dtype)

    def fine(shape):
        return torch.from_numpy(1 + rng.integers(1, 1 << 20, size=shape) * 2. ** -20).to(
            device, torch.float32)

    def tiny(shape):
        return torch.from_numpy(rng.uniform(1, 2, size=shape) * 2. ** rng.integers(
            -118, -108, size=shape) * rng.choice([-1., 1.], size=shape)).to(device,
                                                                          torch.float32)

    shapes = [(150, 295, 140), (70, 40, 90)]
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = [(bf16, f32), (f32, bf16), (bf16, bf16), (f32, bf16), (bf16, f32)]
    mixed = [(40, 33, 100), (40, 64, 100), (40, 95, 100), (130, 70, 129), (130, 7, 129)]
    f32_pair = [(f32, f32)] + kinds[1:]
    return {
        'fine_bits': ([draw((M, K), bf16) for M, K, N in shapes],
                      [fine((K, N)) for M, K, N in shapes], [0, 1]),
        'deep': ([draw((130, 4100), bf16), draw((130, 5000), bf16)],
                 [draw((4100, 200), f32), draw((5000, 200), f32)], [0, 0]),
        'per_pair': ([draw((M, K), a) for (M, K, N), (a, b) in zip(mixed, kinds)],
                     [draw((K, N), b) for (M, K, N), (a, b) in zip(mixed, kinds)],
                     [0, 0, 0, 1, 1]),
        'f32_pair': ([draw((M, K), a) for (M, K, N), (a, b) in zip(mixed, f32_pair)],
                     [draw((K, N), b) for (M, K, N), (a, b) in zip(mixed, f32_pair)],
                     [0, 0, 0, 1, 1]),
        'tiny': ([draw((150, 37), bf16), tiny((70, 40))],
                 [tiny((37, 140)), draw((40, 90), bf16)], [0, 1]),
    }


# the mixed kind's sums against the exact ones: sum((C - exact) sign(exact)) / sum|exact|
# within this. One accumulator over the whole depth leans toward zero by some K 2^-26
# (2e-5 at K = 9100); the kernel's sum of slices by that of one slice (1e-7)
MIXED_LEAN = 2. ** -20


def sum_lean(got, As, Bs, out_ids) -> float:
    """How far the sums ``got`` lean toward zero against the exact (f64) sums of the
    same operands, relative to their size: below zero for a lean toward zero."""
    exact = grouped_matmul_plain([A.double() for A in As], [B.double() for B in Bs], out_ids)
    lean = sum(float(((c.double() - r) * r.sign()).sum()) for c, r in zip(got, exact))
    return lean / sum(float(r.abs().sum()) for r in exact)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['fine_bits', 'deep', 'per_pair', 'f32_pair', 'tiny'])
def test_mixed_kind_passes(card, case):
    """The mixed kind ('float32' with a bf16 operand) on the lists its three bf16
    passes must get right: the f32 operand's low bits (which one bf16 pass rounds
    away past the bound, checked on the card's plain version), depths in the
    thousands, whose sums must not lean toward zero (MIXED_LEAN), a list mixing f32
    and bf16 pair by pair, and values near the bottom of f32's normal range. A list
    with a pair of two f32 operands runs on the f32 kind."""
    from cyten_tpu_torch.config import config

    As, Bs, out_ids = mixed_lists(np.random.default_rng(17), card)[case]
    old = config.matmul_precision
    config.matmul_precision = 'float32'
    try:
        outs, launch = grouped_matmul_plan(As, Bs, out_ids)
    finally:
        config.matmul_precision = old
    assert launch.tile == MIXED_TILE
    kind = grouped_matmul.kinds['float32' if case == 'f32_pair' else 'float32_mixed']
    before = kind.launches
    launch()
    torch.cuda.synchronize()
    assert kind.launches == before + 1
    ref = grouped_matmul_plain(As, Bs, out_ids, precision='float32')
    assert_within_sum_order(outs, ref, As, Bs, out_ids, None)
    if case == 'deep':
        assert abs(sum_lean(outs, As, Bs, out_ids)) <= MIXED_LEAN
    if case == 'fine_bits':  # one bf16 pass misses the bound
        one_pass = grouped_matmul_plain(As, Bs, out_ids, precision='default')
        with pytest.raises(AssertionError):
            assert_within_sum_order(one_pass, ref, As, Bs, out_ids, None)


@pytest.mark.cuda
def test_mixed_operands_are_read_in_place(card):
    """A bf16 operand of an f32 list reaches the kernel as it is: the pointers in the
    launch's table are the bf16 blocks' own, and no copy is made."""
    from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul_plan

    rng = np.random.default_rng(12)
    As = [torch.from_numpy(rng.normal(size=(64, k))).to(card, torch.bfloat16)
          for k in (33, 130)]
    Bs = [torch.from_numpy(rng.normal(size=(k, 90))).to(card, torch.float32)
          for k in (33, 130)]
    outs, launch = grouped_matmul_plan(As, Bs, [0, 0])
    ua, ub, table = launch.operands
    assert all(a is A for a, A in zip(ua, As)) and all(b is B for b, B in zip(ub, Bs))
    assert isinstance(table, np.ndarray)  # a table small enough to travel inline
    n_out = 1
    assert set(table[n_out:, 0].tolist()) == {A.data_ptr() for A in As}
    assert set(table[n_out:, 5].tolist()) == {1} and set(table[n_out:, 6].tolist()) == {0}
    launch()
    ref = sum(A.double() @ B.double() for A, B in zip(As, Bs))
    torch.cuda.synchronize()
    assert outs[0].dtype == torch.float32
    assert float((outs[0].double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_bf16_environments_matvec_reads_them_in_place(card):
    """The effective-Hamiltonian matvec with bf16 LP/RP and an f32 theta: the grouped
    GEMM runs its mixed kind, and the result is the CPU's (the bf16 operand widened,
    f32 sums in another order)."""
    out = {}
    for device in ('cuda', 'cpu'):
        LP, RP, W1, W2, theta = build_workload(get_backend(u1_symmetry, device=device), 64,
                                               dtype=Dtype.float32)
        H = HEffective(LP.to_dtype(Dtype.bfloat16), RP.to_dtype(Dtype.bfloat16), W1, W2)
        before = grouped_matmul.kinds['float32_mixed'].launches
        out[device] = H.matvec(theta)
        if device == 'cuda':
            torch.cuda.synchronize()
            assert grouped_matmul.kinds['float32_mixed'].launches > before
    got, ref = out['cuda'].to_numpy(), out['cpu'].to_numpy()
    assert out['cuda'].dtype == Dtype.float32
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.cuda
def test_static_graphs_keep_bf16_environments(card):
    """Static mode with env_dtype=bfloat16 through CUDA graphs keeps every interior
    LP/RP bf16 across replays, and captures anew when matmul_precision or env_dtype
    changes."""
    L = 8
    model = TFIModel(L=L, J=1., g=1.5, conserve='parity')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-12, pad_chi_multiple=4,
                     env_dtype=Dtype.bfloat16)
    eng.run(n_sweeps=4)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    for _ in range(3):  # the second sweep captures, the third replays
        E = eng.sweep()
    graphs = len(eng.static_graphs())
    assert graphs > 0
    assert all(t.dtype == Dtype.bfloat16 for t in eng.LPs[1:-1] + eng.RPs[1:-1])
    E_exact = tfi_exact_finite_gs_energy(L, 1., 1.5)
    assert abs(E - E_exact) < 0.02 * abs(E_exact)  # the environments' first-order error
    eng.matmul_precision = 'tensorfloat32'
    for _ in range(2):
        eng.sweep()
    assert len(eng.static_graphs()) > graphs
    graphs = len(eng.static_graphs())
    eng.env_dtype, eng.matmul_precision = None, None
    eng.LPs = [t.to_dtype(Dtype.float64) for t in eng.LPs]
    eng.RPs = [t.to_dtype(Dtype.float64) for t in eng.RPs]
    for _ in range(2):
        E = eng.sweep()
    assert len(eng.static_graphs()) > graphs
    assert all(t.dtype == Dtype.float64 for t in eng.LPs[1:-1] + eng.RPs[1:-1])
    assert abs(E - E_exact) < 1e-8


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


@pytest.mark.cuda
def test_su2_compose_matches_plain(card):
    """A fusion-tree compose on the card (one grouped-GEMM launch over the pairs of
    its coupled sectors) against the same compose on the CPU, where the grouped GEMM
    takes its plain version: the same tensors, f64, to 1e-12."""
    from cyten_tpu_torch import su2_symmetry
    from cyten_tpu_torch.bench import build_su2_workload
    from cyten_tpu_torch.tensors import compose, permute_legs

    out = {}
    for device in ('cuda', 'cpu'):
        LP, _, _, _, theta = build_su2_workload(get_backend(su2_symmetry, device=device),
                                                chi_mult=48)
        a = permute_legs(theta, codomain=['p0', 'p1', 'vR'], domain=['vL'])
        b = permute_legs(LP, codomain=['vR'], domain=['wR', 'vR*'])
        before = grouped_matmul.launches
        out[device] = compose(a, b)
        if device == 'cuda':
            torch.cuda.synchronize()
            assert grouped_matmul.launches == before + 1
    assert len(out['cuda'].data.blocks) > 1
    np.testing.assert_allclose(out['cuda'].to_numpy(), out['cpu'].to_numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.cuda
def test_captured_su2_static_bond_matches_eager(card):
    """A steady static SU(2) bond update (build_step_state of build_su2_workload at
    16 multiplets, f64) captured as a CUDA graph and replayed, against the eager
    update on the same inputs (1e-12): the tree-move plans' coefficients and indices
    are device constants by then, so the capture copies nothing from the host."""
    from cyten_tpu_torch import su2_symmetry
    from cyten_tpu_torch.bench import build_su2_workload

    LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
        get_backend(su2_symmetry, device='cuda'), 16, builder=build_su2_workload)
    impl = _get_static_bond_fn(10, 'steady')

    def fn(LP, RP, S, B1, B2):
        return impl(HEffective(LP, RP, W1, W2), S, B1, B2, tmpl, None)

    inputs = (LP, RP, S, B1, B2)
    ref = fn(*inputs)
    graph = _GraphedStep(fn, inputs)
    assert graph.graph.launches[grouped_matmul] > 0
    assert graph.graph.launches[tridiagonal_ground_state] == 1
    got = graph.run(inputs)
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(ref[0])) <= 1e-12 * abs(float(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert g.labels == r.labels
        np.testing.assert_allclose(g.to_numpy(), r.to_numpy(), rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_golden_compose_matches_plain(card):
    """A golden-chain compose on the card (one complex128 grouped-GEMM launch over
    its coupled sectors, real LP against a complex theta) against the same compose
    on the CPU, to 1e-12."""
    from cyten_tpu_torch import fibonacci_anyon_category
    from cyten_tpu_torch.bench import build_golden_workload
    from cyten_tpu_torch.tensors import compose, permute_legs

    out = {}
    kind = grouped_matmul.kinds['complex128']
    for device in ('cuda', 'cpu'):
        LP, _, _, _, theta = build_golden_workload(
            get_backend(fibonacci_anyon_category, device=device), chi_mult=48)
        theta = theta.to_dtype(Dtype.complex128) * (1 + 2j)
        a = permute_legs(theta, codomain=['p0', 'p1', 'vR'], domain=['vL'])
        b = permute_legs(LP, codomain=['vR'], domain=['wR', 'vR*'])
        before = kind.launches
        out[device] = compose(a, b)
        if device == 'cuda':
            torch.cuda.synchronize()
            assert kind.launches == before + 1
    assert out['cuda'].dtype == Dtype.complex128 and len(out['cuda'].data.blocks) > 1
    for g, r in zip(out['cuda'].data.blocks, out['cpu'].data.blocks):
        np.testing.assert_allclose(g.cpu().numpy(), r.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_captured_golden_static_bond_matches_eager(card):
    """A steady static golden-chain bond update (build_step_state of
    build_golden_workload at 16 multiplets, its state complex128) captured as a CUDA
    graph and replayed, against the eager update on the same inputs (1e-12)."""
    from cyten_tpu_torch import fibonacci_anyon_category
    from cyten_tpu_torch.bench import build_golden_workload

    LP, RP, W1, W2, S, B1, B2, tmpl, _ = build_step_state(
        get_backend(fibonacci_anyon_category, device='cuda'), 16,
        builder=build_golden_workload)
    B1, B2, tmpl = (t.to_dtype(Dtype.complex128) for t in (B1, B2, tmpl))
    impl = _get_static_bond_fn(10, 'steady')

    def fn(LP, RP, S, B1, B2):
        return impl(HEffective(LP, RP, W1, W2), S, B1, B2, tmpl, None)

    inputs = (LP, RP, S, B1, B2)
    ref = fn(*inputs)
    graph = _GraphedStep(fn, inputs)
    assert graph.graph.launches[grouped_matmul.kinds['complex128']] > 0
    assert graph.graph.launches[tridiagonal_ground_state] == 1
    got = graph.run(inputs)
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(ref[0])) <= 1e-12 * abs(float(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert g.labels == r.labels and g.dtype == r.dtype
        for gb, rb in zip(g.data.blocks, r.data.blocks):
            np.testing.assert_allclose(gb.cpu().numpy(), rb.cpu().numpy(), rtol=0,
                                       atol=1e-12)


@pytest.mark.cuda
def test_captured_gather_keeps_its_device_index(card):
    """A batched gather and scatter-add (the fusion-tree plan application's) captured
    as a graph: the graph keeps the device index tensors it reads, so a replay after
    the backend has dropped them from its cache is still right."""
    from cyten_tpu_torch.blocks import get_block_backend

    bb = get_block_backend('torch', 'cuda')
    block = torch.arange(600., device='cuda').reshape(20, 30)
    starts = np.array([[0, 1], [5, 7], [12, 20]])

    def fn():
        acc = bb.accumulator((20, 30), Dtype.float32)
        windows = bb.batched_slice(block, starts, (4, 6))
        return bb.batched_accum_add(acc, np.ascontiguousarray(starts[::-1]), windows)

    ref = fn()  # builds the device indices eagerly
    graph = _kernels.Graph()
    with graph.capture():
        out = fn()
    bb._constants.clear()
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 16,), -1, dtype=torch.int64, device='cuda') for _ in range(8)]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and len(junk) == 8


# --- the thin form of every kind -------------------------------------------------------

# the kinds, as (matmul_precision, A dtype, B dtype, the kind that runs them)
THIN_KINDS = [('float32', torch.float64, torch.float64, 'float64'),
              ('float32', torch.float32, torch.float32, 'float32'),
              ('float32', torch.bfloat16, torch.bfloat16, 'bfloat16'),
              ('float32', torch.bfloat16, torch.float32, 'float32_mixed'),
              ('tensorfloat32', torch.float32, torch.float32, 'tensorfloat32'),
              ('tensorfloat32', torch.float32, torch.bfloat16, 'tensorfloat32'),
              ('default', torch.bfloat16, torch.float32, 'default'),
              ('default', torch.float32, torch.float32, 'default'),
              ('float32', torch.complex128, torch.complex128, 'complex128'),
              ('float32', torch.float64, torch.complex128, 'complex128')]


def _thin_list(rng, form, a_dtype, b_dtype, device, deep=True):
    """A ragged thin list: (As, Bs, out_ids). Outputs share pairs; one pair has K = 0
    and one output no rows (tall) or columns (wide); rows of K = 3 values, 12 bytes in
    f32, from bases one value past alignment; odd pitches on the large operand (for
    A, rows that are not one span: lda > K). With
    ``deep``, also pairs up to the kernel's bounds (K = 16, 16 columns or rows), which
    the wrapper runs thin only when asked (``width='thin'``); without, K and the
    narrow side are at most 3, as in the environment updates' contractions with W."""
    def draw(shape, dtype, misaligned=False, pitch=None):
        rows, cols = shape
        pitch = cols if pitch is None else pitch
        x = rng.normal(size=rows * pitch + 1)
        if dtype.is_complex:
            x = x + 1j * rng.normal(size=rows * pitch + 1)
        buf = torch.from_numpy(x).to(device, dtype)
        return (buf[1:] if misaligned else buf[:-1]).view(rows, pitch)[:, :cols]

    # (M, K, N) of each pair, out_ids
    shapes = [(1300, 3, 3), (1300, 1, 3), (700, 3, 1), (5, 2, 16), (1300, 0, 3),
              (9, 16, 16), (700, 4, 1), (0, 3, 2)]
    out_ids = [0, 0, 1, 2, 0, 3, 1, 4]
    if not deep:
        shapes, out_ids = [(1300, 3, 3), (1300, 1, 3), (700, 3, 1), (1300, 0, 3),
                           (700, 2, 1), (0, 3, 2)], [0, 0, 1, 0, 1, 2]
    As, Bs = [], []
    for i, (m, k, n) in enumerate(shapes):
        if form == 'wide':  # the transposed list: M and K small, N large
            m, n = n, m
        odd = i % 2 == 0
        big_a = form == 'tall'
        As.append(draw((m, k), a_dtype, misaligned=odd and big_a,
                       pitch=k + 1 if odd and big_a and i % 4 == 0 else None))
        Bs.append(draw((k, n), b_dtype, misaligned=odd and not big_a,
                       pitch=n + 1 if odd and not big_a else None))
    return As, Bs, out_ids


def _assert_kind_close(got, ref, As, Bs, out_ids, precision, kind):
    """The thin form against its plain version at its kind's tolerance: the converting
    kinds to K 2^-23 |A||B|, complex128 to 2 K 2^-52 |A||B| (elementwise), f64, f32
    and bf16 as test_grouped_gemm_matches_plain."""
    if kind in ('float32_mixed', 'tensorfloat32', 'default'):
        assert_within_sum_order(got, ref, As, Bs, out_ids, precision)
    elif kind == 'complex128':
        _complex_close(got, ref, As, Bs, out_ids)
    else:
        rtol, atol = TOL[As[0].dtype]
        for c, r in zip(got, ref):
            assert c.dtype == As[0].dtype and c.shape == r.shape
            if r.numel():
                err = float((c.double() - r.double()).abs().max())
                assert err <= atol + rtol * float(r.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['tall', 'wide'])
@pytest.mark.parametrize('precision, a_dtype, b_dtype, kind', THIN_KINDS)
def test_thin_form_matches_plain(card, form, precision, a_dtype, b_dtype, kind):
    """Every kind's thin form on a ragged thin list (shared outputs, K = 0 pairs, an
    empty output, unaligned bases, 12-byte rows, odd pitches, bf16 operands read in
    place, real x complex): one launch, counted for its kind and the thin forms, and
    its plain version's result."""
    from cyten_tpu_torch.config import config

    As, Bs, out_ids = _thin_list(np.random.default_rng(18), form, a_dtype, b_dtype, card)
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        outs, launch = grouped_matmul_plan(As, Bs, out_ids, width='thin')
        assert grouped_matmul_plan(As, Bs, out_ids)[1].form is None  # past the pick
    finally:
        config.matmul_precision = old
    assert launch.form == form
    if kind != 'complex128':  # bf16 and f32 operands are read where they lie
        table = launch.operands[2]
        assert {A.data_ptr() for A in As} == set(table[5:, 0])
    before = (grouped_matmul.kinds[kind].launches, grouped_matmul.thin.launches)
    launch()
    torch.cuda.synchronize()
    assert (grouped_matmul.kinds[kind].launches, grouped_matmul.thin.launches) == (
        before[0] + 1, before[1] + 1)
    ref = grouped_matmul_plain(As, Bs, out_ids, precision=precision)
    _assert_kind_close(outs, ref, As, Bs, out_ids, precision, kind)


@pytest.mark.cuda
@pytest.mark.parametrize('form', ['tall', 'wide'])
def test_thin_form_replays_in_a_graph(card, form):
    """A list shaped as the environment updates' contractions with W is run thin by
    default; captured in a CUDA graph, it reads its operands anew at each replay."""
    from cyten_tpu_torch.config import config

    rng = np.random.default_rng(19)
    As, Bs, out_ids = _thin_list(rng, form, torch.float32, torch.float32, card, deep=False)
    old = config.matmul_precision
    config.matmul_precision = 'tensorfloat32'
    try:
        grouped_matmul_plan(As, Bs, out_ids)[1]()  # set up before the capture
        graph = _kernels.Graph()
        with graph.capture():
            outs = grouped_matmul_plan(As, Bs, out_ids)[1]()
    finally:
        config.matmul_precision = old
    assert graph.launches == {grouped_matmul: 1, grouped_matmul.kinds['tensorfloat32']: 1,
                              grouped_matmul.thin: 1}
    for _ in range(2):
        for X in (*As, *Bs):
            X.copy_(torch.from_numpy(rng.normal(size=tuple(X.shape))))
        graph.replay()
        torch.cuda.synchronize()
        ref = grouped_matmul_plain(As, Bs, out_ids, precision='tensorfloat32')
        assert_within_sum_order(outs, ref, As, Bs, out_ids, 'tensorfloat32')


@pytest.mark.cuda
@pytest.mark.parametrize('width', ['wide', 'narrow'])
@pytest.mark.parametrize('case', list(RAGGED))
def test_complex_kind_at_each_tile(card, case, width):
    """The complex128 kind at its 128 x 64 and its 64 x 64 tile (the one it takes for
    lists too small to fill the card), whatever the list, on the ragged lists and on
    conjugate views: the plain version's result within 2 K 2^-52 |A||B|."""
    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(20)
    As = [_draw(rng, (M, K), True, card) for M, K, N in shapes]
    Bs = [_draw(rng, (N, K), True, card).mH for M, K, N in shapes]  # conjugate views
    outs, launch = grouped_matmul_plan(As, Bs, out_ids, width=width)
    assert launch.tile == {'wide': (128, 64), 'narrow': (64, 64)}[width]
    launch()
    torch.cuda.synchronize()
    _complex_close(outs, grouped_matmul_plain(As, Bs, out_ids), As, Bs, out_ids)


def _recorded_lists(run):
    """The grouped-GEMM lists ``run()`` plans (bench.recorded_lists): ``(matmul_precision
    then, pair list of A, of B, out_ids, n_out)``, each pair's operands as the run made
    them."""
    return [(precision, As if pairs is None else [As[i] for i in pairs[0]],
             Bs if pairs is None else [Bs[i] for i in pairs[1]], ids, n_out)
            for (precision, As, Bs, ids, n_out, pairs), _ in recorded_lists(run)]


def _assert_lists_match_plain(lists):
    """Each recorded list on the kernel against its plain version: an f32 result of
    rounded operands (TF32, 'default', the mixed kind) within the order of its sums
    (assert_within_sum_order), the others to TOL of their dtype."""
    from cyten_tpu_torch.config import config

    assert lists
    for precision, As, Bs, out_ids, n_out in lists:
        old = config.matmul_precision
        config.matmul_precision = precision
        try:
            got = grouped_matmul(As, Bs, out_ids, n_out)
        finally:
            config.matmul_precision = old
        ref = grouped_matmul_plain(As, Bs, out_ids, n_out, precision=precision)
        torch.cuda.synchronize()
        mixed = As[0].dtype != Bs[0].dtype
        if got[0].dtype == torch.float32 and (precision != 'float32' or mixed):
            assert_within_sum_order(got, ref, As, Bs, out_ids, precision)
            continue
        rtol, atol = TOL[got[0].dtype]
        for c, r in zip(got, ref):
            err = float((c.double() - r.double()).abs().max()) if c.numel() else 0.
            assert err <= atol + rtol * (float(r.double().abs().max()) if r.numel() else 0.)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', list(HUBBARD_KINDS))
def test_hubbard_lists_match_plain(card, kind):
    """The lists of one U(1) x U(1) Hubbard matvec at chi=256 (many pairs with M, N or K
    of 1 to 4) on each kind against its plain version, and the kind launched."""
    from cyten_tpu_torch.bench import _builder_symmetry, build_hubbard_workload
    from cyten_tpu_torch.config import config

    precision, dtype, env_dtype = HUBBARD_KINDS[kind]
    LP, RP, W1, W2, theta = build_hubbard_workload(
        get_backend(_builder_symmetry(build_hubbard_workload), device='cuda'), 256,
        dtype=dtype)
    H = HEffective(LP.to_dtype(env_dtype), RP.to_dtype(env_dtype), W1, W2)
    before = grouped_matmul.kinds[kind].launches
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        lists = _recorded_lists(lambda: H.matvec(theta))
    finally:
        config.matmul_precision = old
    torch.cuda.synchronize()
    assert grouped_matmul.kinds[kind].launches > before
    assert max(len(A) for _, A, *_ in lists) > 100  # hundreds of pairs in a list
    _assert_lists_match_plain(lists)


@pytest.mark.cuda
def test_hubbard_matvec_card_matches_cpu(card):
    """The Hubbard matvec at chi=128 in f64 on the card and on the CPU: 1e-12."""
    from cyten_tpu_torch.bench import _builder_symmetry, build_hubbard_workload

    out = {}
    for device in ('cuda', 'cpu'):
        args = build_hubbard_workload(get_backend(_builder_symmetry(build_hubbard_workload),
                                                  device=device), 128)
        out[device] = HEffective(*args[:4]).matvec(args[4]).to_numpy()
    np.testing.assert_allclose(out['cuda'], out['cpu'], rtol=0,
                               atol=1e-12 * np.abs(out['cpu']).max())


@pytest.mark.cuda
def test_graphed_dense_matvec_matches_eager(card):
    """The dense (no-symmetry) TFI matvec at chi=64, f64, captured as a CUDA graph
    (_GraphedStep, as matvec_run(graph=True) times it) and replayed on a new theta,
    against the same matvec run eagerly: 1e-12."""
    from cyten_tpu_torch.bench import (
        _builder_symmetry, _normalised_matvec, build_dense_workload,
    )

    backend = get_backend(_builder_symmetry(build_dense_workload), device='cuda')
    LP, RP, W1, W2, theta = build_dense_workload(backend, 64)
    fn = _normalised_matvec(LP, RP, W1, W2)
    graph = _GraphedStep(lambda th: (fn(th),), (theta,))
    theta = fn(theta)
    got, = graph.run((theta,))
    want = fn(theta).to_numpy()
    np.testing.assert_allclose(got.to_numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.cuda
def test_padded_step_lists_match_plain(card):
    """The lists of one static bond update of the padded workload (multiplicities
    rounded up to 64) in bf16 work at 'default', the bench's bar rung, against their
    plain version."""
    from cyten_tpu_torch.bench import build_padded_workload
    from cyten_tpu_torch.config import config

    def padded(backend, chi, seed=0, *, dtype):
        return build_padded_workload(backend, chi, seed, 64, dtype=dtype)

    state = build_step_state(get_backend(u1_symmetry, device='cuda'), 256, builder=padded)
    LP, RP, W1, W2, S, B1, B2, tmpl = (t.to_dtype(Dtype.bfloat16) for t in state[:8])
    impl = _get_static_bond_fn(10, 'steady', {'n_jacobi': 1, 'ns_polish': 1})
    old = config.matmul_precision
    config.matmul_precision = 'default'
    try:
        lists = _recorded_lists(lambda: impl(HEffective(LP, RP, W1, W2), S, B1, B2, tmpl,
                                             None))
    finally:
        config.matmul_precision = old
    assert all(A.dtype == B.dtype == torch.bfloat16 for _, PA, PB, *_ in lists
               for A, B in zip(PA, PB))
    _assert_lists_match_plain(lists)


# --- checkpoints, resume and rollback on the card ------------------------------------


def _heisenberg(L, device='cuda'):
    from cyten_tpu_torch.algorithms import HeisenbergModel

    model = HeisenbergModel(L=L, conserve='Sz', device=device)
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    return model, psi


def _mps_blocks(psi):
    return [b for t in psi.Bs + psi.Ss for b in t.data.blocks]


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(card, tmp_path):
    """A state on the card saved and loaded with device='cuda' lies on the card, on
    the model's own backend, bitwise; with device='cpu' on the CPU."""
    from cyten_tpu_torch.tools.checkpoint import load_checkpoint, save_checkpoint

    model, psi = _heisenberg(8)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13)
    eng.run(n_sweeps=4)
    path = str(tmp_path / 'ckpt')
    save_checkpoint(path, {'psi': eng.psi, 'E': eng.E})
    back = load_checkpoint(path, device='cuda')
    assert back['E'] == eng.E and back['psi'].backend is model.backend
    for a, b in zip(_mps_blocks(back['psi']), _mps_blocks(eng.psi)):
        assert a.is_cuda and torch.equal(a, b)
    host = load_checkpoint(path, device='cpu')['psi']
    for a, b in zip(_mps_blocks(host), _mps_blocks(eng.psi)):
        assert a.device.type == 'cpu' and torch.equal(a, b.cpu())
    # the restored state sweeps on in a fresh engine
    eng2 = DMRGEngine(back['psi'], model, chi_max=16, eps=1e-13)
    assert abs(eng2.sweep() - eng.E) < 1e-10


@pytest.mark.cuda
def test_async_save_while_the_engine_sweeps(card, tmp_path):
    """Every sweep saved with async_save while the next sweep runs: each kept step is
    the state of its own sweep (its <H> is that sweep's E; chi 16 keeps every value at
    L=8), not one torn by the sweeps after it."""
    from cyten_tpu_torch.tools.checkpoint import CheckpointManager, wait_for_saves

    model, psi = _heisenberg(8)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3, async_save=True)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13)
    eng.run(n_sweeps=4, checkpoint=mgr, tol=0.)
    wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == [f'step_{s:08d}' for s in (2, 3, 4)]
    energies = []
    for step in (2, 3, 4):
        payload = mgr.restore(step, device='cuda')
        E = payload['psi'].expectation_value_mpo(model.H_mpo)
        assert abs(E - payload['E']) < 1e-10, step
        energies.append(payload['E'])
    assert energies[-1] == eng.E


@pytest.mark.cuda
def test_static_rollback_recaptures_graphs(card, tmp_path, capsys):
    """A NaN B in static mode through graphs rolls back to the checkpoint: the old
    graphs are released, auto_static captures new ones on the restored structures, and a sweep
    through them matches an eager static sweep (1e-10)."""
    model, psi = _heisenberg(10)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13, auto_static=True)
    # dynamic until the structures repeat, then static sweeps that capture graphs
    eng.run(n_sweeps=7, checkpoint=str(tmp_path), tol=0.)
    old = [weakref.ref(g) for g in eng.static_graphs()]
    assert eng.static_mode and old
    eng.psi.Bs[4] = eng.psi.Bs[4] * float('nan')
    eng.run(n_sweeps=6, checkpoint=str(tmp_path), tol=0., verbose=True)
    assert 'rollback to checkpoint' in capsys.readouterr().out
    assert all(r() is None for r in old)  # released
    assert eng.static_mode and eng.static_graphs()
    E_graph = eng.E
    eng.enable_static_mode(n_lanczos=20, svd_mode='steady', cuda_graphs=False)
    assert abs(eng.sweep() - E_graph) < 1e-10


# --- fermions ------------------------------------------------------------------------------


def _hubbard_on(device, L=6, chi_max=16):
    """The Fermi-Hubbard chain at L, half filling, after one dynamic sweep."""
    from cyten_tpu_torch.algorithms import FermiHubbardModel

    model = FermiHubbardModel(L, device=device)
    psi = SimpleMPS.from_product_state(model.site_legs, [1, 2] * (L // 2),
                                       backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=1e-14)
    eng.sweep()
    return model, psi, eng


@pytest.mark.cuda
def test_fermionic_compose_list_matches_plain(card):
    """The largest grouped-GEMM list of a Hubbard bond update (FermionNumber x U(1) on
    the fusion-tree backend: a compose over its coupled sectors) on the kernel, against
    its plain version elementwise to 2 K 2^-52 |A||B|."""
    model, psi, eng = _hubbard_on('cuda')
    lists = recorded_lists(lambda: eng.update_bond(2))
    (_, As, Bs, ids, n_out, pairs), _ = max(
        lists, key=lambda l: sum(t.numel() for t in (*l[0][1], *l[0][2])))
    before = grouped_matmul.launches
    got = grouped_matmul(As, Bs, ids, n_out, pairs)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1 and len(pairs[0]) > 1
    ref = grouped_matmul_plain(As, Bs, ids, n_out, pairs)
    bound = grouped_matmul_plain([A.abs() for A in As], [B.abs() for B in Bs], ids, n_out,
                                 pairs)
    K = max(As[i].shape[1] for i in pairs[0].tolist())
    for g, r, b in zip(got, ref, bound):
        assert g.dtype == torch.float64
        assert bool(((g - r).abs() <= 2 * K * 2. ** -52 * b).all())


@pytest.mark.cuda
def test_captured_hubbard_static_bond_matches_eager(card):
    """A steady static Hubbard bond update captured as a CUDA graph and replayed,
    against the eager update on the same inputs (1e-12), its signed gathers reading
    device constants the graph keeps."""
    from cyten_tpu_torch.algorithms.dmrg import _freeze_bond

    model, psi, eng = _hubbard_on('cuda')
    i = 2
    W1, W2 = model.H_mpo[i], model.H_mpo[i + 1]
    tmpl, _ = _freeze_bond(HEffective(eng.LPs[i], eng.RPs[i + 1], W1, W2),
                           psi.get_theta2(i), psi.Bs[i + 1].get_leg('vL'))
    impl = _get_static_bond_fn(10, 'steady')

    def fn(LP, RP, S, B1, B2):
        return impl(HEffective(LP, RP, W1, W2), S, B1, B2, tmpl, None)

    for j in range(i):  # the left environments up to bond i
        eng.update_LP(j, psi.get_theta1(j))
    inputs = (eng.LPs[i], eng.RPs[i + 1], psi.Ss[i], psi.Bs[i], psi.Bs[i + 1])
    ref = fn(*inputs)
    graph = _GraphedStep(fn, inputs)
    assert graph.graph.launches[grouped_matmul] > 0
    assert graph.graph.launches[tridiagonal_ground_state] == 1
    psi.Bs[0].backend.block_backend._constants.clear()
    gc.collect()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 22,), -1, dtype=torch.int64, device='cuda')
    got = graph.run(inputs)
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(ref[0])) <= 1e-12 * abs(float(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert g.labels == r.labels and g.dtype == r.dtype
        for gb, rb in zip(g.data.blocks, r.data.blocks):
            np.testing.assert_allclose(gb.cpu().numpy(), rb.cpu().numpy(), rtol=0,
                                       atol=1e-12)
    assert junk.numel() == 1 << 22


@pytest.mark.cuda
def test_hubbard_dmrg_card_matches_cpu(card):
    """The same Hubbard sweep on the card and on the CPU (1e-10)."""
    E = {device: _hubbard_on(device)[2].E for device in ('cuda', 'cpu')}
    assert abs(E['cuda'] - E['cpu']) < 1e-10


@pytest.mark.cuda
def test_dmrg1_update_and_idmrg_step_card_matches_cpu(card):
    """One-site DMRG (one sweep of update_site, expand mixer) and three iDMRG steps on
    the card against the CPU, by the quantities the SVD gauge leaves alone: E and the
    Schmidt values, to 1e-10; both through the grouped-GEMM kernel on the card."""
    from cyten_tpu_torch.algorithms import DMRG1SEngine, HeisenbergModel, iDMRGEngine

    def values(S):
        return np.sort(np.abs(np.diag(S.to_numpy())))[::-1]

    res = {}
    for device in ('cuda', 'cpu'):
        before = grouped_matmul.launches
        model = HeisenbergModel(L=8, conserve='Sz', device=device)
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 4,
                                           backend=model.backend)
        eng = DMRG1SEngine(psi, model, chi_max=16, eps=1e-14, alpha=1e-2)
        E1 = eng.sweep()
        tfi = TFIModel(L=2, g=1.5, conserve='parity', bc='infinite', device=device)
        ipsi = SimpleMPS.from_product_state(tfi.site_legs, [0, 0], backend=tfi.backend,
                                            bc='infinite')
        ieng = iDMRGEngine(ipsi, tfi, chi_max=16)
        es = [ieng.step() for _ in range(3)]
        res[device] = (E1, [values(S) for S in psi.Ss[1:]], es[1:], values(ieng.S),
                       grouped_matmul.launches - before)
    card_res, cpu_res = res['cuda'], res['cpu']
    assert card_res[4] > 0
    assert abs(card_res[0] - cpu_res[0]) < 1e-10
    for a, b in zip(card_res[1], cpu_res[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    np.testing.assert_allclose(card_res[2], cpu_res[2], rtol=0, atol=1e-10)
    np.testing.assert_allclose(card_res[3], cpu_res[3], rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize('delta', [-0.05, 0.05j, 0.02 - 0.05j])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_tridiag_evolve_matches_plain(card, dtype, delta):
    """tridiagonal_evolve against its plain version on every Lanczos family (closed
    Krylov spaces included), to 1e-12 of the largest coefficient; NaN in, NaN out."""
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve, tridiagonal_evolve_plain

    for label, ab in FAMILIES:
        t = torch.from_numpy(ab).to(dtype)
        nrm0 = torch.tensor(1.3, dtype=dtype)
        before = tridiagonal_evolve.launches
        got = tridiagonal_evolve(t.to(card), delta, nrm0.to(card)).cpu()
        assert tridiagonal_evolve.launches == before + 1
        want = tridiagonal_evolve_plain(t, delta, nrm0)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * max(1., want.abs().max().item()),
                                   err_msg=label)
    bad = torch.from_numpy(FAMILIES[-1][1]).to(card, dtype)
    bad[0, 3] = float('nan')
    assert torch.isnan(tridiagonal_evolve(bad, delta, nrm0.to(card))).all()


@pytest.mark.cuda
def test_fused_tdvp_site_step_graph_matches_cpu(card):
    """One fused QR-TDVP site step (right-moving, real time) at the chain's centre on
    the card, eager, then captured and replayed from its CUDA graph with no host sync,
    against the same step on the CPU from the same tensors (the state and the
    environments made on the CPU and carried to the card by the schema). Held by what
    the QR's gauge leaves alone, the product A C of the isometry and the evolved bond
    centre, to 1e-10. Each replay counts the real MPO operands it copies to complex.

    The state is the full-rank ground state at g=1 (chi 8 -> 16 at site 3: A is square,
    so its columns span the whole space whatever the rounding). With Schmidt values
    near the rounding (the ground state at g=3) the rounding decides the columns of A
    that carry them, and A C moves by far more than its input does, on the CPU alone
    (scripts/torch_tdvp_conditioning.py)."""
    from cyten_tpu_torch.algorithms import TDVPQREngine
    from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve
    from cyten_tpu_torch.tensors import permute_legs, tdot
    from cyten_tpu_torch.tools.hdf5_io import from_tree, to_tree

    L, i = 8, 3
    model0 = TFIModel(L=L, g=1.0, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model0.site_legs, [0] * L, backend=model0.backend)
    DMRGEngine(psi, model0, chi_max=16, eps=1e-14).run(n_sweeps=3)
    opts = {'dt': 0.05, 'fused': True, 'lanczos_options': {'N_max': 12}}
    eng = TDVPQREngine(psi, TFIModel(L=L, g=1.5, conserve='parity', device='cpu'), **opts)
    th = psi.get_theta1(0)
    for k in range(i):  # the sweep's right-moving steps up to site i, on the CPU
        _, C, eng.LPs[k + 1] = eng._fused_step('R', k, th)
        th = permute_legs(tdot(C, psi.Bs[k + 1], 'vR', 'vL'), codomain=['vL', 'p'],
                          domain=['vR'])
    A, C, _ = eng._fused_step('R', i, th)
    want = np.asarray(tdot(A, C, 'vR', 'vL').to_numpy())

    def moved(t):
        return from_tree(to_tree(t), device=card)

    card_eng = TDVPQREngine(moved(psi), TFIModel(L=L, g=1.5, conserve='parity'), **opts)
    card_eng.LPs[i], card_eng.RPs[i] = moved(eng.LPs[i]), moved(eng.RPs[i])
    th = moved(th)
    outs, converted = [], []
    for _ in range(3):  # eager, capture + replay, replay
        before = tridiagonal_evolve.launches
        converted_before = grouped_matmul.converted
        if len(outs) == 2:  # a replay reads nothing on the host
            torch.cuda.set_sync_debug_mode('error')
        try:
            A, C, _ = card_eng._fused_step('R', i, th)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        assert tridiagonal_evolve.launches == before + 2
        converted.append(grouped_matmul.converted - converted_before)
        outs.append(np.asarray(tdot(A, C, 'vR', 'vL').to_numpy()))
    assert len(card_eng.graphs()) == 1
    assert converted[1] == converted[2] > 0
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(outs[2], outs[0], rtol=0, atol=1e-12)
