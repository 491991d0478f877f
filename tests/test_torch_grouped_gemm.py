"""The port's grouped GEMM (cyten_tpu_torch/blocks/grouped_gemm.py) against the Pallas
kernel it replaces (cyten_tpu/blocks/pallas_grouped.py, run in interpret mode as its
own tests run it) and against numpy.

On the CPU the wrapper takes the plain PyTorch version; the CUDA kernel itself runs
only on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip('jax.numpy')

from cyten_tpu.blocks.pallas_grouped import (  # noqa: E402
    grouped_matmul as pallas_grouped_matmul, tile_group, untile_results,
)

from cyten_tpu_torch.blocks import grouped_gemm  # noqa: E402
from cyten_tpu_torch.blocks.grouped_gemm import (  # noqa: E402
    grouped_matmul, grouped_matmul_plain,
)

# an output tile (BM, BN): the table builder numbers tiles of whatever size it is given
# (the kernel states its own per dtype, cyten_grouped_gemm_info)
TILE = (128, 64)
# the tiles of the kernel's kinds, as cyten_grouped_gemm_info states them: f64 128 x 64,
# f32, bf16 and mixed 128 x 128, TF32 and the bf16 pass ('default') 128 x 256 or
# 128 x 128, complex128 128 x 64 or 64 x 64; and tiles that number the units of thin
# forms, (rows, 16) tall and (16, columns) wide (_thin_unit picks them per list)
KIND_TILES = [(128, 64), (128, 128), (128, 256), (64, 64), (1024, 16), (64, 16),
              (16, 1024), (16, 256)]

# the shapes of tests/test_pallas_grouped.py:15-19
PALLAS_SHAPES = [
    [(37, 130, 65), (256, 128, 300), (5, 7, 9), (140, 260, 129)],
    [(128, 128, 128)] * 3,
    [(1, 1, 1), (2, 300, 2)],
]


def _pairs(rng, shapes, dtype=np.float64):
    As = [rng.normal(size=(M, K)).astype(dtype) for M, K, N in shapes]
    Bs = [rng.normal(size=(K, N)).astype(dtype) for M, K, N in shapes]
    return As, Bs


@pytest.mark.parametrize('shapes', PALLAS_SHAPES)
def test_plain_matches_pallas_kernel(shapes):
    rng = np.random.default_rng(0)
    As, Bs = _pairs(rng, shapes, np.float32)
    g = tile_group([jnp.asarray(a) for a in As], [jnp.asarray(b) for b in Bs])
    ref = untile_results(g, pallas_grouped_matmul(g, interpret=True))
    got = grouped_matmul_plain([torch.from_numpy(a) for a in As],
                               [torch.from_numpy(b) for b in Bs])
    for (M, K, N), r, c in zip(shapes, ref, got):
        assert tuple(c.shape) == (M, N) and c.dtype == torch.float32
        # f32 on both sides, summed in different orders: the tolerance of
        # tests/test_pallas_grouped.py for the same shapes
        np.testing.assert_allclose(c.numpy(), np.asarray(r), rtol=2e-5, atol=2e-4)


def test_shared_outputs_sum_against_numpy():
    rng = np.random.default_rng(1)
    shapes = [(30, 17, 40), (30, 5, 40), (12, 9, 3), (30, 64, 40), (12, 1, 3)]
    out_ids = [0, 0, 1, 0, 1]
    As, Bs = _pairs(rng, shapes)
    got = grouped_matmul([torch.from_numpy(a) for a in As],
                         [torch.from_numpy(b) for b in Bs], out_ids)
    ref = [As[0] @ Bs[0] + As[1] @ Bs[1] + As[3] @ Bs[3], As[2] @ Bs[2] + As[4] @ Bs[4]]
    assert len(got) == 2
    for r, c in zip(ref, got):
        # f64 sums of <= 86 products in another order: 1e-12 relative is ample
        np.testing.assert_allclose(c.numpy(), r, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_take_plain_version_without_launch():
    rng = np.random.default_rng(2)
    As, Bs = _pairs(rng, PALLAS_SHAPES[0])
    before = grouped_matmul.launches
    got = grouped_matmul([torch.from_numpy(a) for a in As],
                         [torch.from_numpy(b) for b in Bs])
    assert grouped_matmul.launches == before
    for a, b, c in zip(As, Bs, got):
        np.testing.assert_array_equal(c.numpy(), torch.from_numpy(a) @ torch.from_numpy(b))


def test_dtype_policy():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(8, 16)))
    b = torch.from_numpy(rng.normal(size=(16, 4)))
    # bf16 x bf16 stays bf16, accumulated in f32 and rounded once
    (c,) = grouped_matmul([a.bfloat16()], [b.bfloat16()])
    assert c.dtype == torch.bfloat16
    ref = a.bfloat16().float() @ b.bfloat16().float()
    assert torch.equal(c, ref.bfloat16())
    # bf16 with f32 promotes to f32; f32 with f64 to f64; any with complex128 to it
    assert grouped_matmul([a.bfloat16()], [b.float()])[0].dtype == torch.float32
    assert grouped_matmul([a.float()], [b])[0].dtype == torch.float64
    assert grouped_matmul([a], [b.to(torch.complex128)])[0].dtype == torch.complex128


# ragged lists: name -> (shapes (M, K, N), out_ids); the same cases run on the card
# in tests/test_torch_cuda.py and chip_smoke.py
RAGGED = {
    'k_odd': ([(37, 131, 65), (64, 295, 40), (3, 1, 5)], [0, 1, 2]),
    'k_not_multiple_of_8': ([(130, 6, 70), (20, 10, 129), (129, 1462, 3)], [0, 1, 2]),
    'below_one_tile': ([(5, 3, 7), (1, 1, 1), (127, 15, 63), (2, 60, 127)], [0, 1, 2, 3]),
    'twenty_into_one': ([(70, k, 90) for k in range(1, 41, 2)], [0] * 20),
    'all_k_zero': ([(30, 0, 20), (30, 0, 20), (9, 4, 11)], [0, 0, 1]),
    # more table rows than fit in the launch's parameters
    'six_hundred_pairs': ([(9, 1 + k % 7, 5) for k in range(600)], [k // 2 for k in range(600)]),
}


@pytest.mark.parametrize('case', list(RAGGED))
def test_ragged_lists_against_numpy(case):
    shapes, out_ids = RAGGED[case]
    As, Bs = _pairs(np.random.default_rng(5), shapes)
    got = grouped_matmul_plain([torch.from_numpy(a) for a in As],
                               [torch.from_numpy(b) for b in Bs], out_ids)
    ref = {}
    for a, b, o in zip(As, Bs, out_ids):
        ref[o] = ref.get(o, 0) + a @ b
    assert len(got) == len(ref)
    for o, c in enumerate(got):
        # f64 sums of <= 20 products of depth <= 1462 in another order
        np.testing.assert_allclose(c.numpy(), ref[o] + np.zeros(c.shape), rtol=1e-12,
                                   atol=1e-12)


def test_split_bf16x3_is_exact():
    """The mixed kind's split of an f32 operand: hi + mid + lo == x bitwise, each piece
    x's remainder rounded to bf16 (to nearest even), on seeded values from 2^-100 to
    2^100 of both signs, values halfway between two bf16 values (ties) and values
    whose remainder after hi is such a tie."""
    rng = np.random.default_rng(31)
    n = 1 << 16
    x = rng.uniform(1, 2, n) * 2. ** rng.integers(-100, 101, n) * rng.choice([-1., 1.], n)
    x = torch.from_numpy(x).float()
    bits = x.view(torch.int32)
    ties = ((bits & ~0xFFFF) | 0x8000).view(torch.float32)        # hi's tie
    inner_ties = ((bits & ~0xFF) | 0x80).view(torch.float32)      # mid's tie
    for v in (x, ties, inner_ties, torch.tensor([0., -0., 1., -3.5, 2. ** -100, 2. ** 100])):
        hi, mid, lo = grouped_gemm.split_bf16x3(v)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi, v.to(torch.bfloat16))
        assert torch.equal(mid, (v - hi.float()).to(torch.bfloat16))
        total = hi.double() + mid.double() + lo.double()
        assert torch.equal(total, v.double())
        # the sum in f32, in the order the passes add, is exact too
        assert torch.equal(hi.float() + mid.float() + lo.float(), v)
    assert not torch.equal(ties.to(torch.bfloat16).float(), ties)  # a tie is rounded


def _three_passes(As, Bs, out_ids, scale=2. ** 24):
    """The mixed kind's products on the CPU: each f32 operand split in three bf16
    pieces (bf16 ones one piece), the f32 products of every piece of A with every
    piece of B summed in f32, smaller pieces first, per output. As the kernel, one
    operand of a pair is split times ``scale`` (A if it is f32 and B bf16, else B)
    and the sums are scaled back at the end."""
    def pieces(t, s):
        t = t * s  # exact: a power of two
        return [t] if t.dtype == torch.bfloat16 else grouped_gemm.split_bf16x3(t)[::-1]

    outs = {}
    for A, B, o in zip(As, Bs, out_ids):
        a_scaled = A.dtype == torch.float32 and B.dtype == torch.bfloat16
        for a in pieces(A, scale if a_scaled else 1.):
            for b in pieces(B, 1. if a_scaled else scale):
                prod = a.float() @ b.float()
                outs[o] = prod if o not in outs else outs[o] + prod
    return [outs[o] / scale for o in range(len(outs))]


def _within_sum_order(got, ref, As, Bs, out_ids):
    """Each element within K_o 2^-23 (|A| |B|)_ij of ``ref`` (K_o the summed depth of
    output o's pairs): the products agree, the f32 sums differ in order."""
    mag = grouped_matmul_plain([A.abs().double() for A in As],
                               [B.abs().double() for B in Bs], out_ids)
    ks = np.zeros(len(mag))
    np.add.at(ks, out_ids, [A.shape[1] for A in As])
    for o, (c, r, m) in enumerate(zip(got, ref, mag)):
        r = torch.as_tensor(np.asarray(r)).double()
        assert bool(((c.double() - r).abs() <= ks[o] * 2. ** -23 * m).all()), o


@pytest.mark.parametrize('case', [c for c in RAGGED if c != 'six_hundred_pairs'])
@pytest.mark.parametrize('bf16_side', ['A', 'B'])
def test_three_passes_match_plain_and_pallas(case, bf16_side):
    """The mixed kind's arithmetic, emulated on the CPU (_three_passes), against the
    port's plain version at 'float32' (the bf16 operand widened, one f32 product)
    and against cyten_tpu's Pallas kernel (interpret mode, as its own tests run it)
    on the widened operands, within the order of the sums: K 2^-23 |A||B|."""
    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(32)
    As = [torch.from_numpy(rng.normal(size=(M, K))).float() for M, K, N in shapes]
    Bs = [torch.from_numpy(rng.normal(size=(K, N))).float() for M, K, N in shapes]
    if bf16_side == 'A':
        As = [A.bfloat16() for A in As]
    else:
        Bs = [B.bfloat16() for B in Bs]
    got = _three_passes(As, Bs, out_ids)
    plain = grouped_matmul_plain(As, Bs, out_ids, precision='float32')
    assert all(c.dtype == torch.float32 for c in plain)
    _within_sum_order(got, plain, As, Bs, out_ids)
    # Pallas gets the pairs of depth K > 0 (it leaves the output of an empty
    # contraction unwritten); the others add zero
    pallas = [np.zeros(tuple(c.shape)) for c in got]
    deep = [(A.float().numpy(), B.float().numpy(), o)
            for A, B, o in zip(As, Bs, out_ids) if A.shape[1] > 0]
    g = tile_group([jnp.asarray(a) for a, b, o in deep], [jnp.asarray(b) for a, b, o in deep])
    for c, (a, b, o) in zip(untile_results(g, pallas_grouped_matmul(g, interpret=True)), deep):
        pallas[o] = pallas[o] + np.asarray(c, np.float64)
    _within_sum_order(got, pallas, As, Bs, out_ids)


@pytest.mark.parametrize('bf16_side', ['A', 'B'])
def test_three_passes_scale_tiny_values(bf16_side):
    """f32 values from 2^-126 to 2^-116 (a converged state's smallest): split as they
    are, lo loses the bits below bf16's smallest subnormal and the products miss the
    K 2^-23 |A||B| bound; split times 2^24, as the kernel splits them, they hold it."""
    rng = np.random.default_rng(34)
    A = torch.from_numpy(rng.normal(size=(40, 37))).float()
    B = torch.from_numpy(rng.uniform(1, 2, size=(37, 30)) * 2. ** rng.integers(
        -126, -116, size=(37, 30)) * rng.choice([-1., 1.], size=(37, 30))).float()
    if bf16_side == 'A':
        A = A.bfloat16()
    else:
        A, B = B.T.contiguous(), A.T.contiguous().bfloat16()
    plain = grouped_matmul_plain([A], [B], precision='float32')
    _within_sum_order(_three_passes([A], [B], [0]), plain, [A], [B], [0])
    with pytest.raises(AssertionError):
        _within_sum_order(_three_passes([A], [B], [0], scale=1.), plain, [A], [B], [0])


def test_three_passes_range_ends_below_2_104():
    """The kernel's scale of 2^24 bounds the mixed kind's range: f32 operands up to
    just below 2^104 (results well inside) hold the K 2^-23 |A||B| bound, and from
    2^104 on the scaled operand is inf in f32, so the results are not finite, which
    grouped_matmul_plan's docstring states."""
    rng = np.random.default_rng(35)
    A = (torch.from_numpy(rng.normal(size=(30, 41))) * 2. ** -40).bfloat16()

    def big(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, size=(41, 20)) * rng.choice(
            [-1., 1.], size=(41, 20))).float()

    B = big(2. ** 102, 2. ** 103.99)
    assert bool(B.isfinite().all()) and float(B.abs().max()) < 2. ** 104
    plain = grouped_matmul_plain([A], [B], precision='float32')
    _within_sum_order(_three_passes([A], [B], [0]), plain, [A], [B], [0])
    B = big(2. ** 104, 2. ** 105)
    assert bool(grouped_matmul_plain([A], [B], precision='float32')[0].isfinite().all())
    assert not bool(_three_passes([A], [B], [0])[0].isfinite().any())


def test_three_passes_need_every_piece():
    """On an f32 operand whose low bits only mid and lo carry (1 + j 2^-20), one bf16
    pass misses the K 2^-23 |A||B| bound by far; the three passes hold it."""
    rng = np.random.default_rng(33)
    A = torch.from_numpy(rng.normal(size=(40, 295))).bfloat16()
    B = torch.from_numpy(1 + rng.integers(1, 1 << 20, size=(295, 30)) * 2. ** -20).float()
    plain = grouped_matmul_plain([A], [B], precision='float32')
    _within_sum_order(_three_passes([A], [B], [0]), plain, [A], [B], [0])
    with pytest.raises(AssertionError):
        _within_sum_order([A.float() @ B.bfloat16().float()], plain, [A], [B], [0])


def _complex(rng, shape, cplx: bool):
    x = rng.normal(size=shape)
    return x + 1j * rng.normal(size=shape) if cplx else x


@pytest.mark.parametrize('case', list(RAGGED))
@pytest.mark.parametrize('sides', ['complex', 'real_x_complex', 'complex_x_real'])
def test_complex_lists_against_numpy(case, sides):
    """complex128 lists, and real x complex ones (promoted to complex128, as the
    kernel's complex kind takes them), against numpy's products."""
    shapes, out_ids = RAGGED[case]
    rng = np.random.default_rng(14)
    As = [_complex(rng, (M, K), sides != 'complex_x_real') for M, K, N in shapes]
    Bs = [_complex(rng, (K, N), sides != 'real_x_complex') for M, K, N in shapes]
    got = grouped_matmul([torch.from_numpy(a) for a in As], [torch.from_numpy(b) for b in Bs],
                         out_ids)
    ref = {}
    for a, b, o in zip(As, Bs, out_ids):
        ref[o] = ref.get(o, 0) + a @ b
    for o, c in enumerate(got):
        assert c.dtype == torch.complex128
        np.testing.assert_allclose(c.numpy(), ref[o] + np.zeros(c.shape), rtol=1e-12,
                                   atol=1e-12)


def test_complex_operands_are_prepared_for_the_kernel():
    """What the complex128 kind cannot read where it lies is copied once: a real
    operand (made complex128), a conjugate or negative view (resolved) and a
    transposed one (made row-contiguous); a plain complex128 matrix is read in place."""
    rng = np.random.default_rng(15)
    z = torch.from_numpy(_complex(rng, (6, 6), True))
    ts = [z, z.conj(), -z.conj(), z.t(), z.real.contiguous()]
    tensors, _, info, _, dtypes = grouped_gemm._gather(ts)
    assert grouped_gemm._as_operands(tensors, info, dtypes, torch.complex128,
                                     frozenset({torch.complex128})) is None
    assert tensors[0] is z
    for t, orig in zip(tensors, ts):
        assert t.dtype == torch.complex128 and t.stride(1) == 1
        assert not (t.is_conj() or t.is_neg())
        assert torch.equal(t, orig.resolve_conj().resolve_neg().to(torch.complex128))
    np.testing.assert_array_equal(info[:, 0], [t.data_ptr() for t in tensors])
    np.testing.assert_array_equal(info[:, 2], 1)


def _launch_table(a_ptrs, b_ptrs, K, lda, ldb, out_ids, M, N, c_ptrs, tile):
    """The kernel's table as the wrapper builds it: its layout, then one call's
    pointers and pitches (``c_ptrs`` as offsets from 0). Returns (table, n_tiles)."""
    layout = grouped_gemm._table_layout(K, out_ids, M, N, c_ptrs, tile)
    ia = np.arange(len(layout.pair_order))
    table = grouped_gemm._fill_table(layout, np.stack([a_ptrs, lda], axis=1), ia,
                                     np.stack([b_ptrs, ldb], axis=1), ia, 0)
    return table, layout.n_tiles


def _tables(As, Bs, out_ids, M, N, outs, tile=TILE):
    """The table of _launch_table split into its output rows and its pair rows."""
    table, n_tiles = _launch_table([a.data_ptr() for a in As], [b.data_ptr() for b in Bs],
                                   [a.shape[1] for a in As], [a.stride(0) for a in As],
                                   [b.stride(0) for b in Bs], out_ids, M, N,
                                   [c.data_ptr() for c in outs], tile)
    return table[:len(M)], table[len(M):], n_tiles


def _walk(outs, n_tiles, grid):
    """The kernel's schedule, as csrc/grouped_gemm.cu walks it: CTA b takes the tile
    ids b, b + grid, ...; a binary search over first_tile finds the output of each.
    Yields (output row, tile row0, tile col0)."""
    for b in range(grid):
        for tile in range(b, n_tiles, grid):
            lo, hi = 0, len(outs) - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if outs[mid, 3] <= tile:
                    lo = mid
                else:
                    hi = mid - 1
            local = tile - outs[lo, 3]
            yield lo, local // outs[lo, 4], local % outs[lo, 4]


@pytest.mark.parametrize('tile', KIND_TILES)
@pytest.mark.parametrize('grid', [1, 3, 264])
def test_work_table_covers_every_output_tile_once(grid, tile):
    """The per-output table walked as the kernel walks it visits every tile of every
    output exactly once, whatever the grid and whichever kind's tile; outputs with no
    tiles are never visited; rows are ordered by work."""
    M = np.array([1, 128, 129, 300, 0, 7])
    N = np.array([1, 64, 260, 7, 5, 0])  # 260: wider than one 256-column tile
    K = np.array([5, 3, 40, 1, 2, 9, 0])
    out_ids = np.array([0, 1, 2, 3, 4, 5, 2])
    bm, bn = tile
    table, n_tiles = _launch_table(np.arange(7) * 64, np.arange(7) * 64, K, K, N[out_ids],
                                   out_ids, M, N, np.arange(6) * 64, (bm, bn))
    outs, pairs = table[:len(M)], table[len(M):]
    assert n_tiles == int(sum(-(-m // bm) * -(-n // bn) for m, n in zip(M, N)))
    work = outs[:, 6] - outs[:, 5]  # pair counts; the work is the sum of K
    sum_k = [int(pairs[b:e, 4].sum()) for b, e in outs[:, 5:7]]
    assert sum_k == sorted(sum_k, reverse=True) and work.sum() == len(K)
    covered = {o: np.zeros((outs[o, 1], outs[o, 2]), int) for o in range(len(outs))}
    for o, tr, tc in _walk(outs, n_tiles, grid):
        assert outs[o, 1] > 0 and outs[o, 2] > 0
        covered[o][tr * bm:(tr + 1) * bm, tc * bn:(tc + 1) * bn] += 1
    for o, c in covered.items():
        assert np.all(c == 1)


@pytest.mark.parametrize('tile', KIND_TILES)
def test_launch_tables_drive_the_kernel_walk(tile):
    """The tables the wrapper hands the CUDA kernel, walked as the kernel walks them
    (a strided tile id, a binary search over first_tile, the pair range and the
    pointers, K and pitches of each pair), compute what the plain version computes,
    whichever kind's tile numbers them."""
    rng = np.random.default_rng(4)
    shapes = [(130, 17, 70), (12, 9, 3), (130, 64, 70), (5, 200, 290), (130, 1, 70),
              (12, 0, 3)]
    out_ids = np.array([2, 0, 2, 1, 2, 0])  # output 2 sums three pairs, out of order
    As, Bs = _pairs(rng, shapes)
    As, Bs = [torch.from_numpy(a) for a in As], [torch.from_numpy(b) for b in Bs]
    As[0] = torch.from_numpy(rng.normal(size=(130, 20)))[:, :17]  # row pitch 20, not 17
    M, N = np.array([12, 5, 130]), np.array([3, 290, 70])
    outs = [torch.full((int(m), int(n)), np.nan, dtype=torch.float64) for m, n in zip(M, N)]
    o_tab, p_tab, n_tiles = _tables(As, Bs, out_ids, M, N, outs, tile)
    by_ptr = {t.data_ptr(): t for t in (*As, *Bs, *outs)}
    bm, bn = tile
    for o, tr, tc in _walk(o_tab, n_tiles, 5):
        c_ptr, m, n, _, _, begin, end, _ = o_tab[o].tolist()
        C = by_ptr[c_ptr]
        assert tuple(C.shape) == (m, n)
        r, c = slice(tr * bm, tr * bm + bm), slice(tc * bn, tc * bn + bn)
        acc = torch.zeros_like(C[r, c])
        for a_ptr, lda, b_ptr, ldb, k, *rest in p_tab[begin:end].tolist():
            assert rest == [0, 0, 0]
            if k == 0:  # the kernel skips empty products; their pointers may be null
                continue
            A, B = by_ptr[a_ptr], by_ptr[b_ptr]
            assert A.shape == (m, k) and B.shape == (k, n)
            assert (lda, ldb) == (A.stride(0), B.stride(0))
            acc += A[r] @ B[:, c]
        C[r, c] = acc
    ref = grouped_matmul_plain(As, Bs, out_ids)
    for c, r in zip(outs, ref):
        # f64, the same products summed per tile instead of per output
        np.testing.assert_allclose(c.numpy(), r.numpy(), rtol=1e-12, atol=1e-12)


def test_gather_reads_pointers_pitches_and_shapes():
    """One side of a pair list: each tensor's pointer, row pitch, column stride and
    shape, its device and dtype, and the operand of each pair (one per pair, or the
    index given)."""
    base = torch.zeros(12, 10)
    A, B, C = base[:, 1:8], torch.zeros(3, 4, dtype=torch.float64), base.t()
    uniq, pos, info, devices, dtypes = grouped_gemm._gather([A, B, C])
    assert uniq == [A, B, C] and pos.tolist() == [0, 1, 2]
    assert info.tolist() == [[A.data_ptr(), 10, 1, 12, 7], [B.data_ptr(), 4, 1, 3, 4],
                             [C.data_ptr(), 1, 10, 10, 12]]
    assert devices == {-1} and dtypes == {torch.float32, torch.float64}
    uniq, pos, info, _, _ = grouped_gemm._gather([C, A], np.array([1, 1, 0]))
    assert uniq == [C, A] and pos.tolist() == [1, 1, 0] and info[1, 0] == A.data_ptr()
    for bad in ([2, 0], [-1, 0]):
        with pytest.raises(ValueError):
            grouped_gemm._gather([C, A], bad)
    with pytest.raises(ValueError):
        grouped_gemm._gather([torch.zeros(3)])


def test_indexed_pairs_match_pair_lists():
    """``pairs=(a_index, b_index)`` over distinct operands gives what the expanded pair
    lists give."""
    rng = np.random.default_rng(9)
    As = [torch.from_numpy(rng.normal(size=(6, k))) for k in (3, 5)]
    Bs = [torch.from_numpy(rng.normal(size=(k, 4))) for k in (3, 5, 3)]
    a_index, b_index, out_ids = [0, 1, 0, 0], [0, 1, 2, 2], [0, 0, 1, 2]
    got = grouped_matmul(As, Bs, out_ids, pairs=(np.array(a_index), np.array(b_index)))
    ref = grouped_matmul([As[i] for i in a_index], [Bs[i] for i in b_index], out_ids)
    assert len(got) == len(ref) == 3
    for c, r in zip(got, ref):
        # the same products in the same order on both sides
        np.testing.assert_array_equal(c.numpy(), r.numpy())
    with pytest.raises(ValueError):
        grouped_matmul(As, Bs, out_ids, pairs=([0, 2, 0, 0], b_index))


def test_layouts_are_kept_by_shape():
    """A pair list is checked and laid out once per distinct shapes, out_ids and dtype;
    the kept table layout, filled with one call's pointers, is the table built anew."""
    rng = np.random.default_rng(10)
    shapes = [(30, 17, 40), (30, 5, 40), (12, 9, 3)]
    As, Bs = _pairs(rng, shapes)
    # _gather rows (data_ptr, stride(0), stride(1), rows, cols) of three A and three B
    a = np.array([(64 * i, k, 1, m, k) for i, (m, k, n) in enumerate(shapes)])
    b = np.array([(64 * i + 8, n, 1, k, n) for i, (m, k, n) in enumerate(shapes)])
    ia = ib = np.arange(3)
    first = grouped_gemm._layouts(a, ia, b, ib, [0, 0, 1], None, torch.float64, TILE)
    a2, b2 = a.copy(), b.copy()
    a2[:, 0] += 4096  # other blocks of the same shapes
    b2[:, 0] += 8192
    assert grouped_gemm._layouts(a2, ia, b2, ib, np.array([0, 0, 1]), None,
                                 torch.float64, TILE) is first
    for out_ids, dtype, tile in (([0, 1, 2], torch.float64, TILE),
                                 ([0, 0, 1], torch.float32, TILE),
                                 ([0, 0, 1], torch.float64, (64, 64))):
        assert grouped_gemm._layouts(a, ia, b, ib, out_ids, None, dtype, tile) is not first
    n_out, out_layout, table_layout = first
    table = grouped_gemm._fill_table(table_layout, a2, ia, b2, ib, 1 << 20)
    ref, n_tiles = _launch_table(a2[:, 0], b2[:, 0], a2[:, 4], a2[:, 1], b2[:, 1], [0, 0, 1],
                                 [30, 12], [40, 3], (1 << 20) + 8 * out_layout.offsets,
                                 TILE)
    assert n_out == 2 and n_tiles == table_layout.n_tiles == 2
    np.testing.assert_array_equal(table, ref)
    with pytest.raises(ValueError):  # a list that fails its checks is never kept
        grouped_gemm._layouts(a, ia, b, ib, [0, 1, 1], None, torch.float64, TILE)


# lists for the staged kinds' choice of tile: name -> ((M, K, N) per pair, out_ids,
# the tile expected of 128 x 256 and 128 x 128 on 132 SMs)
STAGED_LISTS = {
    # wide outputs, many tiles (the bench's chi=4096 tdot(LP, theta) is of this kind)
    'wide_and_many': ([(4386, 1462, 1462), (2940, 980, 980), (1462, 295, 1462)] * 3,
                      list(range(9)), (128, 256)),
    # N of at most 3 (the matvec's W contractions): the wide tile does as many steps
    'narrow_outputs': ([(m, 3, 3) for m in (1432760, 11800, 1960, 80)], [0, 1, 2, 3],
                       (128, 128)),
    # M of at most 3, N up to 1.4 M: the wide tile does half the steps
    'short_and_wide': ([(3, 3, n) for n in (1432760, 11800, 1960, 80)], [0, 1, 2, 3],
                       (128, 256)),
    # too few tiles to fill the card: the narrow tile spreads them over more SMs
    'few_tiles': ([(365, 365, 365), (245, 245, 245)], [0, 1], (128, 128)),
}


@pytest.mark.parametrize('case', list(STAGED_LISTS))
def test_staged_tile_choice(case):
    """TF32 and the bf16 pass run a list at the tile whose modelled time is least,
    and the layout cache keeps the table at that tile, numbered by it."""
    shapes, out_ids, expected = STAGED_LISTS[case]
    MN = np.array([(m, n) for m, k, n in shapes])
    K = np.array([k for m, k, n in shapes])
    assert grouped_gemm._staged_tile(MN, K, np.array(out_ids), (128, 256), (128, 128),
                                     132) == expected
    a = np.array([(64 * i, k, 1, m, k) for i, (m, k, n) in enumerate(shapes)])
    b = np.array([(64 * i + 8, n, 1, k, n) for i, (m, k, n) in enumerate(shapes)])
    ia = ib = np.arange(len(shapes))
    args = (a, ia, b, ib, out_ids, None, torch.float32, (128, 256), 'default',
            ((128, 128), 132))
    n_out, _, layout = grouped_gemm._layouts(*args)
    assert layout.tile == expected and grouped_gemm._layouts(*args)[2] is layout
    bm, bn = expected
    assert layout.n_tiles == sum(-(-m // bm) * -(-n // bn) for m, k, n in shapes)


# lists for the complex128 kind's choice of tile: name -> ((M, K, N) per pair, out_ids,
# the tile expected of 128 x 64 and 64 x 64 on 132 SMs)
COMPLEX_LISTS = {
    # the bench's chi=4096 tdot(LP, theta) made complex: many tiles, the wide one
    'wide_and_many': ([(4386, 1462, 1462), (2940, 980, 980), (1462, 295, 1462)] * 3,
                      list(range(9)), (128, 64)),
    # two pairs too few for the card at 128 x 64: twice the tiles at 64 x 64
    'few_tiles': ([(320, 200, 200), (200, 120, 320)], [0, 1], (64, 64)),
}


@pytest.mark.parametrize('case', list(COMPLEX_LISTS))
def test_complex_tile_choice(case):
    """The complex128 kind runs a list at the tile of least modelled time, its k
    slice and the cost of a wide step its own (``_TILE_MODEL``)."""
    shapes, out_ids, expected = COMPLEX_LISTS[case]
    MN = np.array([(m, n) for m, k, n in shapes])
    K = np.array([k for m, k, n in shapes])
    assert grouped_gemm._staged_tile(MN, K, np.array(out_ids), (128, 64), (64, 64), 132,
                                     kind='complex128') == expected


# thin lists: name -> ((M, K, N) per pair, out_ids, form); outputs share pairs, some
# pairs have K = 0, and K is even and odd
THIN_LISTS = {
    # the environment update's tdot(t, W): K and N at most 3, M large
    'tall': ([(1300, 3, 3), (1300, 1, 3), (700, 3, 1), (5, 2, 16), (1300, 0, 3),
              (9, 16, 16), (700, 4, 1)], [0, 0, 1, 2, 0, 3, 1], 'tall'),
    # its transposes, compose(W, tp): M and K at most 3, N large
    'wide': ([(3, 3, 1300), (3, 1, 1300), (1, 3, 700), (16, 2, 5), (3, 0, 1300),
              (16, 16, 600), (1, 4, 700)], [0, 0, 1, 2, 0, 3, 1], 'wide'),
}


# the thin kernel's bounds on a unit of an f64 list (csrc/grouped_gemm.cu: 256 PER
# outputs, THIN_STAGE bytes), its threads and their outputs, and the layout of a stage
THIN_BOUNDS = (4096, 32768)
THIN_THREADS, THIN_PER = 256, 16
THIN_LARGE_BYTES, THIN_SMALL_PITCH = 32768 + 16 * 32, 16 * 16 + 32


def _span(stage, at, t, off, nbytes):
    """thin_span: the ``nbytes`` bytes of tensor ``t`` from byte ``off`` into ``stage``
    at ``at`` + (their address & 15); returns that byte of ``stage``."""
    head = (t.data_ptr() + off) & 15
    stage[at + head:at + head + nbytes] = t.numpy().reshape(-1).view(np.uint8)[off:off + nbytes]
    return at + head


def _thin_kernel_walk(outs, pairs, n_tiles, form, by_ptr):
    """The thin kernel in numpy, for f64 lists: the strided walk over units (the unit
    read from column 7 of the output rows), per unit and pair the raw copies of its
    operands into a stage of shared memory, as bytes where the kernel puts them (the
    bytes it never copies hold NaN), and each thread's outputs t, t + 256, ..., flat
    and row-major in the unit, their (row, col) stepped as the kernel steps them.
    Returns how often each output element was written."""
    E = 8
    written = {}
    for o, tr, tc in _walk(outs, n_tiles, 7):
        c_ptr, M, N, _, tiles_n, begin, end, unit = outs[o].tolist()
        C = by_ptr[c_ptr]
        hits = written.setdefault(c_ptr, np.zeros((M, N), int))
        bm, bn = (unit, 16) if form == 'tall' else (16, unit)
        row0, col0 = tr * bm, tc * bn
        size = min(unit, (M - row0) if form == 'tall' else (N - col0))
        n_cols = N if form == 'tall' else size
        n_el = (size if form == 'tall' else M) * n_cols
        assert n_el <= THIN_THREADS * THIN_PER
        acc = np.zeros(THIN_THREADS * THIN_PER)
        for a_ptr, lda, b_ptr, ldb, K, *_ in pairs[begin:end].tolist():
            if K == 0:
                continue
            A, B = by_ptr[a_ptr], by_ptr[b_ptr]
            stage = np.full(THIN_LARGE_BYTES + 16 * THIN_SMALL_PITCH, 0xFF, np.uint8)
            value = lambda at: stage[at:at + E].view(np.float64)[0]  # noqa: E731
            if form == 'tall':
                assert lda == K and size * K * E <= THIN_BOUNDS[1]
                a_at = _span(stage, 0, A, row0 * K * E, size * K * E)
                b_at = [_span(stage, THIN_LARGE_BYTES + k * THIN_SMALL_PITCH, B, k * ldb * E,
                              N * E) for k in range(K)]
            else:
                pitch = (size * E + 31) & ~15
                assert K * pitch <= THIN_LARGE_BYTES
                b_at = [_span(stage, k * pitch, B, (k * ldb + col0) * E, size * E)
                        for k in range(K)]
                a_at = [_span(stage, THIN_LARGE_BYTES + m * THIN_SMALL_PITCH, A, m * lda * E,
                              K * E) for m in range(M)]
            for t in range(THIN_THREADS):
                dr, dn = divmod(THIN_THREADS, n_cols)
                r, n = divmod(t, n_cols)
                for i in range(THIN_PER):
                    e = t + i * THIN_THREADS
                    if e < n_el:
                        for k in range(K):
                            if form == 'tall':
                                a, b = value(a_at + (r * K + k) * E), value(b_at[k] + n * E)
                            else:
                                a, b = value(a_at[r] + k * E), value(b_at[k] + n * E)
                            acc[e] += a * b
                    r, n = r + dr, n + dn
                    if n >= n_cols:
                        n, r = n - n_cols, r + 1
        flat = acc[:n_el].reshape(-1, n_cols)
        if form == 'tall':
            C[row0:row0 + size] = torch.from_numpy(flat)
            hits[row0:row0 + size] += 1
        else:
            C[:, col0:col0 + size] = torch.from_numpy(flat)
            hits[:, col0:col0 + size] += 1
    return written


@pytest.mark.parametrize('form', list(THIN_LISTS))
def test_thin_tables_drive_the_kernel_walk(form):
    """A thin list takes its form, and its tables, walked as the thin kernel walks
    them (units of rows or columns, the raw copies of each pair's operands, each
    thread's outputs), write every output element once and compute what the plain
    version computes, the pairs that share an output summed."""
    shapes, out_ids, expected = THIN_LISTS[form]
    rng = np.random.default_rng(17)
    As, Bs = _pairs(rng, shapes)
    As, Bs = [torch.from_numpy(a) for a in As], [torch.from_numpy(b) for b in Bs]
    ia = ib = np.arange(len(shapes))
    a = np.array([(A.data_ptr(), A.stride(0), 1, *A.shape) for A in As])
    b = np.array([(B.data_ptr(), B.stride(0), 1, *B.shape) for B in Bs])
    n_out, out_layout, layout = grouped_gemm._layouts(
        a, ia, b, ib, np.array(out_ids), None, torch.float64, (128, 64), 'float64', None,
        'thin', THIN_BOUNDS)
    assert layout.form == expected
    # the unit: its outputs and the deepest pair's bytes within the kernel's bounds
    MN = np.zeros((n_out, 2), np.int64)
    for (m, k, n), o in zip(shapes, out_ids):
        MN[o] = m, n
    unit = grouped_gemm._thin_unit(form, MN, [k for m, k, n in shapes], 8, THIN_BOUNDS)
    assert layout.tile == ((unit, 16) if form == 'tall' else (16, unit))
    flat = torch.full((out_layout.size,), np.nan, dtype=torch.float64)
    table = grouped_gemm._fill_table(layout, a, ia, b, ib, flat.data_ptr())
    outs = [flat[s:s + m * n].view(m, n) for s, (m, n) in zip(out_layout.offsets, MN)]
    by_ptr = {t.data_ptr(): t for t in (*As, *Bs, *outs)}
    written = _thin_kernel_walk(table[:n_out], table[n_out:], layout.n_tiles, form, by_ptr)
    assert all(np.all(h == 1) for h in written.values()) and len(written) == n_out
    for c, r in zip(outs, grouped_matmul_plain(As, Bs, out_ids)):
        # f64, the same products summed per unit and pair
        np.testing.assert_allclose(c.numpy(), r.numpy(), rtol=1e-12, atol=1e-12)


# the bounds on a unit of each kind of sums: f32 (32 outputs a thread), f64 (16),
# complex128 (8); 32 KB of the large operand a step
KIND_BOUNDS = {'f32': (8192, 32768), 'f64': (4096, 32768), 'c128': (2048, 32768)}


@pytest.mark.parametrize('form, small, deep, kind, value_bytes, unit', [
    ('tall', 3, 3, 'f32', 4, 2048),    # the chi=4096 W list in f32: 24 KB a step
    ('tall', 3, 3, 'f64', 8, 1024),    # ... in f64
    ('tall', 3, 3, 'c128', 16, 512),   # ... in complex128
    ('wide', 1, 1, 'f32', 2, 8192),    # the most outputs a unit holds
    ('wide', 16, 16, 'c128', 16, 128), # the deepest, widest complex128 list
])
def test_thin_unit_size(form, small, deep, kind, value_bytes, unit):
    """A thin unit is the largest power of two within the kernel's bounds for the
    kind: its outputs, and the bytes of the large operand for the deepest pair."""
    MN = np.array([(50000, small)] if form == 'tall' else [(small, 50000)])
    assert grouped_gemm._thin_unit(form, MN, [deep], value_bytes, KIND_BOUNDS[kind]) == unit


@pytest.mark.parametrize('case', ['deep', 'both_large', 'tall', 'wide', 'both_small', 'empty',
                                  'w_list', 'w_transposes', 'golden_w', 'past_the_pick'])
def test_thin_form_predicate(case):
    """A list is thin only when no pair is deeper than ``k_max`` and every output is at
    most ``s_max`` columns wide (tall) or, failing that, rows tall (wide): at the
    kernel's bounds (THIN_K, THIN_S), and by default at the wrapper's (THIN_PICK_K,
    THIN_PICK_S), which take the environment updates' contractions with W."""
    cap = (grouped_gemm.THIN_K, grouped_gemm.THIN_S)
    MN, K, bounds, expected = {
        'deep': ([(1000, 3)], [17], cap, None),
        'both_large': ([(1000, 3), (17, 17)], [3, 3], cap, None),
        'tall': ([(1000, 3), (2, 16)], [16, 0], cap, 'tall'),
        'wide': ([(3, 1000), (16, 17)], [3, 16], cap, 'wide'),
        'both_small': ([(16, 16)], [16], cap, 'tall'),
        'empty': (np.zeros((0, 2), int), [], cap, None),
        'w_list': ([(1432760, 3), (11800, 1)], [3, 1], (), 'tall'),
        'w_transposes': ([(3, 1432760), (1, 11800)], [3, 3], (), 'wide'),
        'golden_w': ([(362000, 4)], [4], (), 'tall'),
        'past_the_pick': ([(1000, 3), (2, 5)], [3, 3], (), None)}[case]
    assert grouped_gemm._thin_form(np.array(MN, np.int64).reshape(-1, 2), K,
                                   *bounds) == expected


def test_thin_width_forces_the_form():
    """``width='thin'`` lays a thin list out at its thin tile and refuses a list that is
    not thin; ``width='tiled'`` lays a thin list out at the kind's tile."""
    def rows(shapes):
        a = np.array([(64 * i, k, 1, m, k) for i, (m, k, n) in enumerate(shapes)])
        b = np.array([(64 * i + 8, n, 1, k, n) for i, (m, k, n) in enumerate(shapes)])
        return a, np.arange(len(shapes)), b, np.arange(len(shapes))

    args = (None, None, torch.float32, (128, 128), 'float32', None)
    a, ia, b, ib = rows([(5000, 3, 3), (700, 1, 3)])
    for width in (None, 'thin'):
        layout = grouped_gemm._layouts(a, ia, b, ib, *args, width, THIN_BOUNDS)[2]
        assert (layout.tile, layout.form) == ((1024, 16), 'tall')
        assert (layout.table[:2, 7] == 1024).all()
    layout = grouped_gemm._layouts(a, ia, b, ib, *args, 'tiled', THIN_BOUNDS)[2]
    assert (layout.tile, layout.form) == ((128, 128), None)
    a, ia, b, ib = rows([(3, 3, 5000)])
    layout = grouped_gemm._layouts(a, ia, b, ib, *args, None, THIN_BOUNDS)[2]
    assert (layout.tile, layout.form) == ((16, 1024), 'wide')
    a, ia, b, ib = rows([(300, 30, 300)])
    layout = grouped_gemm._layouts(a, ia, b, ib, *args, None, THIN_BOUNDS)[2]
    assert (layout.tile, layout.form) == ((128, 128), None)
    with pytest.raises(ValueError):
        grouped_gemm._layouts(a, ia, b, ib, *args, 'thin', THIN_BOUNDS)


@pytest.mark.parametrize('width, case', [('wide', 'few_tiles'), ('narrow', 'wide_and_many')])
def test_staged_width_forces_the_tile(width, case):
    """``width`` lays a staged kind's list out at the tile it names, here the one the
    list would not take on its own, and the cache keeps that layout apart from the
    list's own."""
    shapes, out_ids, own = STAGED_LISTS[case]
    a = np.array([(64 * i, k, 1, m, k) for i, (m, k, n) in enumerate(shapes)])
    b = np.array([(64 * i + 8, n, 1, k, n) for i, (m, k, n) in enumerate(shapes)])
    ia = ib = np.arange(len(shapes))
    args = (a, ia, b, ib, out_ids, None, torch.float32, (128, 256), 'default',
            ((128, 128), 132))
    forced = grouped_gemm._layouts(*args, width)[2]
    bm, bn = {'wide': (128, 256), 'narrow': (128, 128)}[width]
    assert forced.tile == (bm, bn) != own
    assert forced.n_tiles == sum(-(-m // bm) * -(-n // bn) for m, k, n in shapes)
    assert grouped_gemm._layouts(*args)[2].tile == own
    assert grouped_gemm._layouts(*args, width)[2] is forced


def test_mixed_list_with_an_f32_pair_runs_the_f32_kind(monkeypatch):
    """At 'float32' a list with a bf16 operand runs the mixed kind, which reads both
    dtypes as they lie; one with a pair of two f32 operands the f32 kind, which reads
    f32 only (its bf16 operands widened by _as_operands). Other precisions keep their
    kinds."""
    from cyten_tpu_torch.config import config

    f32, bf16 = torch.float32, torch.bfloat16
    A = [torch.zeros(3, 4, dtype=d) for d in (bf16, f32, f32)]
    B = [torch.zeros(4, 5, dtype=d) for d in (f32, bf16, f32)]
    ia = np.array([0, 1]), np.array([0, 1, 2])
    assert not grouped_gemm._has_f32_pair(A, ia[0], B, ia[0])
    assert grouped_gemm._has_f32_pair(A, ia[1], B, ia[1])
    assert grouped_gemm._has_f32_pair(A, np.array([1]), B, np.array([2]))
    monkeypatch.setattr(config, 'matmul_precision', 'float32')
    assert grouped_gemm._kind({f32, bf16}, f32) == ('float32_mixed', {f32, bf16})
    assert grouped_gemm._kind({f32, bf16}, f32, f32_pair=True) == ('float32', {f32})
    for precision in ('tensorfloat32', 'default'):
        monkeypatch.setattr(config, 'matmul_precision', precision)
        assert grouped_gemm._kind({f32, bf16}, f32, f32_pair=True)[0] == precision


@pytest.mark.parametrize('case', ['length', 'inner_dim', 'shared_shape', 'empty_output',
                                  'operand_index'])
def test_rejects_malformed_lists(case):
    a, b = torch.zeros(3, 4), torch.zeros(4, 5)
    args = {'length': ([a, a], [b]),
            'inner_dim': ([a], [torch.zeros(5, 5)]),
            'shared_shape': ([a, torch.zeros(2, 4)], [b, b], [0, 0]),
            'empty_output': ([a], [b], [1], 2),
            'operand_index': ([a], [b], [0], 1, ([0], [-1]))}[case]
    with pytest.raises(ValueError):
        grouped_matmul(*args)
