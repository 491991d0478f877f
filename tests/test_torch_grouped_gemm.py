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
# f32, bf16, mixed and TF32 128 x 128, the bf16 pass ('default') 128 x 256, complex128
# 64 x 64
KIND_TILES = [(128, 64), (128, 128), (128, 256), (64, 64)]

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
