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

from cyten_tpu_torch.blocks.grouped_gemm import (  # noqa: E402
    TILE, grouped_matmul, grouped_matmul_plain, launch_tables, work_table,
)

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
    # bf16 with f32 promotes to f32; f32 with f64 to f64
    assert grouped_matmul([a.bfloat16()], [b.float()])[0].dtype == torch.float32
    assert grouped_matmul([a.float()], [b])[0].dtype == torch.float64


def test_work_table_covers_every_output_tile_once():
    M = np.array([1, 64, 65, 130, 0])
    N = np.array([1, 64, 200, 7, 5])
    tiles = work_table(M, N)
    for o in range(len(M)):
        mine = tiles[tiles[:, 0] == o]
        covered = np.zeros((M[o], N[o]), int)
        for _, r0, c0 in mine:
            assert r0 % TILE == 0 and c0 % TILE == 0 and r0 < M[o] and c0 < N[o]
            covered[r0:r0 + TILE, c0:c0 + TILE] += 1
        assert np.all(covered == 1)
    assert np.all(np.diff(tiles[:, 0]) >= 0)  # outputs in order


def test_launch_tables_drive_the_kernel_walk():
    """The tables the wrapper hands the CUDA kernel, walked as the kernel walks them
    (one work row per output tile, the pair range it names, the pointers in it)."""
    rng = np.random.default_rng(4)
    shapes = [(130, 17, 70), (12, 9, 3), (130, 64, 70), (5, 200, 129), (130, 1, 70)]
    out_ids = np.array([2, 0, 2, 1, 2])  # output 2 sums three pairs, out of order
    As, Bs = _pairs(rng, shapes)
    As, Bs = [torch.from_numpy(a) for a in As], [torch.from_numpy(b) for b in Bs]
    M, N = np.array([12, 5, 130]), np.array([3, 129, 70])
    outs = [torch.full((int(m), int(n)), np.nan, dtype=torch.float64) for m, n in zip(M, N)]
    work, pairs = launch_tables([a.data_ptr() for a in As], [b.data_ptr() for b in Bs],
                                [a.shape[1] for a in As], out_ids, M, N,
                                [c.data_ptr() for c in outs])
    by_ptr = {t.data_ptr(): t for t in (*As, *Bs, *outs)}
    for c_ptr, m, n, row0, col0, begin, end, _ in work.tolist():
        C = by_ptr[c_ptr]
        assert tuple(C.shape) == (m, n)
        rows, cols = slice(row0, row0 + TILE), slice(col0, col0 + TILE)
        acc = torch.zeros_like(C[rows, cols])
        for a_ptr, b_ptr, k, _ in pairs[begin:end].tolist():
            A, B = by_ptr[a_ptr], by_ptr[b_ptr]
            assert A.shape == (m, k) and B.shape == (k, n)
            acc += A[rows] @ B[:, cols]
        C[rows, cols] = acc
    ref = grouped_matmul_plain(As, Bs, out_ids)
    for c, r in zip(outs, ref):
        # f64, the same products summed per tile instead of per output
        np.testing.assert_allclose(c.numpy(), r.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('case', ['length', 'inner_dim', 'shared_shape', 'empty_output'])
def test_rejects_malformed_lists(case):
    a, b = torch.zeros(3, 4), torch.zeros(4, 5)
    args = {'length': ([a, a], [b]),
            'inner_dim': ([a], [torch.zeros(5, 5)]),
            'shared_shape': ([a, torch.zeros(2, 4)], [b, b], [0, 0]),
            'empty_output': ([a], [b], [1], 2)}[case]
    with pytest.raises(ValueError):
        grouped_matmul(*args)
