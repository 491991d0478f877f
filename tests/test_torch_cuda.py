"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip without a card. This file imports no JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(the suite's conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul, grouped_matmul_plain

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


@pytest.mark.cuda
def test_grouped_gemm_refuses_complex(card):
    a = torch.zeros(3, 3, dtype=torch.complex128, device=card)
    with pytest.raises(NotImplementedError):
        grouped_matmul([a], [a])
