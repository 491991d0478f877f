"""The port's probe kernel (``blocks/probe.py``) against the Pallas probe of
scripts/exp_r5_step_decomp.py:55-60.

The script defines its kernel inline in ``main()``, so the kernel body is written
out again here and run in Pallas interpret mode on the CPU. On the CPU ``scale2``
takes its plain version; the kernel itself is held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cyten_tpu_torch.blocks.probe import scale2, scale2_plain


def pallas_probe(x):
    """The script's probe, as written at scripts/exp_r5_step_decomp.py:55-60."""
    def k(x_ref, o_ref):
        o_ref[:] = x_ref[:] * 2.0

    return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x)


def test_scale2_matches_pallas_probe_bitwise():
    x = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    ref = np.asarray(pallas_probe(jnp.asarray(x)))
    before = scale2.launches
    got = scale2(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 256)
    # x * 2 is exact in f32: equal bit for bit
    np.testing.assert_array_equal(got.numpy(), ref)
    assert scale2.launches == before  # the CPU takes the plain version, no launch


def test_scale2_plain_is_the_script_check():
    """The script's own check: sum(2 * ones) == 2 * 256 * 256."""
    y = scale2_plain(torch.ones((256, 256), dtype=torch.float32))
    assert float(y.sum()) == 2 * 256 * 256


def test_scale2_refuses_other_devices():
    with pytest.raises(NotImplementedError):
        scale2(torch.ones(4, device='meta'))
