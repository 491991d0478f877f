"""Toolchain probe: ``scale2(x) = 2 * x`` as a hand-written CUDA kernel.

The counterpart of the anonymous Pallas kernel ``k`` of
``scripts/exp_r5_step_decomp.py:55-60``, which doubled a ``[256, 256]`` f32 array to
show that a hand-written kernel lowers and runs before the step decomposition is
measured. Here :func:`scale2` launches ``csrc/probe.cu``, built with ``nvcc`` for
``sm_90a`` and bound with :mod:`ctypes` like every kernel of the package, so its
first call checks that toolchain end to end. The port's bench runs it first in
``step_decomposition``. It launches through the same path as the grouped GEMM
(``_kernels.call``), so its time at this size is the cost of that path.

:func:`scale2` takes the plain version, :func:`scale2_plain`, only for tensors on the
CPU. On CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ._kernels import call, count, function

__all__ = ['scale2', 'scale2_plain']


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x * 2.0``."""
    return x * 2.0


def scale2(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a contiguous f32 tensor: one kernel launch on CUDA, the plain
    version on the CPU. Raises ``NotImplementedError`` for another dtype or device
    and ``ValueError`` for a tensor that is not contiguous."""
    if not x.is_cuda:
        if x.device.type == 'cpu':
            return scale2_plain(x)
        raise NotImplementedError(f'scale2: no kernel for {x.device}')
    if x.dtype != torch.float32:
        raise NotImplementedError(f'scale2: the kernel takes float32, not {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('scale2: the kernel takes a contiguous tensor')
    out = torch.empty_like(x)
    call(function('probe', 'cyten_scale2'), (x.data_ptr(), out.data_ptr(), x.numel()),
         x.get_device(), 'scale2')
    count(scale2)
    return out


scale2.launches = 0  # kernel launches, counted where the kernel is launched
