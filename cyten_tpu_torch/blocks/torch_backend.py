"""Torch block backend: dense blocks as torch tensors on one device.

The counterpart of ``cyten_tpu/blocks/torch_backend.py`` (:158-304), with an explicit
device. Every block a backend creates lies on its device; the backend's default
device is the CUDA card (:func:`~.backend.default_device`).
"""

from __future__ import annotations

from numbers import Number

import numpy as np
import torch

from ..dtypes import Dtype
from ._kernels import keep_alive
from .backend import BlockBackend, default_device

__all__ = ['TorchBlockBackend']

_TO_TORCH = {Dtype.bool: torch.bool, Dtype.bfloat16: torch.bfloat16,
             Dtype.float32: torch.float32, Dtype.float64: torch.float64,
             Dtype.complex64: torch.complex64, Dtype.complex128: torch.complex128}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}
_CONSTANTS_MAX = 16384  # device copies of host arrays a backend keeps


def _windows(starts, h, w):
    """Row and column indices ``[n, h, 1]`` and ``[n, 1, w]`` of the windows at
    ``starts``, which broadcast to the windows' ``[n, h, w]``."""
    s = torch.as_tensor(starts, dtype=torch.int64)
    return ((s[:, 0, None] + torch.arange(h))[:, :, None],
            (s[:, 1, None] + torch.arange(w))[:, None, :])




class _TorchNamespace:
    """Thin numpy-like adapter over torch for the generic BlockBackend methods.
    Everything it creates lies on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device

    def __getattr__(self, name):
        return getattr(torch, name)

    def asarray(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def array(self, x, copy=True):
        res = self.asarray(x)
        return res.clone() if copy else res

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def eye(self, n, dtype=None):
        return torch.eye(n, dtype=dtype, device=self.device)

    def arange(self, n):
        return torch.arange(n, device=self.device)

    def reshape(self, x, shape):
        return torch.reshape(x, shape)

    def transpose(self, x, axes=None):
        if axes is None:
            axes = tuple(range(x.ndim - 1, -1, -1))
        return torch.permute(x, tuple(axes))

    def moveaxis(self, x, src, dst):
        return torch.movedim(x, src, dst)

    def expand_dims(self, x, ax):
        return torch.unsqueeze(x, ax)

    def squeeze(self, x, axes):
        res = x
        for ax in sorted(axes, reverse=True):
            res = torch.squeeze(res, ax)
        return res

    def tensordot(self, a, b, axes):
        return torch.tensordot(a, b, dims=axes)

    def take(self, x, idx, axis=0):
        return torch.index_select(x, axis, self.asarray(idx).long())

    def concatenate(self, xs, axis=0):
        return torch.cat(list(xs), dim=axis)

    def stack(self, xs, axis=0):
        return torch.stack(list(xs), dim=axis)

    def diagonal(self, x, axis1=0, axis2=1):
        return torch.diagonal(x, dim1=axis1, dim2=axis2)

    def trace(self, x, axis1=-2, axis2=-1):
        return torch.diagonal(x, dim1=axis1, dim2=axis2).sum(-1)

    def sum(self, x, axis=None, keepdims=False):
        if axis is None:
            return torch.sum(x)
        return torch.sum(x, dim=axis, keepdim=keepdims)

    def max(self, x, axis=None):
        if axis is None:
            return torch.max(x)
        return torch.max(x, dim=axis).values

    def min(self, x, axis=None):
        if axis is None:
            return torch.min(x)
        return torch.min(x, dim=axis).values

    def conj(self, x):
        return torch.conj(x).resolve_conj()

    def real(self, x):
        return torch.real(x) if torch.is_complex(x) else x

    def imag(self, x):
        return torch.imag(x) if torch.is_complex(x) else torch.zeros_like(x)

    def where(self, c, a, b):
        # Python numbers go to torch.where as they are: made into tensors they
        # would be copied to the device, and that copy makes the host wait for it
        return torch.where(c, a if isinstance(a, Number) else self.asarray(a),
                           b if isinstance(b, Number) else self.asarray(b))


class TorchBlockBackend(BlockBackend):
    """torch implementation on one device (default: the CUDA card)."""

    name = 'torch'

    def __init__(self, device: str = None):
        self.device = torch.device(default_device() if device is None else device)
        BlockBackend.__init__(self, _TorchNamespace(self.device))
        #: device values made from host data (:meth:`cached`), oldest first
        self._constants: dict = {}

    def __repr__(self):
        return f'TorchBlockBackend(device={str(self.device)!r})'

    def __reduce__(self):
        from .backend import get_block_backend

        return (get_block_backend, (self.name, str(self.device)))

    def is_block(self, obj) -> bool:
        return isinstance(obj, torch.Tensor)

    def to_internal_dtype(self, dtype: Dtype):
        return _TO_TORCH[dtype]

    def get_dtype(self, block) -> Dtype:
        return _FROM_TORCH[block.dtype]

    def as_block(self, obj, dtype: Dtype = None, return_dtype: bool = False):
        block = self.xp.asarray(obj)
        if block.dtype in (torch.int32, torch.int64):
            block = block.to(self.to_internal_dtype(dtype or Dtype.float64))
        elif dtype is not None:
            block = self.to_dtype(block, dtype)
        if return_dtype:
            return block, self.get_dtype(block)
        return block

    def to_dtype(self, block, dtype: Dtype):
        if block.is_complex() and not dtype.is_complex:
            block = block.real
        return block.to(self.to_internal_dtype(dtype))

    def to_numpy(self, block, numpy_dtype=None):
        if self.is_block(block):
            block = block.resolve_conj().cpu()
            if block.dtype == torch.bfloat16:  # numpy has no bf16
                block = block.float()
            res = block.numpy()
        else:
            res = np.asarray(block)
        if numpy_dtype is not None:
            res = res.astype(numpy_dtype)
        return res

    def copy_block(self, block):
        return block.clone()

    def block_item(self, block):
        return block.item() if self.is_block(block) else np.asarray(block).item()

    def _setitem(self, block, idx, value):
        # functional, like the contract: callers that own a fresh buffer write
        # through accum_add instead and skip this copy
        res = block.clone()
        res[idx] = self.xp.asarray(value)
        return res

    def accumulator(self, shape, dtype: Dtype):
        return self.xp.zeros(tuple(shape), self.to_internal_dtype(dtype))

    def accum_add(self, acc, idx, value):
        acc[idx] += value  # in place: acc is owned by the caller
        return acc

    def finalize_accumulator(self, acc):
        return acc

    def cached(self, key, build):
        """The device value that ``build()`` makes, made once per hashable ``key`` and
        then handed out again: so that a CUDA graph capturing a call copies nothing
        from the host, as long as an eager call of the same structure ran before it.
        The backend keeps the ``_CONSTANTS_MAX`` values used last (a hit moves its
        entry to the end of the order); a graph captured while it reads one keeps that
        one alive itself (``_kernels.keep_alive``)."""
        res = self._constants.pop(key, None)
        if res is None:
            if len(self._constants) >= _CONSTANTS_MAX:
                del self._constants[next(iter(self._constants))]
            res = build()
        self._constants[key] = res
        keep_alive(res)
        return res

    def constant(self, arr, dtype: Dtype):
        arr = np.ascontiguousarray(arr)
        return self.cached(('constant', arr.shape, arr.dtype.str, arr.tobytes(), dtype),
                           lambda: self.as_block(arr, dtype))

    def batched_slice(self, block, starts, shape):
        """The windows ``block[r:r+h, c:c+w]`` for the rows ``(r, c)`` of ``starts``
        as one ``[n, h, w]`` gather (a view for one window)."""
        h, w = shape
        starts = np.asarray(starts)
        if len(starts) == 1:
            r, c = int(starts[0, 0]), int(starts[0, 1])
            return block[None, r:r + h, c:c + w]
        rows, cols = self.cached(
            ('windows', starts.tobytes(), starts.shape, h, w),
            lambda: tuple(i.to(self.device) for i in _windows(starts, h, w)))
        return block[rows, cols]

    def batched_accum_add(self, acc, starts, updates):
        """``acc[r_i:r_i+h, c_i:c_i+w] += updates[i]`` as one ``index_add_`` into the
        flat accumulator (repeated windows accumulate)."""
        starts = np.asarray(starts)
        h, w = updates.shape[1:]
        if len(starts) == 1:
            r, c = int(starts[0, 0]), int(starts[0, 1])
            acc[r:r + h, c:c + w] += updates[0].to(acc.dtype)
            return acc
        pitch = acc.shape[1]

        def flat_index():
            rows, cols = _windows(starts, h, w)
            return (rows * pitch + cols).reshape(-1).to(self.device)

        flat = self.cached(('flat_windows', starts.tobytes(), starts.shape, h, w, pitch),
                           flat_index)
        acc.view(-1).index_add_(0, flat, updates.reshape(-1).to(acc.dtype))
        return acc

    def take_flat(self, flat, key, index):
        """``flat[index]`` for a 1-d ``flat``, with ``index`` (numpy) a device constant
        under ``key``."""
        return torch.index_select(flat, 0, self.cached(
            key, lambda: torch.as_tensor(index).to(self.device)))

    def take_rows(self, block, idx):
        idx = np.asarray(idx, np.int64)
        return torch.index_select(block, 0, self.cached(
            ('rows', idx.tobytes()), lambda: torch.as_tensor(idx).to(self.device)))

    def _set_diagonal(self, block, diag):
        res = block.clone()
        idx = self.xp.arange(diag.shape[0])
        res[idx, idx] = diag
        return res

    def matrix_svd(self, a, algorithm: str = None):
        a, half = self._linalg_upcast(a)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        if half:
            return u.to(torch.bfloat16), s.to(torch.bfloat16), vh.to(torch.bfloat16)
        return u, s, vh

    def matrix_qr(self, a, full: bool = False):
        a, half = self._linalg_upcast(a)
        q, r = torch.linalg.qr(a, mode='complete' if full else 'reduced')
        if half:
            return q.to(torch.bfloat16), r.to(torch.bfloat16)
        return q, r

    def matrix_eigh(self, a, sort: str = None):
        a, half = self._linalg_upcast(a)
        w, v = torch.linalg.eigh(a)
        if half:
            return w.to(torch.bfloat16), v.to(torch.bfloat16)
        return w, v

    def matrix_exp(self, a):
        return torch.linalg.matrix_exp(a)

    def norm(self, block, order=2) -> float:
        """Host float: one sync. Sum :meth:`norm_sq` over blocks instead in loops."""
        block, _ = self._linalg_upcast(block)
        return float(torch.linalg.vector_norm(block.flatten(), ord=order))

    def norm_sq(self, block):
        block, _ = self._linalg_upcast(block)
        return torch.linalg.vector_norm(block.flatten()) ** 2

    def _dot_dtypes(self, a, b):
        """(a, b, cast_back): torch requires equal dtypes; bf16 products accumulate
        in f32 and are cast back once."""
        from ..config import config

        bf = torch.bfloat16
        if a.dtype == bf and b.dtype == bf:
            if config.bf16_accumulate_f32:
                return a.float(), b.float(), bf
            return a, b, None
        if a.dtype != b.dtype:
            common = torch.promote_types(a.dtype, b.dtype)
            if common == bf:  # promote_types keeps bf16 only if both were bf16
                common = torch.float32
            return a.to(common), b.to(common), None
        return a, b, None

    def matrix_dot(self, a, b):
        a, b, cast_back = self._dot_dtypes(a, b)
        res = torch.matmul(a, b)
        return res.to(cast_back) if cast_back is not None else res

    def tensordot(self, a, a_axes, b, b_axes):
        a, b, cast_back = self._dot_dtypes(a, b)
        res = torch.tensordot(a, b, dims=(tuple(a_axes), tuple(b_axes)))
        return res.to(cast_back) if cast_back is not None else res

    def apply_mask(self, block, mask, ax: int):
        idx = torch.nonzero(self.xp.asarray(mask)).flatten()
        return torch.index_select(block, ax, idx)

    def as_device(self, block, device: str = None):
        return block.to(device) if device else block

    def get_device(self, block) -> str:
        return str(block.device)

    def synchronize(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
