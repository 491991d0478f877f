"""Grouped (ragged) matrix products: ``C_o = sum_{p: out_ids[p] == o} A_p @ B_p``.

The counterpart of ``cyten_tpu/blocks/pallas_grouped.py::grouped_matmul``, the
Pallas TPU kernel that computes ``C_i = A_i @ B_i`` for a whole list of ragged pairs
in one launch. Here the list is one launch of the hand-written CUDA kernel
``csrc/grouped_gemm.cu``, with one generalisation: pairs given the same output
index are summed into that output inside the kernel. That sum is the block-sparse
contraction's ``add`` over contracted sectors (abelian ``tdot`` / ``compose``).

The operands are used where they lie, with no padding to tiles: the host builds two
small int64 tables (one row per 64 x 64 output tile, one row per pair) and the
kernel reads the matrices through the pointers in them. See the source for what
bounds the kernel and how its design answers that.

:func:`grouped_matmul` launches the kernel for CUDA tensors and takes the plain
version, :func:`grouped_matmul_plain`, only for tensors on the CPU. On CUDA it
never falls back: an operand it does not take (complex, another dtype, another
device) raises.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['grouped_matmul', 'grouped_matmul_plain', 'launch_tables', 'work_table', 'TILE']

TILE = 64  # output tile edge of the kernel (BM = BN in csrc/grouped_gemm.cu)
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


def _common_dtype(As, Bs) -> torch.dtype:
    """One dtype for the whole list, as ``TorchBlockBackend._dot_dtypes`` chooses it:
    bf16 only if every operand is bf16, else the promoted type (bf16 with f32 -> f32)."""
    dtypes = {t.dtype for t in (*As, *Bs)}
    if dtypes == {torch.bfloat16}:
        return torch.bfloat16
    res = None
    for dt in dtypes:
        res = dt if res is None else torch.promote_types(res, dt)
    if res == torch.bfloat16:
        res = torch.float32
    return res


def _prepare(As, Bs, out_ids, n_out):
    if len(As) != len(Bs):
        raise ValueError(f'{len(As)} left operands but {len(Bs)} right operands')
    n = len(As)
    out_ids = (np.arange(n, dtype=np.int64) if out_ids is None
               else np.asarray(out_ids, dtype=np.int64).reshape(-1))
    if len(out_ids) != n:
        raise ValueError('need one output index per pair')
    if n_out is None:
        n_out = int(out_ids.max()) + 1 if n else 0
    if n and (out_ids.min() < 0 or out_ids.max() >= n_out):
        raise ValueError('output index out of range')
    M = np.full(n_out, -1, np.int64)
    N = np.full(n_out, -1, np.int64)
    for A, B, o in zip(As, Bs, out_ids):
        if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0]:
            raise ValueError(f'not a matrix product: {tuple(A.shape)} @ {tuple(B.shape)}')
        if M[o] < 0:
            M[o], N[o] = A.shape[0], B.shape[1]
        elif (M[o], N[o]) != (A.shape[0], B.shape[1]):
            raise ValueError(f'pairs summed into output {o} differ in shape')
    if np.any(M < 0):
        raise ValueError('every output needs at least one pair')
    return out_ids, n_out, M, N


def grouped_matmul_plain(As, Bs, out_ids=None, n_out=None) -> list:
    """The plain PyTorch version: a loop of ``torch.matmul``, then a sum per output.

    Same dtype policy as the kernel: bf16 products accumulate in f32 and are cast
    back once; mixed dtypes are promoted to their common type first.
    """
    out_ids, n_out, _, _ = _prepare(As, Bs, out_ids, n_out)
    dtype = _common_dtype(As, Bs) if len(As) else torch.float64
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    outs = [None] * n_out
    for A, B, o in zip(As, Bs, out_ids):
        prod = torch.matmul(A.to(work), B.to(work))
        outs[o] = prod if outs[o] is None else outs[o] + prod
    return [c.to(dtype) for c in outs]


def work_table(M: np.ndarray, N: np.ndarray) -> np.ndarray:
    """Output tiles of the kernel: rows ``(output, row0, col0)``, one per
    ``TILE x TILE`` tile of each ``[M[o], N[o]]`` output, outputs in order."""
    tm = -(-np.asarray(M, np.int64) // TILE)
    tn = -(-np.asarray(N, np.int64) // TILE)
    n_tiles = tm * tn
    out = np.repeat(np.arange(len(n_tiles), dtype=np.int64), n_tiles)
    first = np.cumsum(n_tiles) - n_tiles
    local = np.arange(int(n_tiles.sum()), dtype=np.int64) - first[out]
    return np.stack([out, (local // tn[out]) * TILE, (local % tn[out]) * TILE], axis=1)


def launch_tables(a_ptrs, b_ptrs, K, out_ids, M, N, c_ptrs):
    """The kernel's two int64 tables (layout in ``csrc/grouped_gemm.cu``).

    ``a_ptrs``, ``b_ptrs`` and ``K`` per pair, ``M``, ``N`` and ``c_ptrs`` per output.
    Returns ``work [n_tiles, 8]`` (c_ptr, M, N, row0, col0, pair_begin, pair_end, 0),
    one row per output tile, and ``pairs [n_pairs, 4]`` (a_ptr, b_ptr, K, 0), sorted by
    output so that each output reads the contiguous range of pair rows its tiles name.
    """
    out_ids = np.asarray(out_ids, np.int64)
    order = np.argsort(out_ids, kind='stable')
    outputs = np.arange(len(M))
    begin = np.searchsorted(out_ids[order], outputs, side='left')
    end = np.searchsorted(out_ids[order], outputs, side='right')
    pairs = np.zeros((len(order), 4), np.int64)
    pairs[:, 0] = np.asarray(a_ptrs, np.int64)[order]
    pairs[:, 1] = np.asarray(b_ptrs, np.int64)[order]
    pairs[:, 2] = np.asarray(K, np.int64)[order]
    tiles = work_table(M, N)
    o = tiles[:, 0]
    work = np.zeros((len(tiles), 8), np.int64)
    work[:, 0] = np.asarray(c_ptrs, np.int64)[o]
    work[:, 1] = M[o]
    work[:, 2] = N[o]
    work[:, 3:5] = tiles[:, 1:]
    work[:, 5] = begin[o]
    work[:, 6] = end[o]
    return work, pairs


def _launch(As, Bs, out_ids, n_out, M, N, dtype, device) -> list:
    from ._kernels import library

    # temporaries made here are freed on return while the kernel may still read
    # them; the caching allocator reuses their memory only for work queued later
    # on the same stream
    As = [A.to(dtype).contiguous() for A in As]
    Bs = [B.to(dtype).contiguous() for B in Bs]
    sizes = M * N
    offsets = np.cumsum(sizes) - sizes
    flat = torch.empty(int(sizes.sum()), dtype=dtype, device=device)
    outs = [flat[int(off):int(off) + int(s)].view(int(m), int(n))
            for off, s, m, n in zip(offsets, sizes, M, N)]
    work, pairs = launch_tables([A.data_ptr() for A in As], [B.data_ptr() for B in Bs],
                                [A.shape[1] for A in As], out_ids, M, N,
                                flat.data_ptr() + offsets * flat.element_size())
    if not len(work):  # every output is empty: nothing to launch
        return outs
    host = torch.from_numpy(np.concatenate([work.reshape(-1), pairs.reshape(-1)]))
    tables = host.pin_memory().to(device, non_blocking=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library('grouped_gemm').cyten_grouped_gemm(
            _DTYPE_CODE[dtype], tables.data_ptr(), tables.data_ptr() + work.size * 8,
            len(work), stream)
    if err != 0:
        raise RuntimeError(f'grouped_gemm launch failed: cudaError {err}')
    grouped_matmul.launches += 1
    return outs


def grouped_matmul(As, Bs, out_ids=None, n_out=None) -> list:
    """``C[o] = sum over pairs p with out_ids[p] == o of As[p] @ Bs[p]``.

    Parameters
    ----------
    As, Bs
        Lists of 2D tensors, ``As[p]: [M, K_p]``, ``Bs[p]: [K_p, N]``, all on one device.
    out_ids
        Output index of each pair (default: one output per pair). Pairs summed into
        one output must agree in ``M`` and ``N``; every output needs a pair.
    n_out
        Number of outputs (default: ``max(out_ids) + 1``).

    Returns the ``n_out`` outputs ``[M, N]`` in the common dtype of the operands
    (bf16 stays bf16, accumulated in f32). CUDA tensors go through one launch of the
    kernel; CPU tensors through :func:`grouped_matmul_plain`.
    """
    out_ids, n_out, M, N = _prepare(As, Bs, out_ids, n_out)
    if not As:
        return []
    devices = {t.device for t in (*As, *Bs)}
    if len(devices) != 1:
        raise ValueError(f'operands on several devices: {devices}')
    device = devices.pop()
    if device.type == 'cpu':
        return grouped_matmul_plain(As, Bs, out_ids, n_out)
    if device.type != 'cuda':
        raise NotImplementedError(f'grouped_matmul: no kernel for {device}')
    dtype = _common_dtype(As, Bs)
    if dtype.is_complex:
        raise NotImplementedError('grouped_matmul: complex operands have no CUDA kernel yet')
    if dtype not in _DTYPE_CODE:
        raise NotImplementedError(f'grouped_matmul: no CUDA kernel for {dtype}')
    return _launch(As, Bs, out_ids, n_out, M, N, dtype, device)


grouped_matmul.launches = 0  # kernel launches, counted where the kernel is launched
