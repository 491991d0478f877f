"""Grouped (ragged) matrix products: ``C_o = sum_{p: out_ids[p] == o} A_p @ B_p``.

The counterpart of ``cyten_tpu/blocks/pallas_grouped.py::grouped_matmul``, the
Pallas TPU kernel that computes ``C_i = A_i @ B_i`` for a whole list of ragged pairs
in one launch. Here the list is one launch of the hand-written CUDA kernel
``csrc/grouped_gemm.cu``, with one generalisation: pairs given the same output
index are summed into that output inside the kernel. That sum is the block-sparse
contraction's ``add`` over contracted sectors (abelian ``tdot`` / ``compose``).

The operands are used where they lie, with no padding to tiles: the host builds two
small int64 tables, one row per output and one row per pair, and the kernel reads
the matrices through the pointers in them. See the source for what bounds the
kernel and how its design answers that.

A list whose operands are f32, or f32 and bf16, gives f32 and is computed at the
precision ``config.matmul_precision`` names when the call is planned: 'float32' (or
None) exactly (f32 with a bf16 operand as three exact bf16 passes on the tensor
cores, :func:`split_bf16x3`), 'tensorfloat32' on TF32 tensor cores, 'default' as one
bf16 pass. A bf16 operand of such a list is read by the kernel where it lies, in
bf16. f64 and bf16 lists ignore the setting, as JAX's precision touches only f32
dots. A list with a complex128 operand gives complex128, computed at full precision
by the kernel's complex kind; its real operands are copied to complex128 first. Each
kind of launch is counted on its own too (``grouped_matmul.kinds``).

A thin list (every pair of depth at most ``THIN_PICK_K``, and every output at most
``THIN_PICK_S`` columns wide, or at most that many rows tall: the environment
updates' contractions with an MPO tensor) runs in the kernel's thin form of its kind,
a streaming pass with the same numerics; its launches are also counted in
``grouped_matmul.thin``.

:func:`grouped_matmul` launches the kernel for CUDA tensors and takes the plain
version, :func:`grouped_matmul_plain`, only for tensors on the CPU, at the same
precision. On CUDA it never falls back: an operand it does not take (complex64,
another dtype, another device) raises. :func:`grouped_matmul_plan` splits a CUDA
call into its host part and the launch, so that the launch alone can be timed or
repeated.
"""

from __future__ import annotations

import functools
import itertools
import operator
from typing import NamedTuple

import numpy as np
import torch

from ..config import config
from ._kernels import call, count, function, tally

__all__ = ['grouped_matmul', 'grouped_matmul_plain', 'grouped_matmul_plan', 'round_tf32',
           'split_bf16x3']

# the kernel's kinds (csrc/grouped_gemm.cu): name -> code. float64, float32, bfloat16
# and complex128 compute in their operands' own dtype; float32_mixed, tensorfloat32
# and default write f32 from f32 or bf16 operands, rounded as config.matmul_precision
# says
_KIND_CODE = {'float64': 0, 'float32': 1, 'bfloat16': 2, 'float32_mixed': 3,
              'tensorfloat32': 4, 'default': 5, 'complex128': 6}
# TF32, the bf16 pass and the complex kind come in two widths: the codes above run
# their wide tiles (128 x 256; complex128 128 x 64), these their narrow ones (128 x 128;
# 64 x 64); _staged_tile picks one per list. The mixed kind has one, 128 x 128
_NARROW_CODE = {'tensorfloat32': 7, 'default': 8, 'complex128': 9}
# per kind of _NARROW_CODE: its k slice (csrc/grouped_gemm.cu: Staged::BK,
# ComplexTile::BK) and what a step of its wide tile costs against one of its narrow
# tile on the H100. The staged kinds: 1.4 to 1.6 as chip_smoke.py times each list of
# a bench step at both tiles (PERF.md §6), 1.4 so that the bench's chi=1024 list,
# faster wide, is taken wide. complex128: a wide step does twice the products of a
# narrow one with the same eight consumer warps
_TILE_MODEL = {'tensorfloat32': (32, 1.4), 'default': (32, 1.4), 'complex128': (16, 1.8)}
# the thin forms of every kind: code = base + the kind's code; 'tall' lists have
# outputs at most THIN_S columns wide, 'wide' ones outputs at most THIN_S rows tall,
# and every pair of either a depth of at most THIN_K (csrc/grouped_gemm.cu, THIN_S
# and THIN_K: what the kernel takes)
_THIN_BASE = {'tall': 16, 'wide': 32}
THIN_K = 16
THIN_S = 16
# ... and the lists the wrapper runs thin unless told otherwise: depth and narrow side
# at most 4, where the thin form beat the tiled kinds at every dtype on the H100; at
# 16 the tiled f64 kind is faster (chip_smoke.py's crossover, PERF.md §6). The
# environment updates' contractions with W have 3 (U(1)) or 4 (SU(2), the golden
# chain)
THIN_PICK_K = 4
THIN_PICK_S = 4
# the bytes of an operand value of each kind, at most: what a thin form's unit is
# sized by (_thin_unit)
_VALUE_BYTES = {'float64': 8, 'float32': 4, 'bfloat16': 2, 'float32_mixed': 4,
                'tensorfloat32': 4, 'default': 4, 'complex128': 16}
_DTYPE_KIND = {torch.float64: 'float64', torch.float32: 'float32',
               torch.bfloat16: 'bfloat16', torch.complex128: 'complex128'}
_F32_OPERANDS = frozenset({torch.float32, torch.bfloat16})


def _kind(dtypes, dtype, f32_pair: bool = False):
    """``(kind, readable)`` for a list of operand dtypes ``dtypes`` whose common
    dtype is ``dtype``: the kernel's kind, for an f32 result at the precision of
    ``config.matmul_precision`` (read now, when the call is planned), else the
    dtype's own; and the operand dtypes that kind reads as they lie. ``f32_pair``:
    whether a pair of the list has two f32 operands, which the mixed kind does not
    take: at 'float32' the f32 kind runs such a list, its bf16 operands widened."""
    if dtype != torch.float32:
        return _DTYPE_KIND[dtype], frozenset({dtype})
    precision = config.matmul_precision
    if precision in ('tensorfloat32', 'default'):
        return precision, _F32_OPERANDS
    if dtypes == {torch.float32} or f32_pair:
        return 'float32', frozenset({dtype})
    return 'float32_mixed', _F32_OPERANDS


def _has_f32_pair(ua, ia, ub, ib) -> bool:
    """Whether a pair ``(ua[ia[p]], ub[ib[p]])`` of a list has two f32 operands."""
    def bf16(ts):
        return np.fromiter((t.dtype == torch.bfloat16 for t in ts), bool, len(ts))
    return not bool((bf16(ua)[ia] | bf16(ub)[ib]).all())


# unbound tensor methods, mapped over a list in C rather than called one by one
_T = torch.Tensor
_dtype_of = operator.attrgetter('dtype')
_chain = itertools.chain.from_iterable


def _common_dtype(dtypes) -> torch.dtype:
    """One dtype for a list whose operands have the set of dtypes ``dtypes``, as
    ``TorchBlockBackend._dot_dtypes`` chooses it: bf16 only if every operand is bf16,
    else the promoted type (bf16 with f32 -> f32)."""
    if dtypes == {torch.bfloat16}:
        return torch.bfloat16
    res = functools.reduce(torch.promote_types, dtypes)
    return torch.float32 if res == torch.bfloat16 else res


def _gather(ts, index=None):
    """The operands of one side of a pair list.

    Returns the tensors as a list, the position of each pair's operand in it
    (``index`` where given, else one tensor per pair), the int64 matrix ``[len(ts),
    5]`` of their ``(data_ptr, stride(0), stride(1), rows, cols)``, and the sets of
    their devices (``get_device()``: -1 off CUDA) and of their dtypes. Raises unless
    each is a matrix. One ``map`` per attribute: well under a microsecond a tensor.
    """
    tensors = list(ts)
    if index is None:
        pos = np.arange(len(tensors))
    else:
        pos = np.asarray(index, np.int64).reshape(-1)
        if len(pos) and (pos.min() < 0 or pos.max() >= len(tensors)):
            raise ValueError('operand index out of range')
    strides = list(map(_T.stride, tensors))
    if set(map(len, strides)) - {2}:
        raise ValueError('every operand must be a matrix')
    n = len(tensors)
    flat = np.array([*map(_T.data_ptr, tensors), *_chain(strides),
                     *_chain(map(_T.size, tensors))], np.int64)
    info = np.empty((n, 5), np.int64)
    info[:, 0] = flat[:n]
    info[:, 1:] = flat[n:].reshape(2, n, 2).transpose(1, 0, 2).reshape(n, 4)
    return tensors, pos, info, set(map(_T.get_device, tensors)), set(map(_dtype_of, tensors))


@functools.cache
def _kernel_info(code: int) -> tuple[tuple[int, int], int]:
    """The kernel's output tile ``(BM, BN)`` for the kind of ``code`` (for a thin
    form, the bounds on its units: :func:`_thin_unit`) and the most int64 table words
    it takes inside the launch's parameters, as the kernel states them."""
    import ctypes

    info = (ctypes.c_int64 * 3)()
    if function('grouped_gemm', 'cyten_grouped_gemm_info')(code,
                                                           ctypes.addressof(info)) != 0:
        raise RuntimeError(f'grouped_gemm: the kernel has no tile for kind {code}')
    return (info[0], info[1]), info[2]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _staged_tile(MN: np.ndarray, K, out_ids, wide, narrow, n_sm: int,
                 kind: str = 'default'):
    """The tile, ``wide`` or ``narrow``, at which a kind of two widths (TF32, the
    bf16 pass, complex128) runs the list of outputs ``MN [n_out, 2]`` whose pairs have
    depths ``K`` and output indices ``out_ids``: the one whose modelled time is least.
    A step (a k slice of a tile) costs 1 at the narrow tile and the kind's wide step
    cost (``_TILE_MODEL``) at the wide one; the time is the larger of all tile steps
    spread over ``n_sm`` CTAs and the steps of the deepest tile. So the wide tile
    takes lists whose outputs are wide and many, the narrow one lists of narrow
    outputs (N at most 128 for the staged kinds: the wide tile would do as many
    steps, each dearer) and lists too small to fill the card."""
    bk, wide_cost = _TILE_MODEL[kind]
    steps = np.bincount(out_ids, weights=-(-np.asarray(K) // bk), minlength=len(MN))

    def cost(tile, step_cost):
        tiles = (-(-MN[:, 0] // tile[0])) * (-(-MN[:, 1] // tile[1]))
        return step_cost * max(float(tiles @ steps) / n_sm, float(steps.max(initial=0.)))

    return wide if cost(wide, wide_cost) < cost(narrow, 1.) else narrow


def _thin_unit(form: str, MN: np.ndarray, K, value_bytes: int, bounds) -> int:
    """The rows (tall) or columns (wide) of one unit of a thin list: the largest
    power of two whose unit holds at most ``bounds[0]`` outputs of the widest output
    (tall; the tallest, wide) and at most ``bounds[1]`` bytes of the large operand for
    the deepest pair (``value_bytes`` a value). ``bounds`` as the kernel states them
    (``_kernel_info`` of the thin form: 256 PER, THIN_STAGE)."""
    small = int(MN[:, 1 if form == 'tall' else 0].max(initial=1))
    deep = int(np.max(K, initial=1))
    unit = min(bounds[0] // max(small, 1), bounds[1] // (max(deep, 1) * value_bytes))
    return 1 << (max(unit, 1).bit_length() - 1)


def _thin_form(MN: np.ndarray, K, k_max: int = THIN_PICK_K, s_max: int = THIN_PICK_S):
    """'tall', 'wide' or None: the thin form that runs the list of outputs ``MN
    [n_out, 2]`` whose pairs have depths ``K``. A list is thin when no pair is deeper
    than ``k_max`` and every output is at most ``s_max`` columns wide ('tall': the
    kernel streams the rows of A) or, failing that, at most ``s_max`` rows tall
    ('wide': it streams the columns of B)."""
    if len(MN) == 0 or np.max(K, initial=0) > k_max:
        return None
    if MN[:, 1].max() <= s_max:
        return 'tall'
    if MN[:, 0].max() <= s_max:
        return 'wide'
    return None


def _check(X: np.ndarray, out_ids, n_out):
    """Checks a pair list given by its pair matrix ``X [n, 10]`` (the ``_gather`` rows
    of A, then of B, per pair). Returns ``out_ids``, ``n_out``, the per-output
    ``MN [n_out, 2]``."""
    n = len(X)
    out_ids = (np.arange(n, dtype=np.int64) if out_ids is None
               else np.asarray(out_ids, dtype=np.int64).reshape(-1))
    if len(out_ids) != n:
        raise ValueError('need one output index per pair')
    try:  # raises for a negative index
        counts = np.bincount(out_ids, minlength=0 if n_out is None else n_out)
    except ValueError:
        raise ValueError('output index out of range') from None
    if n_out is None:
        n_out = len(counts)
    if len(counts) > n_out:
        raise ValueError('output index out of range')
    mn = X[:, _MN]
    MN = np.zeros((n_out, 2), np.int64)
    MN[out_ids] = mn
    bad = MN[out_ids] != mn
    bad[:, 0] |= X[:, 4] != X[:, 8]
    if bad.any() or not counts.all():  # find which rule is broken
        inner = X[:, 4] != X[:, 8]
        if inner.any():
            p = int(np.argmax(inner))
            raise ValueError(f'not a matrix product: {tuple(X[p, 3:5])} @ {tuple(X[p, 8:])}')
        if bad.any():
            raise ValueError('pairs summed into one output differ in shape')
        raise ValueError('every output needs at least one pair')
    return out_ids, n_out, MN


_MN = [3, 9]  # the columns of M (rows of A) and N (columns of B) in a pair matrix


def _pair_list(As, Bs, pairs):
    """``_gather`` of both sides, checked to have as many pairs each."""
    a_index, b_index = (None, None) if pairs is None else pairs
    ga = _gather(As, a_index)
    gb = _gather(Bs, b_index)
    if len(ga[1]) != len(gb[1]):
        raise ValueError(f'{len(ga[1])} left operands but {len(gb[1])} right operands')
    return ga, gb


def _select(ts, index) -> list:
    """``[ts[i] for i in index]``; raises for an index out of range."""
    index = np.asarray(index, np.int64).reshape(-1)
    if len(index) and (index.min() < 0 or index.max() >= len(ts)):
        raise ValueError('operand index out of range')
    return [ts[i] for i in index.tolist()]


def _prepare(As, Bs, out_ids, n_out):
    """The checks of the plain version, pair by pair. Returns ``out_ids``, ``n_out``."""
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
    return out_ids, n_out


def _as_operands(tensors, info, dtypes, dtype, readable):
    """Copies, in place in ``tensors`` and ``info``, the tensors that the kernel cannot
    read where they lie: a dtype outside ``readable`` (only tested where ``dtypes``,
    the set of their dtypes, holds one), made ``dtype``, a row stride other than 1,
    or a complex view whose conjugate or negative bit is set (its memory holds the
    values before that operation). Returns the bf16 flag of each tensor as the
    kernel will read it, or None where the kind reads one dtype only."""
    need = (info[:, 2] != 1) & (info[:, 4] > 1)
    if not dtypes <= readable:
        need |= np.fromiter((t.dtype not in readable for t in tensors), bool, len(tensors))
    if dtype.is_complex:  # the complex kinds copy 16-byte elements: bases 16-byte aligned
        need |= (info[:, 0] & 15) != 0
        need |= np.fromiter((t.is_conj() or t.is_neg() for t in tensors), bool,
                            len(tensors))
    if need.any():
        for i in np.flatnonzero(need).tolist():
            t = tensors[i]
            if t.dtype not in readable:
                tally(grouped_matmul, 'converted')
            t = (t if t.dtype in readable else t.to(dtype)).resolve_conj().resolve_neg()
            t = tensors[i] = t.contiguous()
            info[i, :3] = t.data_ptr(), t.stride(0), 1
    if len(readable) == 1:
        return None
    return np.fromiter((t.dtype == torch.bfloat16 for t in tensors), bool, len(tensors))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 (10 stored bits of mantissa), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: half a unit of the last kept bit
    added to the magnitude's bits, the 13 dropped bits then cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_bf16x3(x: torch.Tensor):
    """``(hi, mid, lo)``, three bf16 tensors whose sum is ``x`` (f32) exactly, as the
    kernel's float32_mixed kind splits its f32 operand: ``hi`` is ``x`` rounded to bf16
    (to nearest even), ``mid`` the rest rounded, ``lo`` what is left, rounded. Both
    rests are exact in f32, and what is left after ``mid`` has at most 8 significant
    bits, so the sum is exact for |x| from about 2^-110 (below, ``lo`` needs bits
    finer than bf16's smallest subnormal) to where ``hi`` rounds to infinity. The
    kernel's passes multiply these pieces; this states its split for the tests. (The
    kernel splits its f32 operand times 2^24, which every f32 below 2^104 keeps
    exactly, and scales its sums back by 2^-24.)"""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _rounded(t: torch.Tensor, precision) -> torch.Tensor:
    """Operand ``t`` of an f32 product as the kernel's kind for ``precision`` reads
    it: widened to f32, then rounded to TF32 ('tensorfloat32') or bf16 ('default')."""
    if precision == 'default':
        return t.to(torch.bfloat16).float()
    t = t.float()
    return round_tf32(t) if precision == 'tensorfloat32' else t


def grouped_matmul_plain(As, Bs, out_ids=None, n_out=None, pairs=None,
                         precision: str = None) -> list:
    """The plain PyTorch version: a loop of ``torch.matmul``, then a sum per output.

    Same dtype policy as the kernel: bf16 products accumulate in f32 and are cast
    back once; mixed dtypes (real with complex too) are promoted to their common
    type first. A list with an f32 result is computed at ``precision``
    (:func:`_kind`'s names; None is 'float32'): each operand rounded as the kernel
    rounds it (:func:`_rounded`), then multiplied in f32, whose products of rounded
    values are exact.
    """
    if pairs is not None:
        As, Bs = _select(As, pairs[0]), _select(Bs, pairs[1])
    out_ids, n_out = _prepare(As, Bs, out_ids, n_out)
    dtype = _common_dtype({t.dtype for t in (*As, *Bs)}) if len(As) else torch.float64
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    if dtype == torch.float32 and precision in ('tensorfloat32', 'default'):
        cast = functools.partial(_rounded, precision=precision)
    else:
        cast = functools.partial(torch.Tensor.to, dtype=work)
    outs = [None] * n_out
    for A, B, o in zip(As, Bs, out_ids.tolist()):
        prod = torch.matmul(cast(A), cast(B))
        outs[o] = prod if outs[o] is None else outs[o] + prod
    return [c.to(dtype) for c in outs]


class _TableLayout(NamedTuple):
    """The part of a launch table that follows from the shapes alone."""
    table: np.ndarray       # the table, zero where the pointers and pitches go
    c_offsets: np.ndarray   # of output row r of the table: its byte offset from C's base
    pair_order: np.ndarray  # pair row r of the table is pair pair_order[r] of the list
    n_tiles: int
    tile: tuple             # the (BM, BN) that numbers the tiles
    form: str = None        # the thin form the table is laid out for, if any


def _table_layout(K, out_ids, M, N, c_offsets, tile) -> _TableLayout:
    """The kernel's int64 table (layout in ``csrc/grouped_gemm.cu``) but for the
    pointers and pitches, which :func:`_fill_table` writes per call.

    ``K`` and ``out_ids`` per pair, ``M``, ``N`` and ``c_offsets`` (bytes from one
    base) per output, ``tile = (BM, BN)`` of the dtype. The table is ``[n_out +
    n_pairs, 8]``:

    - rows ``[:n_out]``, one per output: c_ptr, M, N, first_tile, tiles_n,
      pair_begin, pair_end, 0; ordered by work (the sum of K over its pairs, largest
      first), its tiles numbered from ``first_tile`` in that order;
    - rows ``[n_out:]``, one per pair: a_ptr, lda, b_ptr, ldb, K, 0, 0, 0; sorted so
      that each output reads the contiguous range of pair rows it names.
    """
    out_ids = np.asarray(out_ids, np.int64)
    n_out, n = len(M), len(out_ids)
    work = np.bincount(out_ids, weights=K, minlength=n_out)
    by_work = np.argsort(-work, kind='stable')
    pair_rank = np.argsort(by_work)[out_ids]
    pair_order = np.argsort(pair_rank, kind='stable')
    end = np.cumsum(np.bincount(pair_rank, minlength=n_out))
    mn = np.stack([M, N], axis=1)[by_work]
    tiles = (mn + (tile[0] - 1, tile[1] - 1)) // tile
    n_tiles = tiles[:, 0] * tiles[:, 1]
    first = np.cumsum(n_tiles)
    table = np.zeros((n_out + n, 8), np.int64)
    outs = table[:n_out]
    outs[:, 1:3] = mn
    outs[:, 3] = first - n_tiles
    outs[:, 4] = tiles[:, 1]
    outs[1:, 5] = end[:-1]
    outs[:, 6] = end
    table[n_out:, 4] = np.asarray(K)[pair_order]
    return _TableLayout(table, np.asarray(c_offsets, np.int64)[by_work], pair_order,
                        int(first[-1]) if n_out else 0, tuple(tile))


def _fill_table(layout: _TableLayout, a, ia, b, ib, c_base: int, a_bf16=None,
                b_bf16=None) -> np.ndarray:
    """A copy of ``layout.table`` holding one call's pointers and pitches: ``a``, ``b``
    the ``_gather`` rows of the operands, ``ia``, ``ib`` those of each pair, ``c_base``
    the address the outputs' offsets count from; and, for the kinds that read f32 and
    bf16, each operand's bf16 flag (``a_bf16``, ``b_bf16``, per operand)."""
    table = layout.table.copy()
    n_out = len(layout.c_offsets)
    np.add(layout.c_offsets, c_base, out=table[:n_out, 0])
    pairs = table[n_out:]
    pairs[:, 0:2] = a[ia[layout.pair_order], 0:2]
    pairs[:, 2:4] = b[ib[layout.pair_order], 0:2]
    if a_bf16 is not None:
        pairs[:, 5] = a_bf16[ia[layout.pair_order]]
        pairs[:, 6] = b_bf16[ib[layout.pair_order]]
    return table


class _OutputLayout(NamedTuple):
    """Where the outputs of a call lie in one flat buffer: outputs of equal ``N`` next
    to each other, so that one ``unsafe_split_with_sizes`` of a ``[sum M, N]`` view
    makes all of them (one call per distinct ``N``, not per output)."""
    size: int            # elements of the buffer
    offsets: np.ndarray  # the first element of each output
    groups: list         # per distinct N: (first element, N, rows of each output)
    order: list          # the output of each view, in the order the groups make them


def _output_layout(MN: np.ndarray) -> _OutputLayout:
    order = np.argsort(MN[:, 1], kind='stable')
    mn = MN[order]
    sizes = mn[:, 0] * mn[:, 1]
    starts = np.cumsum(sizes) - sizes
    offsets = np.empty_like(sizes)
    offsets[order] = starts
    rows, widths, starts = mn[:, 0].tolist(), mn[:, 1].tolist(), starts.tolist()
    bounds = [0, *(np.flatnonzero(np.diff(mn[:, 1])) + 1).tolist(), len(rows)] if rows else []
    groups = [(starts[s], widths[s], rows[s:e]) for s, e in zip(bounds, bounds[1:])]
    return _OutputLayout(int(sizes.sum()), offsets, groups, order.tolist())


def _outputs(layout: _OutputLayout, dtype, device):
    """The outputs of ``layout`` as slices of one new flat buffer, and the buffer. The
    slices are made by ``unsafe_split_with_sizes``: they share the buffer's storage but
    carry no autograd view record, which makes them cheaper to make and to free (the
    port computes no gradients)."""
    flat = torch.empty(layout.size, dtype=dtype, device=device)
    views = []
    for start, n, rows in layout.groups:
        if n == 0:
            views += [flat[:0].view(m, 0) for m in rows]
        else:
            views += flat[start:start + sum(rows) * n].view(-1, n).unsafe_split_with_sizes(rows)
    outs = [None] * len(views)
    for o, c in zip(layout.order, views):
        outs[o] = c
    return outs, flat


# the layouts of the pair lists seen, by their shapes (see _layouts); the oldest goes
# first when it is full
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 1024


def _layouts(a, ia, b, ib, out_ids, n_out, dtype, tile, kind=None, narrow=None,
             width=None, thin=None):
    """``(n_out, output layout, table layout)`` of a pair list: ``a``, ``b`` the
    ``_gather`` rows of its operands, ``ia``, ``ib`` those of each pair, ``dtype`` that
    of the outputs, ``tile`` the kernel's ``(BM, BN)`` for its ``kind`` (default: the
    kind of ``dtype`` itself). ``thin`` is the bounds on the units of the kind's thin
    forms (:func:`_thin_unit`), or None: a thin list (:func:`_thin_form`) is laid out
    for its form unless ``width`` says otherwise, its units numbered as tiles of
    ``(unit, THIN_S)`` (tall) or ``(THIN_S, unit)`` (wide) and the unit written into
    column 7 of the output rows. For a kind of two widths, ``narrow`` is
    ``(its narrow tile, the card's SM count)``, and a list that is not run thin is
    laid out at the tile ``width`` names ('wide': ``tile``, 'narrow') or, by default
    (or 'tiled'), at the one :func:`_staged_tile` picks. ``width='thin'`` asks for the
    thin form (``ValueError`` for a list that is not thin), 'tiled' for the tiled one.
    The tile chosen is ``table layout.tile``.

    They follow from the shapes of the pairs, ``out_ids``, ``n_out``, the dtype, the
    kind and the tiles alone, so each distinct list is checked (:func:`_check`) and
    laid out once and then taken from ``_LAYOUTS``: the DMRG path contracts the same
    block structure on every iteration of a solve and every sweep, with new blocks
    each time.
    """
    key = (a[ia, 3:5].tobytes(), b[ib, 3:5].tobytes(),
           None if out_ids is None else np.asarray(out_ids, np.int64).tobytes(),
           n_out, dtype, kind or _DTYPE_KIND[dtype], tile, narrow, width, thin)
    found = _LAYOUTS.get(key)
    if found is None:
        out_ids, n_out, MN = _check(np.concatenate((a[ia], b[ib]), axis=1), out_ids, n_out)
        out_layout = _output_layout(MN)
        form = None
        if thin is not None and width is None:
            form = _thin_form(MN, a[ia, 4])
        elif thin is not None and width == 'thin':  # whatever the kernel takes
            form = _thin_form(MN, a[ia, 4], THIN_K, THIN_S)
        if width == 'thin' and form is None:
            raise ValueError('grouped_matmul: the list is not thin')
        if form is not None:
            unit = _thin_unit(form, MN, a[ia, 4], _VALUE_BYTES[kind or _DTYPE_KIND[dtype]],
                              thin)
            tile = (unit, THIN_S) if form == 'tall' else (THIN_S, unit)
        elif narrow is not None and width != 'wide':
            tile = (narrow[0] if width == 'narrow'
                    else _staged_tile(MN, a[ia, 4], out_ids, tile, *narrow,
                                      kind=kind or 'default'))
        table_layout = _table_layout(a[ia, 4], out_ids, MN[:, 0], MN[:, 1],
                                     out_layout.offsets * dtype.itemsize, tile)
        if form is not None:
            table_layout.table[:n_out, 7] = unit
            table_layout = table_layout._replace(form=form)
        found = (n_out, out_layout, table_layout)
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            del _LAYOUTS[next(iter(_LAYOUTS))]
        _LAYOUTS[key] = found
    return found


def _kind_layouts(a, ia, b, ib, out_ids, n_out, dtype, kind, index, width=None):
    """``(kind code, inline table words, n_out, output layout, table layout, form)``
    of a pair list run by ``kind`` on card ``index``: :func:`_layouts` at the kernel's
    tiles, and the code of the form the list is laid out for: the kind's thin form
    ('tall' or 'wide', also returned as ``form``; else None), its narrow tile or its
    own. ``width`` as in :func:`grouped_matmul_plan`."""
    code = _KIND_CODE[kind]
    tile, inline_words = _kernel_info(code)
    thin = _kernel_info(_THIN_BASE['tall'] + code)[0]  # the bounds on its units
    narrow = None
    if kind in _NARROW_CODE:
        narrow = (_kernel_info(_NARROW_CODE[kind])[0], _sm_count(index))
    elif width in ('wide', 'narrow'):
        raise ValueError(f'grouped_matmul: the {kind} kind has one tile, not {width!r}')
    if width not in (None, 'thin', 'tiled', 'wide', 'narrow'):
        raise ValueError(f'grouped_matmul: no form {width!r}')
    n_out, out_layout, table_layout = _layouts(a, ia, b, ib, out_ids, n_out, dtype, tile,
                                               kind, narrow, width, thin)
    form = table_layout.form
    if form is not None:
        code += _THIN_BASE[form]
    elif table_layout.tile != tile:
        code = _NARROW_CODE[kind]
    return code, inline_words, n_out, out_layout, table_layout, form


def _table_args(table: np.ndarray, device, inline_words: int):
    """``(tables, n_words, on_device)`` for the C entry point, and the buffer that must
    outlive the launches. Up to ``inline_words`` words travel inside the launch's
    parameters from the host array: read through the constant cache, they make the
    kernel faster than tables in device memory (``PERF.md`` §6). A larger table
    is copied to the device through pinned memory, without a sync. The pinned
    buffer is part of what must outlive the launches: a CUDA graph that captured
    the copy reads it again at every replay, so it must not go back to PyTorch's
    host cache for another call to fill."""
    if table.size <= inline_words:
        return (table.ctypes.data, table.size, 0), table
    host = torch.empty(table.size, dtype=torch.int64, pin_memory=True)
    host.numpy()[:] = table.reshape(-1)
    tables = host.to(device, non_blocking=True)
    return (tables.data_ptr(), table.size, 1), (host, tables)


def grouped_matmul_plan(As, Bs, out_ids=None, n_out=None, pairs=None, width=None):
    """The host part of :func:`grouped_matmul` for CUDA operands.

    Returns ``(outs, launch)``: the ``n_out`` output tensors, allocated but not yet
    written, and a function that launches the kernel filling them. ``launch()`` may
    be called again; it reads the operands as they are then. The operands (and any
    copies made of them here) stay alive as long as ``launch`` does.

    A thin list (:func:`_thin_form`) runs in the thin form of its kind. TF32, the bf16
    pass and complex128 run any other list at the tile :func:`_staged_tile` picks.
    ``width`` forces a form whatever the list (for tests and measurements): 'thin'
    (``ValueError`` for a list that is not thin), 'tiled' (the kind's tiled form, its
    tile picked as without ``width``), or, for those three kinds ('wide' and 'narrow'
    raise ``ValueError`` for another), 'wide' (128 x 256; complex128 128 x 64) or
    'narrow' (128 x 128; complex128 64 x 64).

    The mixed kind ('float32' with a bf16 operand) splits its f32 operand in three
    bf16 pieces times 2^24 (:func:`split_bf16x3`) and scales its sums back: its
    operands and results must stay below 2^104 (about 2e31) in magnitude, or they
    come out inf. A list with a pair of two f32 operands runs on the f32 kind, its
    bf16 operands widened.

    The host reads each operand once (with ``pairs``, once however many pairs read
    it), and what follows from the shapes alone once per distinct pair list
    (:func:`_layouts`).
    """
    (ua, ia, a, a_dev, a_dt), (ub, ib, b, b_dev, b_dt) = _pair_list(As, Bs, pairs)
    devices = a_dev | b_dev
    if len(devices) != 1 or ua[0].device.type != ub[0].device.type:
        raise ValueError('operands on several devices: '
                         f'{sorted({str(t.device) for t in (*ua, *ub)})}')
    if not ua[0].is_cuda:
        raise NotImplementedError(f'grouped_matmul: no kernel for {ua[0].device}')
    index = devices.pop()
    dtypes = a_dt | b_dt
    dtype = _common_dtype(dtypes)
    if dtype not in _DTYPE_KIND:
        raise NotImplementedError(f'grouped_matmul: no CUDA kernel for {dtype}')
    kind, readable = _kind(dtypes, dtype)
    if kind == 'float32_mixed' and _has_f32_pair(ua, ia, ub, ib):
        kind, readable = _kind(dtypes, dtype, f32_pair=True)
    code, inline_words, n_out, out_layout, table_layout, form = _kind_layouts(
        a, ia, b, ib, out_ids, n_out, dtype, kind, index, width)
    a_bf16 = _as_operands(ua, a, a_dt, dtype, readable)
    b_bf16 = _as_operands(ub, b, b_dt, dtype, readable)
    outs, flat = _outputs(out_layout, dtype, torch.device('cuda', index))
    if table_layout.n_tiles == 0:  # every output is empty: nothing to launch
        return outs, lambda: outs
    table = _fill_table(table_layout, a, ia, b, ib, flat.data_ptr(), a_bf16, b_bf16)
    table_args, keep = _table_args(table, flat.device, inline_words)
    args = (code, *table_args, n_out, table_layout.n_tiles)
    fn = function('grouped_gemm', 'cyten_grouped_gemm')
    kind_count = grouped_matmul.kinds[kind]
    thin_count = grouped_matmul.thin if form is not None else None

    def launch():
        call(fn, args, index, 'grouped_gemm')
        count(grouped_matmul, keep)
        count(kind_count)
        if thin_count is not None:
            count(thin_count)
        return outs

    launch.operands = (ua, ub, keep)  # alive for as long as launch is
    launch.tile = table_layout.tile
    launch.form = form
    launch.kind = kind
    return outs, launch


def grouped_matmul(As, Bs, out_ids=None, n_out=None, pairs=None) -> list:
    """``C[o] = sum over pairs p with out_ids[p] == o of A_p @ B_p``.

    Parameters
    ----------
    As, Bs
        Lists of 2D tensors, all on one device. Without ``pairs``, pair ``p`` is
        ``As[p]: [M, K_p]`` times ``Bs[p]: [K_p, N]``.
    out_ids
        Output index of each pair (default: one output per pair). Pairs summed into
        one output must agree in ``M`` and ``N``; every output needs a pair.
    n_out
        Number of outputs (default: ``max(out_ids) + 1``).
    pairs
        Optional ``(a_index, b_index)``, one entry per pair: pair ``p`` is
        ``As[a_index[p]] @ Bs[b_index[p]]``, so that an operand read by several pairs
        is passed once (the abelian backend passes each block once this way).

    Returns the ``n_out`` outputs ``[M, N]`` in the common dtype of the operands
    (bf16 stays bf16, accumulated in f32); an f32 result at the precision of
    ``config.matmul_precision``. CUDA tensors go through one launch of the kernel;
    CPU tensors through :func:`grouped_matmul_plain`.
    """
    if not As or not Bs or (As[0].device.type == 'cpu' and not Bs[0].is_cuda):
        # the plain version raises where a list is empty and the other is not, or
        # where a later operand lies elsewhere
        return grouped_matmul_plain(As, Bs, out_ids, n_out, pairs, config.matmul_precision)
    _, launch = grouped_matmul_plan(As, Bs, out_ids, n_out, pairs)
    return launch()


grouped_matmul.launches = 0  # kernel launches, counted where the kernel is launched


class _KindCount:
    """The launches of one kind of the kernel, counted as ``grouped_matmul``'s are
    (:func:`~cyten_tpu_torch.blocks._kernels.count`; a graph keys its counts by
    this object)."""

    def __init__(self):
        self.launches = 0


#: the launches of each kind of the kernel
grouped_matmul.kinds = {kind: _KindCount() for kind in _KIND_CODE}
#: the launches of the thin forms, whatever their kind (counted in the kind's too)
grouped_matmul.thin = _KindCount()
#: operands copied to the list's dtype where the kind cannot read theirs (a real
#: operand of a complex list, copied at every call), counted where a call is planned
#: and, for a call captured in a graph, at each replay
grouped_matmul.converted = 0
