"""Tensors and MPS from plain numpy arrays and dicts.

The port holds no reference to ``cyten_tpu`` objects. State crosses over as a plain
spec, which an exporter on the other side writes (the parity tests hold one):

tensor spec
    ``symmetry``: list of factor names, each ``'NoSymmetry'``, ``'U1'``, ``'Z<N>'``
    or ``'SU2'``;
    ``codomain`` / ``domain``: lists of leg specs (domain factors in domain order);
    ``labels``: labels in ``legs`` order; ``block_inds``: ``[n_blocks, n_legs]`` int
    array (``[n_blocks]`` for a diagonal tensor); ``blocks``: list of numpy arrays in
    ``legs`` order; ``dtype``: a :class:`~cyten_tpu_torch.dtypes.Dtype` name;
    ``kind``: ``'symmetric'`` or ``'diagonal'`` (codomain == domain == ``[leg]``).
    On the fusion-tree backend (SU(2)) a block is the matrix of one coupled sector,
    ``[codomain tree basis, domain tree basis]``, and ``block_inds`` is ``[n_blocks,
    2]``: the index of that sector in the codomain's and in the domain's sector
    decomposition (a diagonal tensor's stay ``[n_blocks]``, per sector of its leg).
leg spec
    ``defining_sectors``, ``multiplicities``, ``is_dual`` and ``basis_perm`` (or None),
    as an ``ElementarySpace`` stores them.
MPS spec
    ``Bs`` and ``Ss`` (lists of tensor specs) and ``bc``.

No-symmetry tensors carry their one dense block as ``blocks[0]``.
"""

from __future__ import annotations

import re

import numpy as np

from ..backends.data import BlockSparseData, DenseData, DiagonalBlockData
from ..backends.no_symmetry import NoSymmetryBackend
from ..dtypes import Dtype
from ..symmetries import SU2, ElementarySpace, NoSymmetry, Symmetry, U1, ZN

__all__ = ['symmetry_from_names', 'leg_from_spec', 'tensor_from_arrays',
           'mps_from_arrays']


def symmetry_from_names(names) -> Symmetry:
    """``['U1', 'Z2']`` -> ``U1 x Z2``; ``['SU2']`` -> SU(2)."""
    factors = []
    for name in names:
        m = re.fullmatch(r'Z(\d+)', name)
        if name == 'U1':
            factors.append(U1())
        elif name == 'SU2':
            factors.append(SU2())
        elif name == 'NoSymmetry':
            factors.append(NoSymmetry())
        elif m:
            factors.append(ZN(int(m.group(1))))
        else:
            raise ValueError(f'unknown symmetry factor {name!r}')
    res = factors[0].as_Symmetry()
    for f in factors[1:]:
        res = res * f
    return res


def leg_from_spec(spec: dict, symmetry: Symmetry) -> ElementarySpace:
    basis_perm = spec.get('basis_perm')
    return ElementarySpace(symmetry, np.asarray(spec['defining_sectors']),
                           np.asarray(spec['multiplicities']),
                           is_dual=bool(spec['is_dual']),
                           basis_perm=None if basis_perm is None else np.asarray(basis_perm))


def tensor_from_arrays(spec: dict, backend):
    """A ``SymmetricTensor`` or ``DiagonalTensor`` of ``backend`` from a tensor spec."""
    from ..tensors import DiagonalTensor, SymmetricTensor

    symmetry = symmetry_from_names(spec['symmetry'])
    codomain = [leg_from_spec(s, symmetry) for s in spec['codomain']]
    domain = [leg_from_spec(s, symmetry) for s in spec['domain']]
    dtype = Dtype[spec['dtype']]
    bb = backend.block_backend
    blocks = [bb.as_block(np.asarray(b), dtype) for b in spec['blocks']]
    kind = spec.get('kind', 'symmetric')
    if isinstance(backend, NoSymmetryBackend):
        data = DenseData(blocks[0], dtype)
    elif kind == 'diagonal':
        data = DiagonalBlockData(blocks, np.asarray(spec['block_inds']), dtype,
                                 is_sorted=True)
    else:
        data = BlockSparseData(blocks, np.asarray(spec['block_inds']), dtype,
                               is_sorted=True)
    if kind == 'diagonal':
        return DiagonalTensor(data, codomain[0], backend, spec['labels'])
    if kind != 'symmetric':
        raise ValueError(f'unknown tensor kind {kind!r}')
    return SymmetricTensor(data, codomain, domain, backend, spec['labels'])


def mps_from_arrays(spec: dict, backend):
    """A :class:`~cyten_tpu_torch.algorithms.SimpleMPS` of ``backend`` from an MPS spec."""
    from ..algorithms.mps import SimpleMPS

    return SimpleMPS([tensor_from_arrays(s, backend) for s in spec['Bs']],
                     [tensor_from_arrays(s, backend) for s in spec['Ss']],
                     bc=spec.get('bc', 'finite'))
