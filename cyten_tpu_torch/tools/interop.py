"""Tensors and MPS from plain numpy arrays and dicts.

The port holds no reference to ``cyten_tpu`` objects. State crosses over as a plain
spec, which an exporter on the other side writes (the parity tests hold one):

tensor spec
    ``symmetry``: list of factor names, each ``'NoSymmetry'``, ``'U1'``, ``'Z<N>'``,
    ``'SU2'``, ``'FermionParity'``, ``'FermionNumber'``, or the class name of an
    anyonic category of ``symmetries/anyons.py`` with its constructor's arguments
    (``_init_args``), as in ``'FibonacciAnyonCategory(handedness=right)'`` or
    ``'ZNAnyonCategory(N=3,n=1)'``; a factor with a descriptive name carries it after
    a colon, as in ``'FermionNumber:N'`` or ``'U1:2*Sz'`` (symmetries with other
    names are not equal);
    ``codomain`` / ``domain``: lists of leg specs (domain factors in domain order);
    ``labels``: labels in ``legs`` order; ``block_inds``: ``[n_blocks, n_legs]`` int
    array (``[n_blocks]`` for a diagonal tensor); ``blocks``: list of numpy arrays in
    ``legs`` order (complex128 blocks for a complex tensor); ``dtype``: a
    :class:`~cyten_tpu_torch.dtypes.Dtype` name;
    ``kind``: ``'symmetric'`` or ``'diagonal'`` (codomain == domain == ``[leg]``).
    On the fusion-tree backend (SU(2), anyons) a block is the matrix of one coupled sector,
    ``[codomain tree basis, domain tree basis]``, and ``block_inds`` is ``[n_blocks,
    2]``: the index of that sector in the codomain's and in the domain's sector
    decomposition (a diagonal tensor's stay ``[n_blocks]``, per sector of its leg).
leg spec
    ``defining_sectors``, ``multiplicities``, ``is_dual`` and ``basis_perm`` (or None),
    as an ``ElementarySpace`` stores them.
MPS spec
    ``Bs`` and ``Ss`` (lists of tensor specs) and ``bc``.
MPO spec
    ``tensors`` (a list of tensor specs, legs ``[wL, p, wR, p*]``) and ``max_range``.
coupling spec
    ``factorization`` (a list of tensor specs, one per site, legs ``[wL, p, wR, p*]``)
    and ``name``.

No-symmetry tensors carry their one dense block as ``blocks[0]``.
"""

from __future__ import annotations

import re

import numpy as np

from ..backends.data import BlockSparseData, DenseData, DiagonalBlockData
from ..backends.no_symmetry import NoSymmetryBackend
from ..dtypes import Dtype
from ..symmetries import (
    SU2, U1, ZN, ElementarySpace, FermionNumber, FermionParity, NoSymmetry, Symmetry,
    anyons,
)

__all__ = ['symmetry_from_names', 'leg_from_spec', 'tensor_from_arrays',
           'mps_from_arrays', 'mpo_from_arrays', 'coupling_from_arrays']


def _anyon_factor(name: str):
    """The anyonic category named ``'Class'`` or ``'Class(key=value,...)'`` (values
    int or str), or None if ``name`` names none."""
    m = re.fullmatch(r'(\w+)(?:\((.*)\))?', name)
    if m is None or m.group(1) not in anyons.__all__:
        return None
    kwargs = {}
    for item in filter(None, (m.group(2) or '').split(',')):
        key, _, value = item.partition('=')
        value = value.strip()
        kwargs[key.strip()] = int(value) if re.fullmatch(r'-?\d+', value) else value
    return getattr(anyons, m.group(1))(**kwargs)


_NAMED_FACTORS = {'U1': U1, 'SU2': SU2, 'NoSymmetry': NoSymmetry,
                  'FermionParity': FermionParity, 'FermionNumber': FermionNumber}


def symmetry_from_names(names) -> Symmetry:
    """``['U1', 'Z2']`` -> ``U1 x Z2``; ``['SU2']`` -> SU(2);
    ``['FermionNumber:N', 'U1:2*Sz']`` -> the Hubbard site's symmetry, names included;
    ``['FibonacciAnyonCategory(handedness=left)']`` -> Fibonacci anyons."""
    factors = []
    for full_name in names:
        name, _, descriptive_name = full_name.partition(':')
        m = re.fullmatch(r'Z(\d+)', name)
        if name in _NAMED_FACTORS:
            factor = _NAMED_FACTORS[name]()
        elif m:
            factor = ZN(int(m.group(1)))
        elif (factor := _anyon_factor(name)) is None:
            raise ValueError(f'unknown symmetry factor {full_name!r}')
        if descriptive_name:
            factor.descriptive_name = descriptive_name
        factors.append(factor)
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


def mpo_from_arrays(spec: dict, backend):
    """The port's :class:`~cyten_tpu_torch.algorithms.models.MpoTensors` of ``backend``
    from an MPO spec."""
    from ..algorithms.models import MpoTensors

    res = MpoTensors([tensor_from_arrays(s, backend) for s in spec['tensors']])
    res.max_range = int(spec.get('max_range', 1))
    return res


def coupling_from_arrays(spec: dict, sites):
    """A :class:`~cyten_tpu_torch.models.Coupling` on the port's ``sites`` (its
    tensors on the first site's backend) from a coupling spec."""
    from ..models.couplings import Coupling

    backend = sites[0].backend
    return Coupling([tensor_from_arrays(s, backend) for s in spec['factorization']],
                    sites, spec.get('name', 'coupling'))
