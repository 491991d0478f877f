"""Free functions on tensors: contraction, structure changes, decompositions.

Role-equivalent to the function part of reference ``cyten/tensors/_tensors.py``
(tdot :6292, compose :4403, permute_legs :5463, combine_legs :4046, split_legs :5899,
svd :6063, truncate_singular_values :6633, eigh :4547, qr/lq :5667/5748, ...).
Semantics follow the reference contracts (SURVEY.md Appendix A). The counterpart of
``cyten_tpu/tensors/_functions.py`` for the abelian and no-symmetry backends.
"""

from __future__ import annotations

import math
import warnings
from numbers import Number
from typing import Sequence

import numpy as np

from ..backends._backend import truncation_mask_from_S
from ..backends.data import BlockSparseData, DiagonalBlockData
from ..dtypes import Dtype
from ..symmetries import (
    ElementarySpace, Leg, LegPipe, Space, SymmetryError, TensorProduct,
)
from ..tools.misc import duplicate_entries, inverse_permutation, to_iterable
from ._tensors import (
    ChargedTensor, DiagonalTensor, Identity, Mask, SymmetricTensor, Tensor,
    _combine_leg_labels, _dual_label_list, _dual_leg_label, _get_matching_labels,
    _split_leg_label, _mask_as_projection,
)

__all__ = [
    'add_trivial_leg', 'almost_equal', 'angle', 'apply_mask',
    'apply_mask_DiagonalTensor', 'bend_legs', 'combine_legs', 'combine_to_matrix',
    'complex_conj', 'compose', 'cutoff_inverse', 'dagger', 'eigh', 'enlarge_leg',
    'entropy', 'exp', 'eye', 'fuser_tensor', 'imag', 'inner', 'is_scalar',
    'item',
    'linear_combination', 'lq', 'move_leg', 'norm', 'on_device', 'outer',
    'partial_compose', 'partial_trace', 'tensor',
    'permute_legs', 'pinv', 'qr', 'real', 'real_if_close', 'scalar_multiply',
    'scale_axis', 'split_legs', 'sqrt', 'squeeze_legs', 'stable_log', 'svd',
    'svd_apply_mask', 'tdot', 'tensor_from_grid', 'trace', 'transpose',
    'truncate_singular_values', 'truncated_svd', 'zero_like', 'get_same_backend',
]


def get_same_backend(*tensors: Tensor):
    backend = tensors[0].backend
    assert all(t.backend is backend for t in tensors), 'mismatched backends'
    return backend


def _check_compatible_legs(legs1, legs2, expect_equal=True):
    assert len(legs1) == len(legs2), 'mismatched number of legs'
    for l1, l2 in zip(legs1, legs2):
        if expect_equal and l1 != l2:
            raise ValueError(f'incompatible legs: {l1!r} != {l2!r}')


# --- structure ------------------------------------------------------------------------------


def permute_legs(tensor: Tensor, codomain=None, domain=None, levels=None,
                 bend_right=None) -> Tensor:
    """Permute legs between and within codomain and domain.

    `codomain` / `domain` list the new (co)domain by leg position or label; the domain
    is given in left-to-right (domain factor) order. See reference :5463 for the full
    contract; `levels` / `bend_right` matter only for non-symmetric braiding.
    """
    if codomain is None and domain is None:
        raise ValueError('need codomain and/or domain')
    if codomain is None:
        domain = tensor.get_leg_idcs(domain)
        codomain = [n for n in range(tensor.num_legs) if n not in domain]
    elif domain is None:
        codomain = tensor.get_leg_idcs(codomain)
        domain = [n for n in reversed(range(tensor.num_legs)) if n not in codomain]
    else:
        codomain = tensor.get_leg_idcs(codomain)
        domain = tensor.get_leg_idcs(domain)
        specified = [*codomain, *domain]
        if duplicate_entries(specified):
            raise ValueError('duplicate legs')
        if len(specified) != tensor.num_legs:
            raise ValueError('missing legs')
    # trivial case: identity arrangement (domain listed left-to-right = descending)
    if codomain == list(range(tensor.num_codomain_legs)) \
            and domain == list(range(tensor.num_legs - 1,
                                     tensor.num_codomain_legs - 1, -1)):
        return tensor

    if isinstance(tensor, (DiagonalTensor, Mask)):
        if isinstance(tensor, DiagonalTensor) and codomain == [1] and domain == [0]:
            return transpose(tensor)
        tensor = tensor.as_SymmetricTensor()
    if isinstance(tensor, ChargedTensor):
        n = tensor.num_legs
        inv = permute_legs(tensor.invariant_part, codomain,
                           [n] + list(domain), levels=levels, bend_right=bend_right)
        return ChargedTensor(inv, tensor.charged_state)

    new_codomain = TensorProduct([tensor._as_codomain_leg(i) for i in codomain],
                                 symmetry=tensor.symmetry)
    new_domain = TensorProduct([tensor._as_domain_leg(i) for i in domain],
                               symmetry=tensor.symmetry)
    if bend_right is not None and not isinstance(bend_right, bool):
        # reference also allows per-leg lists/dicts (_tensors.py:5524-5536); we
        # support a uniform side choice — accept per-leg formats when consistent
        vals = (set(bend_right.values()) if isinstance(bend_right, dict)
                else set(bend_right)) - {None}
        if len(vals) > 1:
            raise NotImplementedError('per-leg mixed bend_right is not supported; '
                                      'use a single bool (or None for the planar '
                                      'shortest-rotation default)')
        bend_right = vals.pop() if vals else None
    data = tensor.backend.permute_legs(tensor, codomain, domain, levels,
                                       new_codomain, new_domain,
                                       bend_right=bend_right)
    if data is None:
        raise SymmetryError('need levels for non-symmetric braiding')
    labels = [tensor._labels[i] for i in codomain] \
        + [tensor._labels[i] for i in domain[::-1]]
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend, labels)


def bend_legs(tensor: Tensor, num_codomain_legs=None, num_domain_legs=None) -> Tensor:
    """Only bend legs, such that the order of ``tensor.legs`` is unchanged."""
    if num_codomain_legs is None and num_domain_legs is None:
        raise ValueError('need num_codomain_legs and/or num_domain_legs')
    if num_codomain_legs is None:
        num_codomain_legs = tensor.num_legs - num_domain_legs
    n = tensor.num_legs
    return permute_legs(tensor, codomain=list(range(num_codomain_legs)),
                        domain=list(range(n - 1, num_codomain_legs - 1, -1)))


def move_leg(tensor: Tensor, which_leg, codomain_pos=None, domain_pos=None,
             levels=None) -> Tensor:
    """Move one leg to a new position (in the codomain or the domain)."""
    i = tensor.get_leg_idx(which_leg)
    cod = [n for n in range(tensor.num_codomain_legs) if n != i]
    dom_lr = [n for n in range(tensor.num_legs - 1, tensor.num_codomain_legs - 1, -1)
              if n != i]  # descending = left-to-right domain order
    if codomain_pos is not None:
        assert domain_pos is None
        pos = codomain_pos if codomain_pos >= 0 else codomain_pos + len(cod) + 1
        cod = cod[:pos] + [i] + cod[pos:]
    else:
        assert domain_pos is not None
        pos = domain_pos if domain_pos >= 0 else domain_pos + len(dom_lr) + 1
        dom_lr = dom_lr[:pos] + [i] + dom_lr[pos:]
    return permute_legs(tensor, codomain=cod, domain=dom_lr, levels=levels)


def transpose(tensor: Tensor) -> Tensor:
    """The transpose: a map ``f: V -> W`` becomes ``f^T: W* -> V*``."""
    labels = [*reversed(tensor.domain_labels), *tensor.codomain_labels]
    if isinstance(tensor, Mask):
        # f: V -> W becomes f^T: W* -> V* with the same bool relation; the data
        # rows are (i_codomain, i_domain), so mask_dagger's column swap is
        # exactly the codomain/domain exchange (projection <-> inclusion)
        data = tensor.backend.mask_dagger(tensor)
        return Mask(data, space_in=tensor.codomain.factors[0].dual,
                    space_out=tensor.domain.factors[0].dual,
                    is_projection=not tensor.is_projection,
                    backend=tensor.backend, labels=labels)
    if isinstance(tensor, Identity):
        return Identity(tensor.leg.dual, backend=tensor.backend, labels=labels,
                        dtype=tensor.dtype)
    if isinstance(tensor, DiagonalTensor):
        dual_leg, data = tensor.backend.diagonal_transpose(tensor)
        return DiagonalTensor(data, dual_leg, tensor.backend, labels)
    if isinstance(tensor, SymmetricTensor):
        n, K = tensor.num_legs, tensor.num_codomain_legs
        return permute_legs(tensor, codomain=list(range(K, n)),
                            domain=list(range(K))[::-1])
    if isinstance(tensor, ChargedTensor):
        if not tensor.symmetry.has_trivial_braid:
            raise SymmetryError('transpose of fermionic ChargedTensor is ill-defined')
        inv = transpose(tensor.invariant_part)
        inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
        return ChargedTensor(inv, tensor.charged_state)
    raise TypeError(f'unexpected type {type(tensor)}')


def dagger(tensor: Tensor) -> Tensor:
    """The hermitian conjugate: ``f: V -> W`` becomes ``f†: W -> V``."""
    labels = _dual_label_list(tensor.labels)
    if isinstance(tensor, Mask):
        data = tensor.backend.mask_dagger(tensor)
        return Mask(data, space_in=tensor.codomain.factors[0],
                    space_out=tensor.domain.factors[0],
                    is_projection=not tensor.is_projection,
                    backend=tensor.backend, labels=labels)
    if isinstance(tensor, DiagonalTensor):
        res = complex_conj(tensor)
        res._labels = labels
        return res
    if isinstance(tensor, ChargedTensor):
        inv = dagger(tensor.invariant_part)  # charge leg now codomain[0], label '!*'
        inv.set_label(0, ChargedTensor._CHARGE_LEG_LABEL)
        inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
        state = tensor.charged_state
        bb = tensor.backend.block_backend
        if state is not None:
            state = bb.conj(state)
        # the charge leg is now dual; this matches since dagger flips it
        return ChargedTensor(inv, state)
    data = tensor.backend.dagger(tensor)
    return SymmetricTensor(data, codomain=tensor.domain, domain=tensor.codomain,
                           backend=tensor.backend, labels=labels)


def add_trivial_leg(tensor: Tensor, legs_pos: int = None, label: str = None,
                    is_dual: bool = False, to_domain: bool = None) -> Tensor:
    """Add a trivial (one-dimensional, trivial-sector) leg."""
    if isinstance(tensor, (DiagonalTensor, Mask)):
        tensor = tensor.as_SymmetricTensor()
    if isinstance(tensor, ChargedTensor):
        if legs_pos is None:
            legs_pos = tensor.num_codomain_legs if to_domain else \
                tensor.num_codomain_legs
        inv = add_trivial_leg(tensor.invariant_part, legs_pos, label, is_dual,
                              to_domain)
        return ChargedTensor(inv, tensor.charged_state)
    K = tensor.num_codomain_legs
    if legs_pos is None:
        to_domain = bool(to_domain)
        legs_pos = tensor.num_legs if to_domain else K
    else:
        legs_pos = legs_pos if legs_pos >= 0 else legs_pos + tensor.num_legs + 1
        if to_domain is None:
            to_domain = legs_pos > K
    new_space = ElementarySpace.from_trivial_sector(1, tensor.symmetry,
                                                    is_dual=is_dual if not to_domain
                                                    else not is_dual)
    if to_domain:
        co_pos = tensor.num_legs - legs_pos  # domain position (left-to-right)
        new_domain = TensorProduct(
            tensor.domain.factors[:co_pos] + [new_space]
            + tensor.domain.factors[co_pos:], symmetry=tensor.symmetry)
        new_codomain = tensor.codomain
    else:
        co_pos = legs_pos
        new_codomain = TensorProduct(
            tensor.codomain.factors[:co_pos] + [new_space]
            + tensor.codomain.factors[co_pos:], symmetry=tensor.symmetry)
        new_domain = tensor.domain
    data = tensor.backend.add_trivial_leg(tensor, legs_pos, to_domain, co_pos,
                                          new_codomain, new_domain)
    labels = tensor.labels
    labels.insert(legs_pos, label)
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend, labels)


def squeeze_legs(tensor: Tensor, legs=None) -> Tensor:
    """Remove trivial legs."""
    if isinstance(tensor, (DiagonalTensor, Mask)):
        tensor = tensor.as_SymmetricTensor()
    if legs is None:
        idcs = [n for n in range(tensor.num_legs) if tensor.get_leg(n).is_trivial]
    else:
        idcs = tensor.get_leg_idcs(legs)
        assert all(tensor.get_leg(n).is_trivial for n in idcs), 'leg is not trivial'
    if isinstance(tensor, ChargedTensor):
        inv = squeeze_legs(tensor.invariant_part, idcs)
        return ChargedTensor(inv, tensor.charged_state)
    K = tensor.num_codomain_legs
    n = tensor.num_legs
    new_codomain = TensorProduct(
        [sp for i, sp in enumerate(tensor.codomain.factors) if i not in idcs],
        symmetry=tensor.symmetry)
    new_domain = TensorProduct(
        [sp for k, sp in enumerate(tensor.domain.factors) if n - 1 - k not in idcs],
        symmetry=tensor.symmetry)
    data = tensor.backend.squeeze_legs(tensor, idcs, new_codomain, new_domain)
    labels = [l for i, l in enumerate(tensor._labels) if i not in idcs]
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend, labels)


def combine_legs(tensor: Tensor, *which_legs, pipe_dualities=False, pipes=None,
                 levels=None) -> Tensor:
    """Combine groups of legs into :class:`LegPipe`s. See reference :4046."""
    if isinstance(tensor, (DiagonalTensor, Mask)):
        tensor = tensor.as_SymmetricTensor()
    which_legs = [tensor.get_leg_idcs(group) for group in which_legs]
    if isinstance(tensor, ChargedTensor):
        inv = combine_legs(tensor.invariant_part, *which_legs,
                           pipe_dualities=pipe_dualities, pipes=pipes, levels=levels)
        return ChargedTensor(inv, tensor.charged_state)

    N = tensor.num_legs
    J = tensor.num_codomain_legs
    to_combine = [i for group in which_legs for i in group]
    if duplicate_entries(to_combine):
        raise ValueError('groups may not contain duplicates')

    # 1) permute so groups are contiguous, each fully in codomain or domain
    codomain_groups = {g[0]: g for g in which_legs if g[0] < J}
    domain_groups = {g[0]: g for g in which_legs if g[0] >= J}
    codomain_idcs = []
    domain_idcs_reversed = []
    for n in range(N):
        if n in codomain_groups:
            codomain_idcs.extend(codomain_groups[n])
        elif n in domain_groups:
            domain_idcs_reversed.extend(domain_groups[n])
        elif n in to_combine:
            pass
        elif n < J:
            codomain_idcs.append(n)
        else:
            domain_idcs_reversed.append(n)
    tensor = permute_legs(tensor, codomain_idcs, domain_idcs_reversed[::-1],
                          levels=levels)
    inv_perm = inverse_permutation([*codomain_idcs, *domain_idcs_reversed])
    which_legs = [[int(inv_perm[l]) for l in group] for group in which_legs]
    to_combine = [i for group in which_legs for i in group]
    J = tensor.num_codomain_legs
    codomain_groups = {g[0]: g for g in which_legs if g[0] < J}
    domain_groups = {g[0]: g for g in which_legs if g[0] >= J}

    # 2) build pipes, new (co)domain, labels
    if pipes is None:
        pipes = [None] * len(which_legs)
    else:
        pipes = list(pipes)
    if isinstance(pipe_dualities, bool):
        pipe_dualities = [pipe_dualities] * len(which_legs)
    group_order = sorted(range(len(which_legs)), key=lambda gi: which_legs[gi][0])
    codomain_spaces, codomain_labels = [], []
    domain_spaces_rev, domain_labels_rev = [], []
    pipes_sorted = []
    gi_sorted = 0
    for n in range(N):
        if n in codomain_groups:
            group = codomain_groups[n]
            gi = which_legs.index(group)
            spaces = tensor.codomain.factors[group[0]:group[-1] + 1]
            pipe = tensor.backend.make_pipe(spaces, is_dual=pipe_dualities[gi],
                                            pipe=pipes[gi])
            pipes[gi] = pipe
            pipes_sorted.append(pipe)
            codomain_spaces.append(pipe)
            codomain_labels.append(_combine_leg_labels(
                tensor._labels[group[0]:group[-1] + 1]))
        elif n in domain_groups:
            group = domain_groups[n]
            gi = which_legs.index(group)
            dom_idx1 = N - 1 - group[0]
            dom_idx2 = N - 1 - group[-1]
            spaces = tensor.domain.factors[dom_idx2:dom_idx1 + 1]
            pipe = tensor.backend.make_pipe(spaces, is_dual=not pipe_dualities[gi],
                                            pipe=pipes[gi])
            pipes[gi] = pipe
            pipes_sorted.append(pipe)
            domain_spaces_rev.append(pipe)
            domain_labels_rev.append(_combine_leg_labels(
                tensor._labels[group[0]:group[-1] + 1]))
        elif n in to_combine:
            pass
        elif n < J:
            codomain_spaces.append(tensor.codomain.factors[n])
            codomain_labels.append(tensor._labels[n])
        else:
            domain_spaces_rev.append(tensor.domain.factors[N - 1 - n])
            domain_labels_rev.append(tensor._labels[n])
    new_codomain = TensorProduct(codomain_spaces, symmetry=tensor.symmetry)
    new_domain = TensorProduct(domain_spaces_rev[::-1], symmetry=tensor.symmetry)

    which_legs_sorted = sorted(which_legs, key=lambda g: g[0])
    data = tensor.backend.combine_legs(tensor, which_legs_sorted, pipes_sorted,
                                       new_codomain, new_domain)
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend,
                           codomain_labels + domain_labels_rev)


def combine_to_matrix(tensor: Tensor, codomain=None, domain=None, levels=None
                      ) -> Tensor:
    """Permute legs and then combine the codomain and domain each into a single leg."""
    tensor = permute_legs(tensor, codomain=codomain, domain=domain, levels=levels)
    groups = []
    if tensor.num_codomain_legs > 1:
        groups.append(list(range(tensor.num_codomain_legs)))
    if tensor.num_domain_legs > 1:
        groups.append(list(range(tensor.num_codomain_legs, tensor.num_legs)))
    if groups:
        tensor = combine_legs(tensor, *groups)
    return tensor


def split_legs(tensor: Tensor, legs=None) -> Tensor:
    """Split legs that are :class:`LegPipe`s (inverse of :func:`combine_legs`)."""
    if isinstance(tensor, (DiagonalTensor, Mask)):
        tensor = tensor.as_SymmetricTensor()
    if isinstance(tensor, ChargedTensor):
        idcs = tensor.get_leg_idcs(to_iterable(legs)) if legs is not None else None
        inv = split_legs(tensor.invariant_part, idcs)
        return ChargedTensor(inv, tensor.charged_state)
    if legs is None:
        idcs = [n for n in range(tensor.num_legs)
                if isinstance(tensor.get_leg_co_domain(n), LegPipe)]
    else:
        idcs = sorted(tensor.get_leg_idcs(to_iterable(legs)))
        for i in idcs:
            if not isinstance(tensor.get_leg_co_domain(i), LegPipe):
                raise ValueError(f'leg {i} is not a LegPipe')
    if not idcs:
        return tensor
    K = tensor.num_codomain_legs
    N = tensor.num_legs
    new_cod_spaces, cod_labels = [], []
    for n in range(K):
        sp = tensor.codomain.factors[n]
        if n in idcs:
            new_cod_spaces.extend(sp.legs)
            cod_labels.extend(_split_leg_label(tensor._labels[n], len(sp.legs)))
        else:
            new_cod_spaces.append(sp)
            cod_labels.append(tensor._labels[n])
    new_dom_spaces, dom_labels_rev = [], []
    for n in range(K, N):  # legs order
        sp = tensor.domain.factors[N - 1 - n]
        if n in idcs:
            # pipe legs are in domain (left-to-right) order
            dom_labels_rev.extend(_split_leg_label(tensor._labels[n], len(sp.legs)))
        else:
            dom_labels_rev.append(tensor._labels[n])
    new_dom_spaces = []
    for k in range(tensor.num_domain_legs):
        sp = tensor.domain.factors[k]
        if (N - 1 - k) in idcs:
            new_dom_spaces.extend(sp.legs)
        else:
            new_dom_spaces.append(sp)
    new_codomain = TensorProduct(new_cod_spaces, symmetry=tensor.symmetry)
    new_domain = TensorProduct(new_dom_spaces, symmetry=tensor.symmetry)
    codomain_split = [i for i in idcs if i < K]
    domain_split = [i for i in idcs if i >= K]
    data = tensor.backend.split_legs(tensor, idcs, codomain_split, domain_split,
                                     new_codomain, new_domain)
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend,
                           cod_labels + dom_labels_rev)


# --- contraction / arithmetic ----------------------------------------------------------------


def compose(tensor1: Tensor, tensor2: Tensor, relabel1=None, relabel2=None) -> Tensor:
    """Map composition ``tensor1 ∘ tensor2`` (contract ``tensor1.domain`` with
    ``tensor2.codomain``). Also available as the ``@`` operator."""
    _check_compatible_legs(tensor1.domain.factors, tensor2.codomain.factors)
    backend = get_same_backend(tensor1, tensor2)

    if isinstance(tensor1, Mask):
        res = _compose_with_Mask(tensor2, tensor1, 0)
        res.set_label(0, tensor1._labels[0])
        return _relabelled(res, relabel2)
    if isinstance(tensor2, Mask):
        res = _compose_with_Mask(tensor1, tensor2, tensor1.num_legs - 1)
        res.set_label(tensor1.num_legs - 1, tensor2._labels[-1])
        return _relabelled(res, relabel1)
    if isinstance(tensor1, DiagonalTensor) and isinstance(tensor2, DiagonalTensor):
        res = tensor1 * tensor2
        res._labels = [tensor1._labels[0], tensor2._labels[1]]
        return res
    if isinstance(tensor1, DiagonalTensor):
        res = scale_axis(tensor2, tensor1, 0)
        res.set_label(0, tensor1._labels[0])
        return _relabelled(res, relabel2)
    if isinstance(tensor2, DiagonalTensor):
        res = scale_axis(tensor1, tensor2, tensor1.num_legs - 1)
        res.set_label(tensor1.num_legs - 1, tensor2._labels[1])
        return _relabelled(res, relabel1)
    if isinstance(tensor1, ChargedTensor) or isinstance(tensor2, ChargedTensor):
        # route through tdot, which handles the hidden charge leg
        n1 = tensor1.num_legs
        m = tensor1.num_domain_legs
        legs1 = list(range(n1 - 1, n1 - 1 - m, -1))
        legs2 = list(range(m))
        return tdot(tensor1, tensor2, legs1, legs2, relabel1, relabel2)

    t1 = tensor1.as_SymmetricTensor() if not isinstance(tensor1, SymmetricTensor) \
        else tensor1
    t2 = tensor2.as_SymmetricTensor() if not isinstance(tensor2, SymmetricTensor) \
        else tensor2
    data = backend.compose(t1, t2)
    labels1 = tensor1.codomain_labels
    labels2 = tensor2.domain_labels
    if relabel1:
        labels1 = [relabel1.get(l, l) for l in labels1]
    if relabel2:
        labels2 = [relabel2.get(l, l) for l in labels2]
    return SymmetricTensor(data, tensor1.codomain, tensor2.domain, backend,
                           [labels1, labels2])


def _relabelled(t, relabel):
    if relabel:
        return t.relabelled(relabel, inplace=True)
    return t


def _compose_with_Mask(tensor: Tensor, mask: Mask, leg_idx: int, from_left=False,
                       relabel_t=None, relabel_m=None) -> Tensor:
    """Contract a mask (or its dagger) onto one leg of `tensor`.

    The mask must fit the leg: shrinks it (projection-like application) or
    enlarges it (inclusion-like).
    """
    leg_idx = tensor.get_leg_idx(leg_idx)
    if isinstance(tensor, (DiagonalTensor, Mask)):
        tensor = tensor.as_SymmetricTensor()
    if isinstance(tensor, ChargedTensor):
        inv = _compose_with_Mask(tensor.invariant_part, mask, leg_idx)
        return ChargedTensor(inv, tensor.charged_state)
    in_codomain = leg_idx < tensor.num_codomain_legs
    factor = tensor.get_leg_co_domain(leg_idx)
    # decide shrink vs enlarge by which mask leg matches the tensor leg
    if factor == mask.large_leg or factor == mask.large_leg.dual:
        shrink = True
        new_leg = mask.small_leg if factor == mask.large_leg else mask.small_leg.dual
    elif factor == mask.small_leg or factor == mask.small_leg.dual:
        shrink = False
        new_leg = mask.large_leg if factor == mask.small_leg else mask.large_leg.dual
    else:
        raise ValueError('mask does not fit the leg')
    proj = mask if mask.is_projection else _mask_as_projection(mask)
    if in_codomain:
        new_codomain = TensorProduct(
            tensor.codomain.factors[:leg_idx] + [new_leg]
            + tensor.codomain.factors[leg_idx + 1:], symmetry=tensor.symmetry)
        new_domain = tensor.domain
    else:
        k = tensor.num_legs - 1 - leg_idx
        new_codomain = tensor.codomain
        new_domain = TensorProduct(
            tensor.domain.factors[:k] + [new_leg] + tensor.domain.factors[k + 1:],
            symmetry=tensor.symmetry)
    if shrink:
        data = tensor.backend.apply_mask_to_Tensor(tensor, proj, leg_idx,
                                                   new_codomain, new_domain)
    else:
        data = tensor.backend.enlarge_leg_of_Tensor(tensor, proj, leg_idx,
                                                    new_codomain, new_domain)
    res = SymmetricTensor(data, new_codomain, new_domain, tensor.backend,
                          tensor.labels)
    return _relabelled(res, relabel_t)


def apply_mask(tensor: Tensor, mask: Mask, leg) -> Tensor:
    """Project one leg of `tensor` with a (projection) mask."""
    if isinstance(tensor, DiagonalTensor):
        return apply_mask_DiagonalTensor(tensor, mask)
    return _compose_with_Mask(tensor, mask, tensor.get_leg_idx(leg))


def apply_mask_DiagonalTensor(tensor: DiagonalTensor, mask: Mask) -> DiagonalTensor:
    """Project both legs of a DiagonalTensor."""
    assert mask.is_projection
    data = tensor.backend.apply_mask_to_DiagonalTensor(tensor, mask)
    return DiagonalTensor(data, mask.small_leg, tensor.backend, tensor.labels)


def enlarge_leg(tensor: Tensor, mask: Mask, leg) -> Tensor:
    """Embed one leg of `tensor` into a larger leg (zero-filled), via a mask."""
    return _compose_with_Mask(tensor, dagger(mask) if mask.is_projection else mask,
                              tensor.get_leg_idx(leg))


def tdot(tensor1: Tensor, tensor2: Tensor, legs1=-1, legs2=0, relabel1=None,
         relabel2=None) -> Tensor:
    """General contraction of matching legs.

    Contract ``legs1`` of `tensor1` with ``legs2`` of `tensor2` (pairwise, in order).
    Result: uncontracted `tensor1` legs in the codomain (original order), uncontracted
    `tensor2` legs in the domain (inverse order). Cf. reference :6292.
    """
    legs1 = tensor1.get_leg_idcs(to_iterable(legs1))
    legs2 = tensor2.get_leg_idcs(to_iterable(legs2))
    assert len(legs1) == len(legs2), 'mismatched number of contracted legs'
    _check_compatible_legs([tensor1._as_domain_leg(i) for i in legs1],
                           [tensor2._as_codomain_leg(i) for i in legs2])

    if isinstance(tensor1, ChargedTensor):
        if isinstance(tensor2, ChargedTensor):
            # contract the invariant parts; both charge legs stay open and are
            # combined into one (reference _tensors.py:5335-5351).
            if (tensor1.charged_state is None) != (tensor2.charged_state is None):
                raise ValueError(
                    'Mismatched: specified and unspecified ChargedTensor.charged_state')
            bang = ChargedTensor._CHARGE_LEG_LABEL
            inv = tdot(tensor1.invariant_part, tensor2.invariant_part, legs1, legs2,
                       relabel1={**(relabel1 or {}), bang: bang + '1'},
                       relabel2={**(relabel2 or {}), bang: bang + '2'})
            inv = move_leg(inv, bang + '1', domain_pos=0)
            # domain_pos 1: moving to 0 would braid with the '!1' leg
            inv = move_leg(inv, bang + '2', domain_pos=1)
            return ChargedTensor.from_two_charge_legs(
                inv, tensor1.charged_state, tensor2.charged_state)
        inv = tdot(tensor1.invariant_part, tensor2, legs1, legs2,
                   relabel1=relabel1, relabel2=relabel2)
        inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
        return ChargedTensor(inv, tensor1.charged_state)
    if isinstance(tensor2, ChargedTensor):
        inv = tdot(tensor1, tensor2.invariant_part, legs1, legs2,
                   relabel1=relabel1, relabel2=relabel2)
        inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
        return ChargedTensor(inv, tensor2.charged_state)

    if isinstance(tensor1, (DiagonalTensor, Mask)):
        tensor1 = tensor1.as_SymmetricTensor()
    if isinstance(tensor2, (DiagonalTensor, Mask)):
        tensor2 = tensor2.as_SymmetricTensor()

    # uncontracted legs keep their relative order
    open1 = [n for n in range(tensor1.num_legs) if n not in legs1]
    open2 = [n for n in range(tensor2.num_legs) if n not in legs2]

    backend = get_same_backend(tensor1, tensor2)
    if (hasattr(backend, 'tdot_data') and type(tensor1) is SymmetricTensor
            and type(tensor2) is SymmetricTensor):
        # direct path: all block pairs as one grouped GEMM
        data = backend.tdot_data(tensor1, tensor2, legs1, legs2)
        codomain = TensorProduct([tensor1._as_codomain_leg(i) for i in open1],
                                 symmetry=tensor1.symmetry)
        domain = TensorProduct([tensor2._as_domain_leg(j) for j in open2[::-1]],
                               symmetry=tensor2.symmetry)
        labels1 = [tensor1._labels[i] for i in open1]
        labels2 = [tensor2._labels[j] for j in open2]
        if relabel1:
            labels1 = [relabel1.get(l, l) for l in labels1]
        if relabel2:
            labels2 = [relabel2.get(l, l) for l in labels2]
        return SymmetricTensor(data, codomain, domain, backend, labels1 + labels2)

    t1 = permute_legs(tensor1, codomain=open1, domain=legs1)
    t2 = permute_legs(tensor2, codomain=legs2, domain=open2[::-1])
    res = compose(t1, t2, relabel1=relabel1, relabel2=relabel2)
    return res


def partial_compose(tensor1: Tensor, tensor2: Tensor, tensor1_first_leg,
                    relabel1=None, relabel2=None) -> Tensor:
    """Compose on a *part* of the (co)domain (reference _tensors.py:5206).

    If `tensor1_first_leg` is in the codomain of `tensor1`, the full domain of
    `tensor2` attaches there (tensor2 sits on top); otherwise the full codomain of
    `tensor2` attaches to part of tensor1's domain (tensor2 sits below). The result's
    legs are those of `tensor1` with the contracted ones replaced by the open legs
    of `tensor2`.

    The contraction is routed *planarly* (cyclic rotation -> compose -> rotate
    back, bends only), so it works for anyonic symmetries without braid levels —
    matching the reference, whose dedicated ``backend.partial_compose`` never
    braids.
    """
    i0 = tensor1.get_leg_idx(tensor1_first_leg)
    K = tensor1.num_codomain_legs
    n1 = tensor1.num_legs
    lab1 = list(tensor1.labels)
    if relabel1:
        lab1 = [relabel1.get(l, l) for l in lab1]
    if i0 < K:
        # tensor2 sits on top: its full domain attaches to codomain legs
        # i0..i0+m-1; tensor1.codomain[i0] pairs with tensor2.domain[0]
        m = tensor2.num_domain_legs
        m2 = tensor2.num_codomain_legs
        assert i0 + m <= K, 'contracted legs exceed the codomain'
        t2_open = list(tensor2.labels[:m2])
        if relabel2:
            t2_open = [relabel2.get(l, l) for l in t2_open]
        res_labels = lab1[:i0] + t2_open + lab1[i0 + m:]
        out = _partial_compose_top(tensor1, tensor2, i0, m, m2)
        return out.relabelled(res_labels)
    # tensor2 sits below: its full codomain attaches to domain legs (in legs
    # order) i0..i0+m-1; tensor1 leg i0 pairs with tensor2.codomain[-1].
    # Implemented as the dagger-mirror of the top case (dagger is planar/exact).
    m = tensor2.num_codomain_legs
    m2 = tensor2.num_domain_legs
    assert i0 + m <= n1, 'contracted legs exceed the legs'
    t2_open = list(tensor2.labels[m:])  # open legs in legs order
    if relabel2:
        t2_open = [relabel2.get(l, l) for l in t2_open]
    res_labels = lab1[:i0] + t2_open + lab1[i0 + m:]
    i0_d = n1 - i0 - m  # mirrored slice start in dagger(tensor1)'s codomain
    out = dagger(_partial_compose_top(dagger(tensor1), dagger(tensor2),
                                      i0_d, m, m2))
    return out.relabelled(res_labels)


def _partial_compose_top(t1: Tensor, t2: Tensor, i0: int, m: int, m2: int
                         ) -> Tensor:
    """``t2`` (m2 <- m legs) attached on top of codomain legs i0..i0+m-1 of ``t1``.

    Planar route: cyclically rotate ``t1`` so the slice IS the codomain (bends
    only), contract the full boundary via tdot (which dispatches Mask/Diagonal/
    Charged specializations), rotate back. No step braids, so no levels needed.
    """
    K = t1.num_codomain_legs
    n1 = t1.num_legs
    assert 0 < m
    # rotate: codomain = the slice; domain = the rest, keeping the cyclic order
    cod = list(range(i0, i0 + m))
    dom = [*range(i0 - 1, -1, -1), *range(n1 - 1, i0 + m - 1, -1)]
    rot = permute_legs(t1, codomain=cod, domain=dom)
    # contract t2.domain (factors j = legs n2-1-j) with rot.codomain (factor j)
    n2 = t2.num_legs
    res = tdot(t2, rot, list(range(n2 - 1, n2 - 1 - m, -1)), list(range(m)))
    # res legs (as t1/t2 legs): [t2 open (m2), t1: i0+m..n1-1, t1: 0..i0-1]
    base2 = m2 + (K - i0 - m)   # start of t1's original domain legs in res
    base3 = base2 + (n1 - K)    # start of t1 legs 0..i0-1 in res
    new_cod = [*range(base3, base3 + i0), *range(0, m2 + K - i0 - m)]
    new_dom = list(range(base2 + (n1 - K) - 1, base2 - 1, -1))
    return permute_legs(res, codomain=new_cod, domain=new_dom)


def tensor(obj, codomain, domain=None, backend=None, labels=None, dtype=None
           ) -> SymmetricTensor:
    """Convert an object (Tensor or array-like) to a SymmetricTensor
    (reference _tensors.py:3613)."""
    if isinstance(obj, Tensor):
        res = obj.as_SymmetricTensor()
        if labels is not None:
            res = res.copy(deep=False)
            res.labels = labels
        return res
    return SymmetricTensor.from_dense_block(obj, codomain, domain, backend=backend,
                                            labels=labels, dtype=dtype)


def on_device(tensor: Tensor, device: str, copy: bool = True) -> Tensor:
    """Move a tensor to the given device (torch device string, e.g. 'cuda:0')."""
    res = tensor.copy(deep=False) if copy else tensor
    return res.move_to_device(device)


def outer(tensor1: Tensor, tensor2: Tensor, relabel1=None, relabel2=None) -> Tensor:
    """Tensor product: domain ``[*t1.domain, *t2.domain]``, codomain likewise."""
    assert tensor1.symmetry.is_equivalent_to(tensor2.symmetry)
    if isinstance(tensor1, (Mask, DiagonalTensor)):
        tensor1 = tensor1.as_SymmetricTensor()
    if isinstance(tensor2, (Mask, DiagonalTensor)):
        tensor2 = tensor2.as_SymmetricTensor()
    if isinstance(tensor1, ChargedTensor) or isinstance(tensor2, ChargedTensor):
        if isinstance(tensor1, ChargedTensor) and isinstance(tensor2, ChargedTensor):
            bang = ChargedTensor._CHARGE_LEG_LABEL
            inv = outer(tensor1.invariant_part, tensor2.invariant_part,
                        relabel1={**(relabel1 or {}), bang: f'{bang}1'},
                        relabel2={**(relabel2 or {}), bang: f'{bang}2'})
            # domain is [!1, *dom1, !2, *dom2]; bring !2 next to !1
            inv = move_leg(inv, f'{bang}2', domain_pos=1)
            return ChargedTensor.from_two_charge_legs(
                inv, tensor1.charged_state, tensor2.charged_state)
        if isinstance(tensor1, ChargedTensor):
            inv = outer(tensor1.invariant_part, tensor2, relabel1, relabel2)
            inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
            return ChargedTensor(inv, tensor1.charged_state)
        inv = outer(tensor1, tensor2.invariant_part, relabel1, relabel2)
        inv = move_leg(inv, ChargedTensor._CHARGE_LEG_LABEL, domain_pos=0)
        return ChargedTensor(inv, tensor2.charged_state)
    backend = get_same_backend(tensor1, tensor2)
    codomain = TensorProduct(tensor1.codomain.factors + tensor2.codomain.factors,
                             symmetry=tensor1.symmetry)
    domain = TensorProduct(tensor1.domain.factors + tensor2.domain.factors,
                           symmetry=tensor1.symmetry)
    data = backend.outer(tensor1, tensor2, codomain, domain)
    labels1c, labels1d = tensor1.codomain_labels, tensor1.domain_labels
    labels2c, labels2d = tensor2.codomain_labels, tensor2.domain_labels
    if relabel1:
        labels1c = [relabel1.get(l, l) for l in labels1c]
        labels1d = [relabel1.get(l, l) for l in labels1d]
    if relabel2:
        labels2c = [relabel2.get(l, l) for l in labels2c]
        labels2d = [relabel2.get(l, l) for l in labels2d]
    return SymmetricTensor(data, codomain, domain, backend,
                           [labels1c + labels2c, labels1d + labels2d])


def inner(A: Tensor, B: Tensor, do_dagger: bool = True):
    """Frobenius inner product ``Tr[dagger(A) ∘ B]`` (or ``Tr[A ∘ B]``)."""
    if do_dagger:
        _check_compatible_legs([*A.codomain.factors, *A.domain.factors],
                               [*B.codomain.factors, *B.domain.factors])
    else:
        _check_compatible_legs([*A.codomain.factors, *A.domain.factors],
                               [*B.domain.factors, *B.codomain.factors])
    if isinstance(A, (DiagonalTensor, Mask)):
        A = A.as_SymmetricTensor()
    if isinstance(B, (DiagonalTensor, Mask)):
        B = B.as_SymmetricTensor()
    if isinstance(A, ChargedTensor) or isinstance(B, ChargedTensor):
        if isinstance(A, ChargedTensor) and isinstance(B, ChargedTensor):
            bb = A.backend.block_backend
            if A.charged_state is None or B.charged_state is None:
                raise ValueError('charged_state required for inner')
            if do_dagger:
                res = tdot(dagger(A), B, list(range(A.num_legs)),
                           list(range(A.num_legs - 1, -1, -1)))
            else:
                res = tdot(A, B, list(range(A.num_legs)),
                           list(range(A.num_legs - 1, -1, -1)))
            return item(res)
        raise SymmetryError('inner of charged and non-charged tensor vanishes')
    backend = get_same_backend(A, B)
    return backend.inner(A, B, do_dagger=do_dagger)


def partial_trace(tensor: Tensor, *pairs, levels=None, _allow_fallback=True):
    """Trace out pairs of legs. Returns a scalar if all legs are traced.

    For symmetries with non-symmetric braiding, pairs that cross (or wrap open
    legs) need explicit ``levels``; planar (non-crossing, nesting) pair
    configurations work without them.
    """
    pairs = [tensor.get_leg_idcs(pair) for pair in pairs]
    traced = [l for pair in pairs for l in pair]
    if duplicate_entries(traced):
        raise ValueError('pairs contain duplicates')
    _check_compatible_legs([tensor._as_codomain_leg(i) for i, _ in pairs],
                           [tensor._as_domain_leg(j) for _, j in pairs])
    if len(pairs) == 0:
        return tensor
    if isinstance(tensor, (DiagonalTensor, Mask)):
        return trace(tensor)
    if isinstance(tensor, ChargedTensor):
        inv = partial_trace(tensor.invariant_part, *pairs, levels=levels)
        if isinstance(inv, Tensor) and inv.num_legs == 1:
            if tensor.charged_state is None:
                raise ValueError('charged_state required for full trace')
            bb = tensor.backend.block_backend
            blk = inv.to_dense_block()
            res = bb.tensordot(blk, [0], bb.as_block(tensor.charged_state), [0])
            return bb.block_item(res)
        return ChargedTensor(inv, tensor.charged_state)
    K = tensor.num_codomain_legs
    n = tensor.num_legs
    new_codomain = TensorProduct(
        [sp for i, sp in enumerate(tensor.codomain.factors) if i not in traced],
        symmetry=tensor.symmetry)
    new_domain = TensorProduct(
        [sp for k, sp in enumerate(tensor.domain.factors)
         if (n - 1 - k) not in traced], symmetry=tensor.symmetry)
    try:
        data, is_scalar_ = tensor.backend.partial_trace(tensor, pairs, levels,
                                                        new_codomain, new_domain)
    except NotImplementedError:
        if not _allow_fallback:
            raise SymmetryError(
                'backend cannot trace this pair without levels')
        # the backend handles the pairs in one shot only when it can make every
        # pair adjacent without unprovided braid chiralities; otherwise trace
        # planar configurations iteratively (innermost pair first, cyclic
        # rotation for the wrapping pair) — exact for anyons without levels
        return _partial_trace_planar(tensor, pairs)
    if is_scalar_:
        return data
    labels = [l for i, l in enumerate(tensor._labels) if i not in traced]
    return SymmetricTensor(data, new_codomain, new_domain, tensor.backend, labels)


def _partial_trace_planar(tensor: Tensor, pairs):
    """Trace non-crossing pairs without braid levels, exactly (anyons included).

    Planarity argument: non-crossing pairs form balanced parentheses on the
    circle of legs. An innermost pair is adjacent (no untraced leg between its
    members) and can be traced directly by the backend; the pair wrapping the
    cyclic boundary (first & last leg) becomes adjacent after a planar cyclic
    rotation (bends only). Any other non-adjacent pair wraps *open* legs — its
    cap would have to braid past them, which is ambiguous without levels.
    """
    from itertools import combinations

    for (a, b), (c, d) in combinations([tuple(sorted(p)) for p in pairs], 2):
        if a < c < b < d or c < a < d < b:
            raise SymmetryError(
                'crossing trace pairs require levels for non-symmetric braiding')
    res = tensor
    remaining = [tuple(sorted(p)) for p in pairs]
    while remaining:
        adj = next((p for p in remaining if p[1] == p[0] + 1), None)
        if adj is None:
            n = res.num_legs
            wrap = next((p for p in remaining if p[0] == 0 and p[1] == n - 1),
                        None)
            if wrap is None:
                raise SymmetryError(
                    'non-adjacent trace pairs wrap open legs: the partial trace '
                    'is braid-ambiguous; pass levels')
            # planar cyclic rotation by one: leg order [1, .., n-1, 0]
            K = max(res.num_codomain_legs, 1)
            order = [(1 + k) % n for k in range(n)]
            res = permute_legs(res, codomain=order[:K], domain=order[K:][::-1])
            remaining = [tuple(sorted(((a - 1) % n, (b - 1) % n)))
                         for a, b in remaining]
            continue
        i, j = adj
        remaining.remove(adj)
        res = partial_trace(res, (i, j), _allow_fallback=False)
        remaining = [(a - sum(x < a for x in (i, j)),
                      b - sum(x < b for x in (i, j))) for a, b in remaining]
    if isinstance(res, Tensor):
        if res.num_legs == 0 or all(l.is_trivial for l in res.legs):
            return item(res)
    return res


def trace(tensor: Tensor):
    """Full trace: requires ``codomain == domain``. Returns a scalar."""
    if isinstance(tensor, DiagonalTensor):
        return tensor.backend.diagonal_sum_all(tensor)
    if isinstance(tensor, Mask):
        return trace(tensor.as_DiagonalTensor(dtype=Dtype.float64))
    if isinstance(tensor, ChargedTensor):
        return partial_trace(tensor, *[(i, tensor.num_legs - 1 - i)
                                       for i in range(tensor.num_codomain_legs)])
    _check_compatible_legs(tensor.codomain.factors, tensor.domain.factors)
    return tensor.backend.trace_full(tensor)


def scale_axis(tensor: Tensor, diag: DiagonalTensor, leg) -> Tensor:
    """Contract a DiagonalTensor onto one leg of `tensor` (leg spaces unchanged)."""
    leg_idx = tensor.get_leg_idx(leg)
    assert isinstance(diag, DiagonalTensor)
    t_leg = tensor.get_leg_co_domain(leg_idx)
    if not (t_leg == diag.leg or t_leg == diag.leg.dual):
        raise ValueError('diag does not fit the leg')
    if isinstance(tensor, (DiagonalTensor, Mask)):
        if isinstance(tensor, DiagonalTensor):
            return tensor * diag.set_labels(tensor.labels)
        tensor = tensor.as_SymmetricTensor()
    if isinstance(tensor, ChargedTensor):
        inv = scale_axis(tensor.invariant_part, diag, leg_idx)
        return ChargedTensor(inv, tensor.charged_state)
    data = tensor.backend.scale_axis(tensor, diag, leg_idx)
    return SymmetricTensor(data, tensor.codomain, tensor.domain, tensor.backend,
                           tensor.labels)


def scalar_multiply(a: Number, v: Tensor) -> Tensor:
    """The scalar multiple ``a * v``."""
    if isinstance(v, Mask):
        v = v.as_SymmetricTensor()
    if isinstance(v, ChargedTensor):
        if v.charged_state is None:
            inv = scalar_multiply(a, v.invariant_part)
            return ChargedTensor(inv, None)
        bb = v.backend.block_backend
        return ChargedTensor(v.invariant_part,
                             bb.mul(a, bb.as_block(v.charged_state)))
    data = v.backend.mul(a, v)
    if isinstance(v, DiagonalTensor):
        return DiagonalTensor(data, v.leg, v.backend, v.labels)
    return SymmetricTensor(data, v.codomain, v.domain, v.backend, v.labels)


def linear_combination(a: Number, v: Tensor, b: Number, w: Tensor) -> Tensor:
    """The linear combination ``a * v + b * w``."""
    _check_compatible_legs([*v.codomain.factors, *v.domain.factors],
                           [*w.codomain.factors, *w.domain.factors])
    if isinstance(v, Mask):
        v = v.as_SymmetricTensor()
    if isinstance(w, Mask):
        w = w.as_SymmetricTensor()
    if isinstance(v, ChargedTensor) and isinstance(w, ChargedTensor):
        # reference _tensors.py:4975-4987
        if v.charge_leg != w.charge_leg:
            raise ValueError('Can not add ChargedTensors with different charge legs')
        if (v.charged_state is None) != (w.charged_state is None):
            raise ValueError('Can not add ChargedTensors with unspecified and '
                             'specified charged_state')
        if v.charged_state is None:
            return ChargedTensor(
                linear_combination(a, v.invariant_part, b, w.invariant_part), None)
        if v.charge_leg.dim == 1:
            bb = v.backend.block_backend
            factor = bb.block_item(bb.as_block(w.charged_state)) \
                / bb.block_item(bb.as_block(v.charged_state))
            inv = linear_combination(a, v.invariant_part,
                                     factor * b, w.invariant_part)
            return ChargedTensor(inv, v.charged_state)
        raise NotImplementedError('linear_combination of fixed-state '
                                  'ChargedTensors with dim > 1 charge leg')
    if isinstance(v, ChargedTensor) or isinstance(w, ChargedTensor):
        raise TypeError('Can not add ChargedTensor and non-charged tensor.')
    if isinstance(v, DiagonalTensor) != isinstance(w, DiagonalTensor):
        if isinstance(v, DiagonalTensor):
            v = v.as_SymmetricTensor()
        else:
            w = w.as_SymmetricTensor()
    backend = get_same_backend(v, w)
    data = backend.linear_combination(a, v, b, w)
    labels = _get_matching_labels(v._labels, w._labels)
    if isinstance(v, DiagonalTensor):
        return DiagonalTensor(data, v.leg, backend, labels)
    return SymmetricTensor(data, v.codomain, v.domain, backend, labels)


def norm(tensor: Tensor) -> float:
    """Frobenius norm."""
    if isinstance(tensor, Mask):
        return math.sqrt(tensor.small_leg.dim)
    if isinstance(tensor, ChargedTensor):
        if tensor.charged_state is None:
            raise ValueError('norm of ChargedTensor requires charged_state')
        if tensor.charge_leg.dim == 1:
            bb = tensor.backend.block_backend
            factor = abs(bb.block_item(bb.as_block(tensor.charged_state)))
            return factor * tensor.backend.norm(tensor.invariant_part)
        return math.sqrt(abs(inner(tensor, tensor)))
    return tensor.backend.norm(tensor)


def item(tensor: Tensor):
    """The single entry of a tensor whose legs are all trivial."""
    if isinstance(tensor, ChargedTensor):
        blk = tensor.to_dense_block()
        return tensor.backend.block_backend.block_item(blk)
    if isinstance(tensor, Mask):
        return bool(tensor.as_DiagonalTensor().sum())
    assert all(l.is_trivial for l in tensor.legs), 'legs are not trivial'
    return tensor.backend.item(tensor)


def is_scalar(obj) -> bool:
    if isinstance(obj, Number):
        return True
    if isinstance(obj, Tensor):
        return all(l.is_trivial for l in obj.legs)
    return False


def almost_equal(t1: Tensor, t2: Tensor, rtol: float = 1e-5, atol: float = 1e-8
                 ) -> bool:
    """Whether ``norm(t1 - t2) <= atol + rtol * norm(t1)``."""
    if isinstance(t1, ChargedTensor) != isinstance(t2, ChargedTensor):
        raise TypeError('can not compare ChargedTensor with other tensor')
    if isinstance(t1, ChargedTensor):
        if (t1.charged_state is None) != (t2.charged_state is None):
            return False
        if t1.charged_state is None:
            return almost_equal(t1.invariant_part, t2.invariant_part, rtol, atol)
        if t1.charge_leg != t2.charge_leg:
            raise ValueError('Mismatched charge legs')
        if t1.charge_leg.dim == 1:
            # the represented tensor is state * invariant_part: compare
            # s1 * inv_1 against s2 * inv_2. (The reference's cross-multiplied
            # check at _tensors.py:3856-3862 tests s2*inv_1 == s1*inv_2, which
            # is equivalent only when |s1| == |s2| — an intentional deviation.)
            bb = t1.backend.block_backend
            s1 = bb.block_item(bb.as_block(t1.charged_state))
            s2 = bb.block_item(bb.as_block(t2.charged_state))
            return almost_equal(scalar_multiply(s1, t1.invariant_part),
                                scalar_multiply(s2, t2.invariant_part), rtol, atol)
        raise NotImplementedError('almost_equal of fixed-state ChargedTensors '
                                  'with dim > 1 charge leg')
    return norm(t1 - t2) <= atol + rtol * norm(t1)


def zero_like(tensor: Tensor) -> Tensor:
    if isinstance(tensor, Mask):
        return Mask.from_blockmask(np.zeros(int(tensor.large_leg.dim), bool),
                                   tensor.large_leg, tensor.backend, tensor.labels)
    if isinstance(tensor, DiagonalTensor):
        return DiagonalTensor.from_zero(tensor.leg, tensor.backend, tensor.labels,
                                        dtype=tensor.dtype)
    if isinstance(tensor, ChargedTensor):
        inv = zero_like(tensor.invariant_part)
        return ChargedTensor(inv, tensor.charged_state)
    return SymmetricTensor.from_zero(tensor.codomain, tensor.domain, tensor.backend,
                                     tensor.labels, dtype=tensor.dtype)


def eye(legs, backend=None, labels=None, dtype=Dtype.float64):
    """Identity tensor; DiagonalTensor for a single leg."""
    legs = to_iterable(legs)
    if len(legs) == 1 and isinstance(legs[0], ElementarySpace):
        return DiagonalTensor.from_eye(legs[0], backend, labels, dtype)
    return SymmetricTensor.from_eye(legs, backend, labels, dtype)


def fuser_tensor(legs, backend=None, dtype=None, labels=None) -> SymmetricTensor:
    """The unitary splitter ``S : fused -> (⊗ legs)``.

    ``fused`` is the plain :class:`ElementarySpace` carrying the sector
    decomposition of the tensor product; the blocks are identities in the
    fusion-tree basis (one multiplicity slot per (forest, mult) combination), so
    ``S`` is exactly unitary for any unitary fusion category.

    Use ``compose(t, S)`` to replace a tensor's whole domain by the fused flat
    leg, and ``compose(dagger(S), t)`` for the codomain — the CG-aware
    alternative to pipe metadata wherever a genuinely *flat* leg is needed
    (direct sums / ``tensor_from_grid``; cf. reference ``combine_legs`` +
    ``AbelianLegPipe.as_ElementarySpace``, which only exists for abelian
    symmetries).
    """
    from ..dtypes import Dtype

    legs = list(legs)
    tp = TensorProduct(legs)
    symmetry = tp.symmetry
    fused = ElementarySpace(symmetry, tp.sector_decomposition.copy(),
                            tp.multiplicities.copy())
    if dtype is None:
        dtype = Dtype.float64

    def func(shape, coupled):
        assert shape[0] == shape[-1], (shape, coupled)
        be = backend.block_backend if backend is not None else None
        eye = np.eye(shape[0])
        return be.as_block(eye, dtype) if be is not None else eye

    return SymmetricTensor.from_sector_block_func(func, legs, [fused],
                                                  backend=backend, labels=labels)


def tensor_from_grid(grid, labels=None, row_leg=0, col_leg=None) -> SymmetricTensor:
    """Stack a 2D grid of tensors (direct sum on a codomain leg and a domain leg).

    ``grid[i][j]`` contributes to block-row i of the `row_leg` (a codomain leg) and
    block-column j of the `col_leg` (a domain leg, default ``domain[0]``); ``None``
    entries are zero. All other legs must match. Cf. reference _tensors.py:6166.

    For droppable symmetries the grid is assembled densely and re-projected; for
    anyonic symmetries, entries are embedded via inclusion masks and summed —
    both paths are exact.
    """
    rows = len(grid)
    cols = len(grid[0])
    assert all(len(r) == cols for r in grid)
    proto = next(t for row in grid for t in row if t is not None)
    backend = proto.backend
    row_pos = proto.get_leg_idx(row_leg)
    col_pos = proto.get_leg_idx(col_leg) if col_leg is not None else \
        proto.num_legs - 1
    assert row_pos < proto.num_codomain_legs
    assert col_pos >= proto.num_codomain_legs
    col_factor_idx = proto.num_legs - 1 - col_pos

    row_spaces = []
    for i in range(rows):
        t = next((t for t in grid[i] if t is not None), None)
        assert t is not None, f'empty grid row {i}'
        row_spaces.append(t.codomain.factors[row_pos])
    col_spaces = []
    for j in range(cols):
        t = next((grid[i][j] for i in range(rows) if grid[i][j] is not None), None)
        assert t is not None, f'empty grid column {j}'
        col_spaces.append(t.domain.factors[col_factor_idx])
    from ..backends.fusion_tree import FusionTreeBackend

    if isinstance(backend, FusionTreeBackend) and any(
            isinstance(sp, LegPipe) for sp in (*row_spaces, *col_spaces)):
        # The fused basis of a fusion-tree pipe is a Clebsch-Gordan transform, not a
        # permutation, so pipes can not be direct-summed as metadata. Each entry's pipe
        # leg is flattened to the flat fused ElementarySpace by the unitary fuser
        # (split_legs is a data no-op on fusion-tree storage; partial_compose routes
        # planarly, so no braid levels are needed), then the flat legs are summed. The
        # summed legs of the result are plain ElementarySpaces, as on the abelian
        # backend, which sums pipe.as_ElementarySpace.
        def _flatten(t):
            if isinstance(t.codomain.factors[row_pos], LegPipe):
                pipe = t.codomain.factors[row_pos]
                label = t.labels[row_pos]
                ts = split_legs(t, row_pos)
                S = fuser_tensor(pipe.legs, backend=t.backend, dtype=t.dtype)
                t = partial_compose(ts, dagger(S), row_pos)
                t = t.relabelled([label if i == row_pos else l
                                  for i, l in enumerate(t.labels)])
            if isinstance(t.domain.factors[col_factor_idx], LegPipe):
                pipe = t.domain.factors[col_factor_idx]
                label = t.labels[col_pos]
                ts = split_legs(t, col_pos)
                # the split factors occupy legs col_pos..col_pos+m-1; the fuser goes
                # below them (its codomain the factors in domain-factor order)
                m = pipe.num_legs
                df = ts.num_legs - 1 - (col_pos + m - 1)
                S = fuser_tensor(list(ts.domain.factors[df:df + m]), backend=t.backend,
                                 dtype=t.dtype)
                t = partial_compose(ts, S, col_pos)
                t = t.relabelled([label if i == col_pos else l
                                  for i, l in enumerate(t.labels)])
            return t

        flat_grid = [[None if t is None else _flatten(t) for t in row] for row in grid]
        return tensor_from_grid(flat_grid, labels=labels, row_leg=row_pos,
                                col_leg=col_pos)
    # harmonize dualities (trivial legs may come with either flag)
    row_dual = next((sp.is_dual for sp in row_spaces if not sp.is_trivial),
                    row_spaces[0].is_dual)
    col_dual = next((sp.is_dual for sp in col_spaces if not sp.is_trivial),
                    col_spaces[0].is_dual)
    row_spaces = [sp.as_ElementarySpace(is_dual=row_dual) for sp in row_spaces]
    col_spaces = [sp.as_ElementarySpace(is_dual=col_dual) for sp in col_spaces]
    new_row = row_spaces[0].direct_sum(*row_spaces[1:]) if rows > 1 else row_spaces[0]
    new_col = col_spaces[0].direct_sum(*col_spaces[1:]) if cols > 1 else col_spaces[0]
    cod_factors = list(proto.codomain.factors)
    cod_factors[row_pos] = new_row
    dom_factors = list(proto.domain.factors)
    dom_factors[col_factor_idx] = new_col
    codomain = TensorProduct(cod_factors, symmetry=proto.symmetry)
    domain = TensorProduct(dom_factors, symmetry=proto.symmetry)
    labels = labels if labels is not None else proto.labels

    if hasattr(backend, 'from_grid'):
        # blockwise scatter, no dense detour (abelian backend)
        from ..dtypes import Dtype

        def mult_slices(parts):
            keys = {tuple(int(x) for x in sec)
                    for part in parts for sec in part.sector_decomposition}
            res = {}
            for key in keys:
                per_part = []
                for part in parts:
                    idx = part.sector_decomposition_where(np.asarray(key))
                    per_part.append(0 if idx is None
                                    else int(part.multiplicities[idx]))
                res[key] = np.concatenate([[0], np.cumsum(per_part)])
            return res

        dtype = Dtype.common(*[t.dtype for row in grid for t in row
                               if t is not None])
        data = backend.from_grid(grid, codomain, domain, row_pos, col_pos,
                                 mult_slices(row_spaces), mult_slices(col_spaces),
                                 dtype)
        return SymmetricTensor(data, codomain, domain, backend, labels)

    if proto.symmetry.can_be_dropped:
        shape = tuple(int(sp.dim) for sp in codomain.factors) \
            + tuple(int(sp.dim) for sp in reversed(domain.factors))
        block = np.zeros(shape, dtype=np.complex128)
        row_offsets = np.cumsum([0] + [int(sp.dim) for sp in row_spaces])
        col_offsets = np.cumsum([0] + [int(sp.dim) for sp in col_spaces])
        any_complex = False
        for i in range(rows):
            for j in range(cols):
                t = grid[i][j]
                if t is None:
                    continue
                arr = t.to_numpy()
                any_complex = any_complex or (np.iscomplexobj(arr)
                                              and np.any(np.abs(arr.imag) > 0))
                sl = [slice(None)] * block.ndim
                sl[row_pos] = slice(row_offsets[i], row_offsets[i + 1])
                sl[col_pos] = slice(col_offsets[j], col_offsets[j + 1])
                block[tuple(sl)] = arr
        if not any_complex:
            block = block.real
        return SymmetricTensor.from_dense_block(block, codomain, domain, backend,
                                                labels)
    # symmetric path: embed each entry via inclusion masks, then sum
    row_masks = _direct_sum_masks(new_row, row_spaces, backend)
    col_masks = _direct_sum_masks(new_col, col_spaces, backend)
    res = None
    for i in range(rows):
        for j in range(cols):
            t = grid[i][j]
            if t is None:
                continue
            emb = t
            if rows > 1:
                emb = enlarge_leg(emb, row_masks[i], row_pos)
            if cols > 1:
                emb = enlarge_leg(emb, col_masks[j], col_pos)
            res = emb if res is None else res + emb
    res.labels = labels
    return res


def _direct_sum_masks(sum_leg: ElementarySpace, parts, backend) -> list[Mask]:
    """Projection masks from a direct-sum leg onto each constituent."""
    from ..dtypes import Dtype

    bb = backend.block_backend
    # per defining sector of sum_leg: running offset (direct_sum keeps stable order)
    offsets: dict = {}
    masks = []
    for part in parts:
        sel = {}
        for a, m in zip(part.defining_sectors, part.multiplicities):
            key = tuple(a)
            sel[key] = (offsets.get(key, 0), int(m))
            offsets[key] = offsets.get(key, 0) + int(m)
        part_sel = dict(sel)

        def func(shape, sector, _sel=part_sel):
            keep = np.zeros(shape[0], dtype=bool)
            # sector is the sector_decomposition entry; defining = dual if is_dual
            key = tuple(sum_leg.symmetry.dual_sector(np.asarray(sector))) \
                if sum_leg.is_dual else tuple(np.asarray(sector))
            hit = _sel.get(key)
            if hit is not None:
                keep[hit[0]:hit[0] + hit[1]] = True
            return bb.as_block(keep, Dtype.bool)

        diag = DiagonalTensor.from_sector_block_func(func, sum_leg, backend=backend)
        masks.append(Mask.from_DiagonalTensor(diag))
    return masks


# --- elementwise functions ---------------------------------------------------------------------


def _elementwise(x, func_name: str, maps_zero_to_zero: bool, **kwargs):
    if isinstance(x, Number):
        import numpy as _np

        scalar_funcs = {
            'sqrt': _np.sqrt, 'angle': _np.angle, 'real': _np.real, 'imag': _np.imag,
            'conj': _np.conj, 'abs': abs,
            'real_if_close': lambda v, tol=100: _np.real_if_close(v, tol=tol).item(),
            'stable_log': lambda v, cutoff=1e-30: _np.log(v) if abs(v) > cutoff else 0.,
            'cutoff_inverse': lambda v, cutoff=1e-15: 1. / v if abs(v) > cutoff else 0.,
        }
        res = scalar_funcs[func_name](x, **kwargs)
        return res.item() if hasattr(res, 'item') else res
    assert isinstance(x, DiagonalTensor), f'{func_name} requires DiagonalTensor'
    bb = x.backend.block_backend
    block_funcs = {
        'sqrt': bb.sqrt, 'angle': bb.angle, 'real': bb.real, 'imag': bb.imag,
        'conj': bb.conj, 'abs': bb.abs, 'real_if_close': bb.real_if_close,
        'stable_log': bb.stable_log, 'cutoff_inverse': bb.cutoff_inverse,
    }
    return x._elementwise_unary(block_funcs[func_name], func_kwargs=kwargs,
                                maps_zero_to_zero=maps_zero_to_zero)


def sqrt(x):
    """Elementwise square root (scalars and DiagonalTensors)."""
    return _elementwise(x, 'sqrt', True)


def angle(x):
    return _elementwise(x, 'angle', True)


def imag(x):
    if isinstance(x, SymmetricTensor) and not isinstance(x, DiagonalTensor):
        if not x.dtype.is_complex:
            return zero_like(x)
        raise NotImplementedError('imag of general tensors: take 0.5j*(hc - t)')
    return _elementwise(x, 'imag', True)


def real(x):
    if isinstance(x, SymmetricTensor) and not isinstance(x, DiagonalTensor):
        if not x.dtype.is_complex:
            return x
        raise NotImplementedError('real of general tensors')
    return _elementwise(x, 'real', True)


def real_if_close(x, tol: float = 100):
    return _elementwise(x, 'real_if_close', True, tol=tol)


def stable_log(x, cutoff: float = 1e-30):
    return _elementwise(x, 'stable_log', True, cutoff=cutoff)


def cutoff_inverse(x, cutoff: float = 1e-15):
    return _elementwise(x, 'cutoff_inverse', True, cutoff=cutoff)


def complex_conj(x):
    """Complex conjugate.

    For a general SymmetricTensor the result is the entrywise conjugate expressed on
    the DUAL legs (entrywise conj intertwines the conjugate representations, so it is
    not symmetric on the original legs): ``conj(x).to_numpy() == np.conj(x.to_numpy())``
    with legs in the original order and labels dualized. The reference only supports
    the elementwise (DiagonalTensor / scalar) case (reference _tensors.py:4327).
    """
    if isinstance(x, Number):
        return np.conj(x).item()
    if isinstance(x, DiagonalTensor):
        return _elementwise(x, 'conj', True)
    if isinstance(x, Mask):
        return x
    if isinstance(x, ChargedTensor):
        raise NotImplementedError('complex_conj of ChargedTensor')
    # conj = transpose(dagger(x)), which lands with the order reversed within the
    # codomain and within the domain; permute both back (braid-free for symmetric
    # braiding; anyonic braids would need levels and are rejected by permute_legs)
    y = transpose(dagger(x))
    n, K = y.num_legs, y.num_codomain_legs
    if K > 1 or n - K > 1:
        y = permute_legs(y, codomain=list(range(K))[::-1],
                         domain=list(range(K, n)))
    labels = [_dual_leg_label(l) for l in x.labels]
    return y.set_labels(labels)


def pinv(tensor: DiagonalTensor, cutoff=1e-15) -> DiagonalTensor:
    """(Moore-Penrose) pseudo-inverse of a DiagonalTensor."""
    assert isinstance(tensor, DiagonalTensor)
    return cutoff_inverse(tensor, cutoff=cutoff)


# --- decompositions ---------------------------------------------------------------------------


def _svd_new_labels(new_labels):
    if new_labels is None:
        return None, None, None, None
    new_labels = to_iterable(new_labels)
    if len(new_labels) == 1:
        a = new_labels[0]
        return a, _dual_leg_label(a), a, _dual_leg_label(a)
    if len(new_labels) == 2:
        return new_labels[0], new_labels[1], new_labels[0], new_labels[1]
    if len(new_labels) == 4:
        return tuple(new_labels)
    raise ValueError('expected 1, 2 or 4 new labels')


def _decomposition_prepare(tensor, new_leg_dual):
    assert tensor.num_codomain_legs > 0, 'empty codomain'
    assert tensor.num_domain_legs > 0, 'empty domain'
    if isinstance(tensor, ChargedTensor):
        raise NotImplementedError('decompositions of ChargedTensors')
    tensor = tensor.as_SymmetricTensor()
    new_leg = ElementarySpace.from_largest_common_subspace(
        tensor.codomain, tensor.domain, is_dual=new_leg_dual)
    combine_codomain = combine_domain = False
    if not tensor.backend.can_decompose_tensors:
        combine_codomain = tensor.num_codomain_legs > 1
        combine_domain = tensor.num_domain_legs > 1
        groups = []
        if combine_codomain:
            groups.append(list(range(tensor.num_codomain_legs)))
        if combine_domain:
            groups.append(list(range(tensor.num_codomain_legs, tensor.num_legs)))
        if groups:
            tensor = combine_legs(tensor, *groups)
    return tensor, new_leg, combine_codomain, combine_domain


def svd(tensor: Tensor, new_labels=None, new_leg_dual: bool = False,
        algorithm: str = None):
    """Singular value decomposition ``tensor ~ U @ S @ Vh``. Cf. reference :6063."""
    a, b, c, d = _svd_new_labels(new_labels)
    tensor, new_leg, comb_cod, comb_dom = _decomposition_prepare(tensor, new_leg_dual)
    u_data, s_data, vh_data = tensor.backend.svd(tensor, new_leg, algorithm)
    U = SymmetricTensor(u_data, tensor.codomain, TensorProduct([new_leg]),
                        tensor.backend, [tensor.codomain_labels, [a]])
    S = DiagonalTensor(s_data, new_leg, tensor.backend, [b, c])
    Vh = SymmetricTensor(vh_data, TensorProduct([new_leg]), tensor.domain,
                         tensor.backend, [[d], tensor.domain_labels])
    if comb_cod:
        U = split_legs(U, 0)
    if comb_dom:
        Vh = split_legs(Vh, -1)
    return U, S, Vh


def qr(tensor: Tensor, new_labels=None, new_leg_dual: bool = False):
    """QR decomposition ``tensor = Q @ R`` with isometric Q."""
    if new_labels is None:
        a = b = None
    else:
        labels = to_iterable(new_labels)
        a, b = (labels[0], _dual_leg_label(labels[0])) if len(labels) == 1 \
            else (labels[0], labels[1])
    tensor, new_leg, comb_cod, comb_dom = _decomposition_prepare(tensor, new_leg_dual)
    q_data, r_data = tensor.backend.qr(tensor, new_leg)
    Q = SymmetricTensor(q_data, tensor.codomain, TensorProduct([new_leg]),
                        tensor.backend, [tensor.codomain_labels, [a]])
    R = SymmetricTensor(r_data, TensorProduct([new_leg]), tensor.domain,
                        tensor.backend, [[b], tensor.domain_labels])
    if comb_cod:
        Q = split_legs(Q, 0)
    if comb_dom:
        R = split_legs(R, -1)
    return Q, R


def lq(tensor: Tensor, new_labels=None, new_leg_dual: bool = False):
    """LQ decomposition ``tensor = L @ Q`` with isometric Q."""
    if new_labels is None:
        a = b = None
    else:
        labels = to_iterable(new_labels)
        a, b = (labels[0], _dual_leg_label(labels[0])) if len(labels) == 1 \
            else (labels[0], labels[1])
    tensor, new_leg, comb_cod, comb_dom = _decomposition_prepare(tensor, new_leg_dual)
    l_data, q_data = tensor.backend.lq(tensor, new_leg)
    L = SymmetricTensor(l_data, tensor.codomain, TensorProduct([new_leg]),
                        tensor.backend, [tensor.codomain_labels, [a]])
    Q = SymmetricTensor(q_data, TensorProduct([new_leg]), tensor.domain,
                        tensor.backend, [[b], tensor.domain_labels])
    if comb_cod:
        L = split_legs(L, 0)
    if comb_dom:
        Q = split_legs(Q, -1)
    return L, Q


def eigh(tensor: Tensor, new_labels=None, new_leg_dual: bool = False, sort=None):
    """Hermitian eigendecomposition ``tensor ~ V @ W @ dagger(V)``.

    Returns ``(W, V)`` with real DiagonalTensor W. Cf. reference :4547.
    """
    if new_labels is None:
        a = b = c = None
    else:
        labels = to_iterable(new_labels)
        if len(labels) == 1:
            a = c = labels[0]
            b = _dual_leg_label(a)
        elif len(labels) == 2:
            a = c = labels[0]
            b = labels[1]
        else:
            a, b, c = labels
    assert tensor.domain == tensor.codomain, 'eigh requires a square tensor'
    if isinstance(tensor, ChargedTensor):
        raise NotImplementedError
    if isinstance(tensor, DiagonalTensor):
        V = SymmetricTensor.from_eye([tensor.leg], backend=tensor.backend,
                                     labels=[tensor.codomain_labels[0], a],
                                     dtype=tensor.dtype)
        W = tensor.copy().set_labels([b, c])
        return W, V
    tensor = tensor.as_SymmetricTensor()
    combined = False
    if not tensor.backend.can_decompose_tensors and tensor.num_codomain_legs > 1:
        combined = True
        tensor = combine_legs(tensor, list(range(tensor.num_codomain_legs)),
                              list(range(tensor.num_codomain_legs, tensor.num_legs)),
                              pipe_dualities=[new_leg_dual, not new_leg_dual])
    if tensor.num_domain_legs == 1:
        new_leg = tensor.domain.factors[0]
        if not isinstance(new_leg, ElementarySpace):
            new_leg = new_leg.as_ElementarySpace() if hasattr(new_leg,
                                                              'as_ElementarySpace') \
                else new_leg
    else:
        # dense backend with multiple legs: fresh leg of matching total dimension
        new_leg = ElementarySpace.from_largest_common_subspace(
            tensor.codomain, tensor.domain, is_dual=new_leg_dual)
    w_data, v_data = tensor.backend.eigh(tensor, new_leg, sort)
    W = DiagonalTensor(w_data, new_leg, tensor.backend, [b, c])
    V = SymmetricTensor(v_data, tensor.codomain, TensorProduct([new_leg]),
                        tensor.backend, [tensor.codomain_labels, [a]])
    if combined:
        V = split_legs(V, 0)
    return W, V


def exp(obj):
    """Matrix exponential of a square tensor (or exp of a scalar).

    For a DiagonalTensor this coincides with the elementwise exponential and
    stays diagonal (reference _tensors.py:4744-4752).
    """
    if isinstance(obj, Number):
        return math.exp(obj) if not isinstance(obj, complex) else np.exp(obj).item()
    if isinstance(obj, DiagonalTensor):
        return obj._elementwise_unary(obj.backend.block_backend.exp,
                                      maps_zero_to_zero=False)
    if isinstance(obj, ChargedTensor):
        raise TypeError('ChargedTensor can not be exponentiated.')
    return _act_block_diagonal(obj, 'matrix_exp')


def _act_block_diagonal(tensor: Tensor, method: str):
    assert tensor.domain == tensor.codomain, 'requires a square tensor'
    tensor = tensor.as_SymmetricTensor()
    combined = False
    if not tensor.backend.can_decompose_tensors and tensor.num_codomain_legs > 1:
        combined = True
        tensor = combine_legs(tensor, list(range(tensor.num_codomain_legs)),
                              list(range(tensor.num_codomain_legs, tensor.num_legs)),
                              pipe_dualities=[False, True])
    block_method = getattr(tensor.backend.block_backend, method)
    data = tensor.backend.act_block_diagonal_square_matrix(tensor, block_method,
                                                           dtype_map=None)
    res = SymmetricTensor(data, tensor.codomain, tensor.domain, tensor.backend,
                          tensor.labels)
    if combined:
        res = split_legs(res)
    return res


def entropy(p, n=1):
    """(Renyi) entropy of a probability distribution (e.g. S**2 of singular values).

    For non-abelian symmetries, sector weights are counted with their quantum
    dimension (cf. reference :4703).
    """
    if isinstance(p, DiagonalTensor):
        leg = p.leg
        qdims = leg.sector_qdims
        vals = []
        weights = []
        per_sector = _diagonal_per_sector(p)
        for i, v in per_sector:
            vals.append(np.asarray(v, float))
            weights.append(np.full(len(v), float(qdims[i])))
        p_arr = np.concatenate(vals) if vals else np.zeros(0)
        w_arr = np.concatenate(weights) if weights else np.zeros(0)
    else:
        p_arr = np.asarray(p, float)
        w_arr = np.ones_like(p_arr)
    keep = p_arr > 1e-30
    p_arr = p_arr[keep]
    w_arr = w_arr[keep]
    if n == 1:
        return -float(np.sum(w_arr * p_arr * np.log(p_arr)))
    if n == np.inf:
        return -np.log(np.max(p_arr))
    return float(np.log(np.sum(w_arr * p_arr ** n)) / (1. - n))


def _diagonal_per_sector(p: DiagonalTensor):
    """[(sector_idx, numpy values)] for each sector of p.leg (missing -> zeros)."""
    from ..backends.data import DiagonalBlockData, DenseData

    bb = p.backend.block_backend
    if isinstance(p.data, DenseData):
        return [(0, bb.to_numpy(p.data.block))]
    leg = p.leg
    lookup = {int(i): n for n, i in enumerate(p.data.block_inds)}
    # ONE device->host transfer for all blocks (a per-block to_numpy costs one
    # blocking sync each, paid by every host-driven truncation decision)
    blocks = list(p.data.blocks)
    if blocks:
        flat = bb.to_numpy(bb.concatenate(blocks, axis=0))
        sizes = np.cumsum([0] + [int(b.shape[0]) for b in blocks])
        parts = [flat[sizes[k]:sizes[k + 1]] for k in range(len(blocks))]
    res = []
    for i in range(leg.num_sectors):
        n = lookup.get(i)
        if n is None:
            res.append((i, np.zeros(int(leg.multiplicities[i]))))
        else:
            res.append((i, parts[n]))
    return res


def truncate_singular_values(S: DiagonalTensor, chi_max=None, chi_min=None,
                             degeneracy_tol=None, trunc_cut=None, svd_min=None,
                             minimize_error=True, pad_to_multiple=None):
    """Compute a Mask to truncate singular values; global across sectors.

    Returns (mask, err, new_norm). Cf. reference :6633 and _backend.py:791-909.
    ``pad_to_multiple`` rounds kept counts per sector up (chi bucketing, so that
    block shapes repeat).
    """
    leg = S.leg
    per_sector = _diagonal_per_sector(S)
    qdims = leg.sector_qdims
    S_list = [np.abs(v) for _, v in per_sector]
    masks, err, new_norm = truncation_mask_from_S(
        S_list, np.asarray(qdims, float), chi_max=chi_max, chi_min=chi_min,
        degeneracy_tol=degeneracy_tol, trunc_cut=trunc_cut, svd_min=svd_min,
        minimize_error=minimize_error, pad_to_multiple=pad_to_multiple)
    # build the Mask DIRECTLY from the host-side boolean decision where the
    # public basis is per-multiplicity (abelian/no-symmetry): the former
    # DiagonalTensor detour shipped the bools to the device and fetched them
    # straight back per sector inside diagonal_to_mask — one blocking sync per
    # sector
    fast = (leg.symmetry.can_be_dropped
            and int(leg.dim) == int(np.sum(leg.multiplicities)))
    if fast:
        public = np.zeros(int(leg.dim), dtype=bool)
        for (i, _), m in zip(per_sector, masks):
            public[int(leg.slices[i, 0]):int(leg.slices[i, 1])] = m
        if leg._basis_perm is not None:
            public = public[leg.inverse_basis_perm]
        data, small_leg = S.backend.mask_from_block(public, leg)
        mask = Mask(data, space_in=leg, space_out=small_leg,
                    is_projection=True, backend=S.backend, labels=S.labels)
        # the pattern on the host, by sector: lets a mask be applied and cached by
        # its content with no device read (_PrefixMask, tensors/adaptive.py)
        mask._host_bools = tuple(
            (tuple(int(x) for x in leg.sector_decomposition[i]),
             np.asarray(m, bool).tobytes())
            for (i, _), m in zip(per_sector, masks))
    else:  # per-multiplet masks with qdim > 1 (or no dense basis)
        bb = S.backend.block_backend
        mask_by_sector = {tuple(leg.sector_decomposition[i]): m
                          for (i, _), m in zip(per_sector, masks)}

        def func(shape, sector):
            return bb.as_block(mask_by_sector[tuple(sector)], Dtype.bool)

        diag = DiagonalTensor.from_sector_block_func(func, leg,
                                                     backend=S.backend)
        diag.dtype = Dtype.bool
        mask = Mask.from_DiagonalTensor(diag)
    return mask, err, new_norm


def svd_apply_mask(U: SymmetricTensor, S: DiagonalTensor, Vh: SymmetricTensor,
                   mask: Mask):
    """Truncate an existing SVD with a mask on the new leg."""
    assert mask.is_projection
    U = _compose_with_Mask(U, dagger(mask), U.num_legs - 1)
    S = apply_mask_DiagonalTensor(S, mask)
    Vh = _compose_with_Mask(Vh, mask, 0)
    return U, S, Vh


class _PrefixMask:
    """A truncation that keeps the first ``k`` values of each sector of an SVD's new
    leg, resolved to host-side slices once.

    Static mode keeps, per sector, the multiplicity the sector had when the
    structures froze; a truncation of singular values sorted in each sector keeps a
    prefix too. A :class:`Mask` says so with boolean blocks on the device, and
    applying it there (``svd_apply_mask``) makes the host read them on every call.
    Here they are read once, from the host copy of the pattern where
    :func:`truncate_singular_values` attached one (``_host_bools``), else from the
    device: :meth:`apply` then cuts each block to its first ``k`` entries, the same
    result as ``svd_apply_mask`` with no device read. Raises ``ValueError`` for a
    mask that keeps more than a prefix of a sector.

    On the fusion-tree backend a sector's values are its multiplets: the prefix keeps
    the first ``k`` multiplets of each coupled sector, and the blocks of U and Vh
    index the new leg in another order than the leg's own where the leg is dual
    (``TensorBackend.leg_sector_map``).
    """

    def __init__(self, mask: Mask):
        if not mask.is_projection:
            raise ValueError('a prefix mask is a projection')
        bb = mask.backend.block_backend
        self.small_leg = mask.small_leg
        self.large_leg = mask.large_leg
        # the pattern on the host where truncate_singular_values left it, by sector
        host = dict(getattr(mask, '_host_bools', ()))
        self.keep = {}  # large-leg sector index -> (small-leg sector index, k)
        for (i_small, i_large), blk in zip(mask.data.block_inds, mask.data.blocks):
            sector = tuple(int(x) for x in self.large_leg.sector_decomposition[i_large])
            keep = (np.frombuffer(host[sector], bool) if sector in host
                    else bb.to_numpy(blk).astype(bool))
            k = int(keep.sum())
            if not keep[:k].all():
                raise ValueError('the mask keeps more than a prefix of a sector')
            self.keep[int(i_large)] = (int(i_small), k)
        #: the same, indexed as the blocks of U and Vh index the new leg
        self.keep_matrix = self.keep
        large = mask.backend.leg_sector_map(self.large_leg)
        if large is not None:
            small = mask.backend.leg_sector_map(self.small_leg)
            self.keep_matrix = {int(large[i_large]): (int(small[i_small]), k)
                                for i_large, (i_small, k) in self.keep.items()}

    @staticmethod
    def _cut(blocks, block_inds, leg_idx: int, keep: dict):
        """Blocks on ``large_leg`` at ``leg_idx`` cut to the kept prefix ``keep`` (by
        sector index as ``block_inds`` holds it), and their rows with that leg's
        sector index on ``small_leg``."""
        out, rows = [], []
        for blk, row in zip(blocks, block_inds):
            hit = keep.get(int(row[leg_idx]))
            if hit is None:
                continue
            i_small, k = hit
            idx = [slice(None)] * blk.ndim
            idx[leg_idx] = slice(0, k)
            out.append(blk[tuple(idx)])
            row = row.copy()
            row[leg_idx] = i_small
            rows.append(row)
        return out, np.array(rows, np.intp).reshape(len(rows), np.shape(block_inds)[1])

    def apply(self, U, S, Vh):
        """``svd_apply_mask(U, S, Vh, mask)`` for the SVD's own new leg."""
        if not (U.domain.factors[-1] == S.leg == Vh.codomain.factors[0]
                == self.large_leg):
            raise ValueError('the mask does not fit the SVD')
        col = U.data.block_inds.shape[1] - 1  # the new leg's axis and column in U
        blocks, rows = self._cut(U.data.blocks, U.data.block_inds, col, self.keep_matrix)
        U = SymmetricTensor(BlockSparseData(blocks, rows, U.data.dtype), U.codomain,
                            TensorProduct([self.small_leg]), U.backend, U.labels)
        blocks, rows = self._cut(S.data.blocks, S.data.block_inds[:, None], 0, self.keep)
        S = DiagonalTensor(DiagonalBlockData(blocks, rows[:, 0], S.data.dtype),
                           self.small_leg, S.backend, S.labels)
        blocks, rows = self._cut(Vh.data.blocks, Vh.data.block_inds, 0, self.keep_matrix)
        Vh = SymmetricTensor(BlockSparseData(blocks, rows, Vh.data.dtype),
                             TensorProduct([self.small_leg]), Vh.domain, Vh.backend,
                             Vh.labels)
        return U, S, Vh


def truncated_svd(tensor: Tensor, new_labels=None, new_leg_dual: bool = False,
                  algorithm: str = None, normalize_to: float = None, chi_max=None,
                  chi_min=None, degeneracy_tol=None, trunc_cut=None, svd_min=None):
    """SVD with truncation. Returns ``(U, S, Vh, err, renormalize)``.

    ``S`` is renormalized to ``normalize_to`` (if given); `renormalize` is the factor
    that was applied. Cf. reference :6726.
    """
    U, S, Vh = svd(tensor, new_labels=new_labels, new_leg_dual=new_leg_dual,
                   algorithm=algorithm)
    mask, err, new_norm = truncate_singular_values(
        S, chi_max=chi_max, chi_min=chi_min, degeneracy_tol=degeneracy_tol,
        trunc_cut=trunc_cut, svd_min=svd_min)
    U, S, Vh = svd_apply_mask(U, S, Vh, mask)
    if normalize_to is None:
        renormalize = 1.
    else:
        renormalize = normalize_to / new_norm
        S = scalar_multiply(renormalize, S)
    return U, S, Vh, err, renormalize
