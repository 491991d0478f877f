"""Tensor classes: SymmetricTensor, DiagonalTensor, Mask, ChargedTensor.

Role-equivalent to the class part of reference ``cyten/tensors/_tensors.py``
(Tensor :153, SymmetricTensor :816, DiagonalTensor :1525, Identity :2176, Mask :2345,
ChargedTensor :3007). Semantic contracts per SURVEY.md Appendix A:

- ``legs == [*codomain, *reversed(domain)]`` with domain legs dualized in ``legs``.
- Masks are projections (domain=[large], codomain=[small]) or inclusions (the dagger).
- ChargedTensor hides a charge leg at ``invariant_part.domain[0]``, label ``'!'``.

The counterpart of ``cyten_tpu/tensors/_tensors.py`` without the pytree
registration and the fusion-tree-only constructors (``from_tree_pairs``).
"""

from __future__ import annotations

import operator
import warnings
from abc import ABCMeta, abstractmethod
from numbers import Number
from typing import Callable, Sequence

import numpy as np

from ..backends import TensorBackend, get_backend
from ..dtypes import Dtype
from ..symmetries import (
    ElementarySpace, Leg, LegPipe, Space, Symmetry, SymmetryError, TensorProduct,
)
from ..tools.misc import duplicate_entries, to_iterable

__all__ = ['LabelledLegs', 'Tensor', 'SymmetricTensor', 'DiagonalTensor', 'Identity',
           'Mask', 'ChargedTensor', 'is_valid_leg_label', 'check_same_legs',
           'get_same_device', 'CONTRACT_SYMBOL', 'LEG_SELECT_SYMBOL',
           'OPEN_LEG_SYMBOL', 'FORBIDDEN_LEG_LABEL_CHARS']


# --- label utilities -------------------------------------------------------------------

CONTRACT_SYMBOL = '@'
"""Reserved character: contractions in planar diagrams (reference _tensors.py:46)."""

LEG_SELECT_SYMBOL = ':'
"""Reserved character: leg selection in planar diagrams (reference _tensors.py:49)."""

OPEN_LEG_SYMBOL = '->'
"""Reserved characters: open legs in planar diagrams (reference _tensors.py:52)."""

FORBIDDEN_LEG_LABEL_CHARS = [' ', '\t', '\n', ',',
                             CONTRACT_SYMBOL, LEG_SELECT_SYMBOL, *OPEN_LEG_SYMBOL]
"""Characters forbidden in leg labels — whitespace plus the planar-DSL syntax
(reference _tensors.py:55). Labels containing them would be unparseable in
:class:`~cyten_tpu.tensors.PlanarDiagram` definitions (a later slice)."""


def is_valid_leg_label(label) -> bool:
    """None, or a string without reserved characters; '?' marks unlabeled slots
    inside combined labels only."""
    if label is None:
        return True
    if not isinstance(label, str) or label.startswith('?'):
        return False
    if '?' in label and not (label.startswith('(') and label.endswith(')')):
        return False
    if any(c in label for c in FORBIDDEN_LEG_LABEL_CHARS):
        return False
    return True


def _dual_leg_label(label: str | None) -> str | None:
    """'p' <-> 'p*', combined labels swap recursively."""
    if label is None:
        return None
    if label.startswith('(') and label.endswith(')'):
        return _combine_leg_labels([_dual_leg_label(l)
                                    for l in reversed(_split_leg_label(label))])
    if label.endswith('*'):
        return label[:-1]
    return label + '*'


def _combine_leg_labels(labels) -> str:
    """Combined-leg label; unlabeled slots become numbered '?n' placeholders
    (cf. reference _tensors.py:6839)."""
    return '(' + '.'.join(f'?{n}' if l is None else l
                          for n, l in enumerate(labels)) + ')'


def _split_leg_label(label: str | None, num: int = None) -> list[str | None]:
    if label is None:
        return [None] * num
    if not (label.startswith('(') and label.endswith(')')):
        # a relabelled pipe (e.g. a purification MPS relabels '(p.q)' to 'p'):
        # the constituents are unlabeled after splitting (the reference raises
        # here, _tensors.py:6948 — lenient is strictly more useful)
        return [None] * num
    parts = []
    depth = 0
    current = ''
    for ch in label[1:-1]:
        if ch == '.' and depth == 0:
            parts.append(current)
            current = ''
            continue
        if ch == '(':
            depth += 1
        elif ch == ')':
            depth -= 1
        current += ch
    parts.append(current)
    if num is not None:
        assert len(parts) == num
    return [None if p.startswith('?') or p == '?' else p for p in parts]


def _dual_label_list(labels) -> list[str | None]:
    return [_dual_leg_label(l) for l in reversed(labels)]


def _get_matching_labels(labels1, labels2):
    """Labels from two sources; None where they conflict."""
    res = []
    for l1, l2 in zip(labels1, labels2):
        if l1 == l2:
            res.append(l1)
        elif l1 is None:
            res.append(l2)
        elif l2 is None:
            res.append(l1)
        else:
            res.append(None)
    return res


# --- base class ---------------------------------------------------------------------------


class LabelledLegs:
    """Base class implementing handling of labelled legs.

    Reference: cyten/tensors/_tensors.py:69. :class:`Tensor` inherits the label API
    from here; the class is also usable standalone for non-tensor objects with
    labelled legs.
    """

    def __init__(self, labels):
        labels = list(labels)
        dup = duplicate_entries(labels, ignore=[None])
        if len(dup) > 0:
            raise ValueError(f'Duplicate leg labels: {dup}')
        self._labels = labels
        self.num_legs = len(labels)

    @property
    def is_fully_labelled(self) -> bool:
        return None not in self._labels

    @property
    def labels(self) -> list[str | None]:
        return self._labels[:]

    @labels.setter
    def labels(self, labels):
        labels = list(labels)
        assert len(labels) == self.num_legs
        assert not duplicate_entries(labels, ignore=[None])
        invalid = [l for l in labels if not is_valid_leg_label(l)]
        if invalid:
            raise ValueError(f'Invalid leg label(s): {invalid}')
        self._labels = labels

    def get_leg_idx(self, which_leg) -> int:
        if isinstance(which_leg, str):
            try:
                return self._labels.index(which_leg)
            except ValueError:
                raise ValueError(f'No leg with label {which_leg!r}. '
                                 f'Labels: {self._labels}') from None
        idx = int(which_leg)
        if idx < 0:
            idx += self.num_legs
        if not 0 <= idx < self.num_legs:
            raise ValueError(f'Leg index out of bounds: {which_leg}')
        return idx

    def get_leg_idcs(self, which_legs) -> list[int]:
        return [self.get_leg_idx(l) for l in to_iterable(which_legs)]

    def has_label(self, label: str, *more) -> bool:
        return all(l in self._labels for l in (label, *more))

    def labels_are(self, *labels) -> bool:
        return set(labels) == set(l for l in self._labels if l is not None) \
            and len(labels) == self.num_legs

    def set_label(self, pos: int, label: str | None):
        if not is_valid_leg_label(label):
            raise ValueError(f'Invalid leg label: {label!r}')
        self._labels[self.get_leg_idx(pos)] = label
        return self

    def set_labels(self, labels):
        self.labels = labels
        return self


class Tensor(LabelledLegs, metaclass=ABCMeta):
    """Base class for tensors as morphisms ``domain -> codomain``.

    ``legs == [*codomain, *reversed(domain)]``; index ``n`` and ``n - num_legs`` refer
    to the same leg; domain legs appear dualized in ``legs``.
    """

    _forbidden_dtypes = [Dtype.bool]

    def __init__(self, codomain, domain, backend, labels, dtype: Dtype):
        codomain, domain, backend, symmetry = self._init_parse_args(codomain, domain,
                                                                    backend)
        self.codomain = codomain
        self.domain = domain
        self.backend = backend
        self.symmetry = symmetry
        self.dtype = dtype
        self.num_codomain_legs = codomain.num_factors
        self.num_domain_legs = domain.num_factors
        self.num_legs = codomain.num_factors + domain.num_factors
        self.shape = tuple(sp.dim for sp in codomain.factors) \
            + tuple(sp.dim for sp in reversed(domain.factors))
        self._labels = self._init_parse_labels(labels, codomain, domain)

    @staticmethod
    def _init_parse_args(codomain, domain, backend):
        if not isinstance(codomain, TensorProduct):
            codomain = list(codomain)
        if domain is None:
            domain = []
        if not isinstance(domain, TensorProduct):
            domain = list(domain)
        if isinstance(codomain, TensorProduct):
            symmetry = codomain.symmetry
        elif len(codomain) > 0:
            symmetry = codomain[0].symmetry
        elif isinstance(domain, TensorProduct):
            symmetry = domain.symmetry
        elif len(domain) > 0:
            symmetry = domain[0].symmetry
        else:
            raise ValueError('domain and codomain can not both be empty')
        if not isinstance(codomain, TensorProduct):
            codomain = TensorProduct(codomain, symmetry=symmetry)
        if not isinstance(domain, TensorProduct):
            domain = TensorProduct(domain, symmetry=symmetry)
        if backend is None:
            backend = get_backend(symmetry)
        else:
            assert backend.supports_symmetry(symmetry)
        return codomain, domain, backend, symmetry

    @staticmethod
    def _init_parse_labels(labels, codomain, domain, is_endomorphism: bool = False):
        num_legs = codomain.num_factors + domain.num_factors
        if labels is None:
            return [None] * num_legs
        labels = list(labels)
        # nested form [codomain_labels, domain_labels] (domain in left-to-right order)
        if len(labels) == 2 and (isinstance(labels[0], (list, tuple))
                                 or isinstance(labels[1], (list, tuple))):
            cod_labels = list(labels[0]) if labels[0] is not None \
                else [None] * codomain.num_factors
            dom_labels = list(labels[1]) if labels[1] is not None \
                else [None] * domain.num_factors
            assert len(cod_labels) == codomain.num_factors
            assert len(dom_labels) == domain.num_factors
            return cod_labels + dom_labels[::-1]
        assert len(labels) == num_legs, f'expected {num_legs} labels, got {len(labels)}'
        return labels

    def test_sanity(self):
        self.codomain.test_sanity()
        self.domain.test_sanity()
        assert self.codomain.symmetry == self.domain.symmetry == self.symmetry
        assert len(self._labels) == self.num_legs
        assert all(is_valid_leg_label(l) for l in self._labels)
        assert not duplicate_entries(self._labels, ignore=[None])
        assert self.dtype not in self._forbidden_dtypes

    # --- structure -------------------------------------------------------------------------

    @property
    def legs(self) -> list[Leg]:
        return [*self.codomain.factors,
                *(sp.dual for sp in reversed(self.domain.factors))]

    def get_leg_co_domain(self, which_leg) -> Leg:
        """The (co)domain factor at leg position `which_leg` (of ``legs``)."""
        i = self.get_leg_idx(which_leg)
        if i < self.num_codomain_legs:
            return self.codomain.factors[i]
        return self.domain.factors[self.num_legs - 1 - i]

    def get_leg(self, which_leg) -> Leg:
        """The entry of ``legs`` at the given position / label."""
        i = self.get_leg_idx(which_leg)
        if i < self.num_codomain_legs:
            return self.codomain.factors[i]
        return self.domain.factors[self.num_legs - 1 - i].dual

    def _as_codomain_leg(self, i) -> Leg:
        """The leg, as it would appear as a codomain factor."""
        i = self.get_leg_idx(i)
        if i < self.num_codomain_legs:
            return self.codomain.factors[i]
        return self.domain.factors[self.num_legs - 1 - i].dual

    def _as_domain_leg(self, i) -> Leg:
        """The leg, as it would appear as a domain factor."""
        i = self.get_leg_idx(i)
        if i < self.num_codomain_legs:
            return self.codomain.factors[i].dual
        return self.domain.factors[self.num_legs - 1 - i]

    def get_leg_idx(self, which_leg) -> int:
        if isinstance(which_leg, str):
            try:
                idx = self._labels.index(which_leg)
            except ValueError:
                raise ValueError(f'No leg with label {which_leg!r}. '
                                 f'Labels: {self._labels}') from None
            return idx
        idx = int(which_leg)
        if idx < 0:
            idx += self.num_legs
        if not 0 <= idx < self.num_legs:
            raise ValueError(f'Leg index out of bounds: {which_leg}')
        return idx

    def get_leg_idcs(self, which_legs) -> list[int]:
        return [self.get_leg_idx(l) for l in to_iterable(which_legs)]

    # --- labels ---------------------------------------------------------------------------

    @property
    def labels(self) -> list[str | None]:
        return self._labels[:]

    @labels.setter
    def labels(self, labels):
        parsed = self._init_parse_labels(labels, self.codomain, self.domain)
        assert not duplicate_entries(parsed, ignore=[None])
        invalid = [l for l in parsed if not is_valid_leg_label(l)]
        if invalid:
            raise ValueError(f'Invalid leg label(s): {invalid}')
        self._labels = parsed

    @property
    def codomain_labels(self) -> list[str | None]:
        return self._labels[:self.num_codomain_legs]

    @property
    def domain_labels(self) -> list[str | None]:
        return self._labels[self.num_codomain_legs:][::-1]

    def has_label(self, label: str, *more) -> bool:
        return all(l in self._labels for l in (label, *more))

    def labels_are(self, *labels) -> bool:
        return set(labels) == set(l for l in self._labels if l is not None) \
            and len(labels) == self.num_legs

    def relabelled(self, mapping: dict[str, str] | list, inplace: bool = False):
        if isinstance(mapping, dict):
            new_labels = [mapping.get(l, l) for l in self._labels]
        else:
            new_labels = self._init_parse_labels(mapping, self.codomain, self.domain)
        if inplace:
            self.labels = new_labels
            return self
        res = self.copy(deep=False)
        res.labels = new_labels
        return res

    def set_label(self, pos: int, label: str | None):
        if not is_valid_leg_label(label):
            raise ValueError(f'Invalid leg label: {label!r}')
        self._labels[self.get_leg_idx(pos)] = label
        return self

    def set_labels(self, labels):
        self.labels = labels
        return self

    # --- conversions ---------------------------------------------------------------------

    @abstractmethod
    def copy(self, deep=True) -> Tensor: ...

    @abstractmethod
    def to_dense_block(self): ...

    def to_numpy(self, numpy_dtype=None) -> np.ndarray:
        block = self.to_dense_block()
        return self.backend.block_backend.to_numpy(block, numpy_dtype=numpy_dtype)

    @abstractmethod
    def as_SymmetricTensor(self, warning: str = None) -> SymmetricTensor: ...

    @abstractmethod
    def _get_item(self, idcs: list[int]): ...

    def __getitem__(self, idcs):
        idcs = to_iterable(idcs)
        if len(idcs) != self.num_legs:
            raise IndexError(f'expected {self.num_legs} indices, got {len(idcs)}')
        idcs = [i % self.shape[n] for n, i in enumerate(idcs)]
        return self._get_item(idcs)

    # --- arithmetic dunders ------------------------------------------------------------------

    def __neg__(self):
        from ._functions import scalar_multiply

        return scalar_multiply(-1, self)

    def __pos__(self):
        return self

    def __add__(self, other):
        from ._functions import linear_combination

        if isinstance(other, Tensor):
            return linear_combination(1, self, 1, other)
        return NotImplemented

    def __sub__(self, other):
        from ._functions import linear_combination

        if isinstance(other, Tensor):
            return linear_combination(1, self, -1, other)
        return NotImplemented

    def __mul__(self, other):
        from ._functions import scalar_multiply

        if isinstance(other, Number):
            return scalar_multiply(other, self)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        from ._functions import scalar_multiply

        if isinstance(other, Number):
            return scalar_multiply(1. / other, self)
        return NotImplemented

    def __matmul__(self, other):
        from ._functions import compose

        if isinstance(other, Tensor):
            return compose(self, other)
        return NotImplemented

    def __float__(self):
        from ._functions import item

        res = item(self)
        if isinstance(res, complex):
            if abs(res.imag) > 1e-14 * abs(res.real):
                warnings.warn('Discarding imaginary part in float()', stacklevel=2)
            res = res.real
        return float(res)

    def __complex__(self):
        from ._functions import item

        return complex(item(self))

    # --- misc -----------------------------------------------------------------------------

    @property
    def hc(self) -> Tensor:
        from ._functions import dagger

        return dagger(self)

    @property
    def dagger(self) -> Tensor:
        """The hermitian conjugate (cf. reference _tensors.py:528)."""
        from ._functions import dagger

        return dagger(self)

    @property
    def T(self) -> Tensor:
        from ._functions import transpose

        return transpose(self)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.symmetry.can_be_dropped else 0

    @property
    def has_pipes(self) -> bool:
        """Whether any leg is a pipe (cf. reference _tensors.py:537)."""
        return any(isinstance(l, LegPipe)
                   for l in (*self.codomain.factors, *self.domain.factors))

    @property
    def num_codomain_flat_legs(self) -> int:
        """Number of flat (pipe-expanded) legs in the codomain (reference :580)."""
        return sum(l.num_flat_legs for l in self.codomain.factors)

    @property
    def num_domain_flat_legs(self) -> int:
        return sum(l.num_flat_legs for l in self.domain.factors)

    @property
    def num_flat_legs(self) -> int:
        return self.num_codomain_flat_legs + self.num_domain_flat_legs

    @property
    def num_parameters(self) -> int:
        """Dimension of the space of symmetric tensors with these legs (reference :595)."""
        from ..tools.misc import iter_common_sorted_arrays

        res = 0
        for i, j in iter_common_sorted_arrays(self.codomain.sector_decomposition,
                                              self.domain.sector_decomposition):
            res += int(self.codomain.multiplicities[i]) \
                * int(self.domain.multiplicities[j])
        return res

    def relabel(self, mapping: dict[str, str]):
        """Apply mapping to labels, in-place (cf. reference _tensors.py:130)."""
        return self.relabelled(mapping, inplace=True)

    def verify_dtype(self):
        """Check the dtype is consistent with the symmetry (reference :878)."""
        if self.symmetry.has_complex_topological_data and self.dtype.is_real:
            raise ValueError(f'Tensor with {self.symmetry} must have complex dtype')

    def __repr__(self):
        labels = ', '.join(repr(l) for l in self._labels)
        return (f'<{type(self).__name__}: legs={self.num_codomain_legs}+'
                f'{self.num_domain_legs}, shape={self.shape}, labels=[{labels}], '
                f'dtype={self.dtype}, backend={self.backend!r}>')

    @property
    def ascii_diagram(self) -> str:
        """ASCII rendering of the tensor with labeled legs (cf. reference
        _tensors.py:167-174; leg labels shown like the reference's diagrams,
        falling back to leg numbers when unlabeled)."""
        K, M = self.num_codomain_legs, self.num_domain_legs

        def tag(idx):
            lbl = self._labels[idx]
            return str(idx) if lbl is None else lbl

        top_tags = [tag(i) for i in range(self.num_legs - 1, K - 1, -1)][::-1]
        bot_tags = [tag(i) for i in range(K)]
        cell = max([4] + [len(t) + 2 for t in top_tags + bot_tags])
        width = max(K, M, 1) * cell + 3
        name = type(self).__name__[:width - 2]

        def leg_row(count):
            cells = [' '] * width
            for k in range(count):
                cells[2 + cell * k] = '|'
            return ''.join(cells)

        def tag_row(tags):
            cells = [' '] * width
            for k, s in enumerate(tags):
                pos = 2 + cell * k
                cells[pos:pos + len(s)] = s
            return ''.join(cells)

        rows = []
        if M:
            rows.append(tag_row(top_tags))
            rows.append(leg_row(M))
        body = '+' + '-' * (width - 2) + '+'
        rows.append(body)
        pad = (width - 2 - len(name)) // 2
        rows.append('|' + ' ' * pad + name + ' ' * (width - 2 - pad - len(name))
                    + '|')
        rows.append(body)
        if K:
            rows.append(leg_row(K))
            rows.append(tag_row(bot_tags))
        return '\n'.join(rows)

    def dbg(self):
        print(self.ascii_diagram)
        print(repr(self))

    def move_to_device(self, device: str):
        self.data = self.backend.move_to_device(self, device)
        return self

    @property
    def device(self) -> str:
        return self.backend.get_device_from_data(self.data)


class SymmetricTensor(Tensor):
    """A tensor that is symmetric (a morphism of symmetry representations)."""

    def __init__(self, data, codomain, domain=None, backend=None, labels=None):
        if backend is None:
            dtype = data.dtype
        else:
            dtype = backend.get_dtype_from_data(data)
        Tensor.__init__(self, codomain, domain, backend, labels, dtype)
        self.data = data

    def test_sanity(self):
        super().test_sanity()
        self.backend.test_tensor_sanity(self, is_diagonal=isinstance(
            self, DiagonalTensor))

    # --- constructors -----------------------------------------------------------------------

    @classmethod
    def from_dense_block(cls, block, codomain, domain=None, backend=None, labels=None,
                         dtype=None, tol=1e-6):
        """From a dense block in the public basis, ``legs`` order. Projects onto the
        symmetric subspace; raises if the block deviates by more than `tol` (relative)."""
        codomain, domain, backend, symmetry = cls._init_parse_args(codomain, domain,
                                                                   backend)
        if not symmetry.can_be_dropped:
            raise SymmetryError(f'from_dense_block is meaningless for {symmetry}.')
        block = backend.block_backend.as_block(block, dtype)
        expect_shape = tuple(int(sp.dim) for sp in codomain.factors) \
            + tuple(int(sp.dim) for sp in reversed(domain.factors))
        if backend.block_backend.get_shape(block) != expect_shape:
            raise ValueError(f'wrong block shape: '
                             f'{backend.block_backend.get_shape(block)} != '
                             f'{expect_shape} (legs order)')
        data = backend.from_dense_block(block, codomain, domain, tol)
        return cls(data, codomain, domain, backend, labels)

    @classmethod
    def from_zero(cls, codomain, domain=None, backend=None, labels=None,
                  dtype=Dtype.float64):
        codomain, domain, backend, _ = cls._init_parse_args(codomain, domain, backend)
        return cls(backend.zero_data(codomain, domain, dtype), codomain, domain,
                   backend, labels)

    @classmethod
    def from_eye(cls, legs, backend=None, labels=None, dtype=Dtype.float64):
        """Identity map on the product of the given legs (codomain = given legs)."""
        legs = to_iterable(legs)
        codomain = legs if isinstance(legs, TensorProduct) \
            else TensorProduct([l for l in legs])
        # identity map codomain -> codomain; the domain lists the same spaces
        domain = TensorProduct(list(codomain.factors), symmetry=codomain.symmetry)
        codomain, domain, backend, _ = cls._init_parse_args(codomain, domain, backend)
        data = backend.eye_data(codomain, domain, dtype)
        res = cls(data, codomain, domain, backend, None)
        if labels is not None:
            labels = list(labels)
            if len(labels) == codomain.num_factors:
                # given labels on the codomain; dual labels on the domain.
                # legs order: [cod_0..cod_{K-1}, dual(cod_{K-1})..dual(cod_0)]
                labels = labels + [_dual_leg_label(l) for l in reversed(labels)]
            res.labels = labels
        return res

    @classmethod
    def from_random_normal(cls, codomain, domain=None, sigma=1., backend=None,
                           labels=None, dtype=Dtype.float64, rng=None):
        codomain, domain, backend, _ = cls._init_parse_args(codomain, domain, backend)
        data = backend.from_random_normal(codomain, domain, dtype, sigma=sigma, rng=rng)
        return cls(data, codomain, domain, backend, labels)

    @classmethod
    def from_random_uniform(cls, codomain, domain=None, backend=None, labels=None,
                            dtype=Dtype.float64, rng=None):
        codomain, domain, backend, _ = cls._init_parse_args(codomain, domain, backend)
        data = backend.from_random_uniform(codomain, domain, dtype, rng=rng)
        return cls(data, codomain, domain, backend, labels)

    @classmethod
    def from_sector_block_func(cls, func, codomain, domain=None, backend=None,
                               labels=None):
        """From ``func(shape, coupled_sector) -> block`` for every allowed block."""
        codomain, domain, backend, _ = cls._init_parse_args(codomain, domain, backend)
        data = backend.from_sector_block_func(func, codomain, domain)
        return cls(data, codomain, domain, backend, labels)

    @classmethod
    def from_block_func(cls, func, codomain, domain=None, backend=None, labels=None,
                        func_kwargs=None, shape_kw: str = None):
        """Generate the free-parameter blocks from a function of the block shape.

        ``func(shape, **func_kwargs)``, or ``func(**{shape_kw: shape}, **func_kwargs)``
        if `shape_kw` is given. Reference: _tensors.py:883.
        """
        kwargs = func_kwargs or {}

        def sector_func(shape, coupled):
            if shape_kw is not None:
                return func(**{shape_kw: shape}, **kwargs)
            return func(shape, **kwargs)

        return cls.from_sector_block_func(sector_func, codomain, domain,
                                          backend=backend, labels=labels)

    @classmethod
    def from_sector_projection(cls, co_domain, sector, backend=None, labels=None,
                               dtype=Dtype.float64):
        """The projector onto a given coupled sector of the domain.

        Reference: _tensors.py:1270.
        """
        co_domain, _, backend, symmetry = cls._init_parse_args(co_domain, co_domain,
                                                               backend)
        sector = np.asarray(sector, dtype=int)
        assert symmetry.is_valid_sector(sector)
        if co_domain.sector_multiplicity(sector) == 0:
            warnings.warn('Sector does not appear. from_sector_projection yields '
                          'zero', stacklevel=2)
        data = backend.sector_projection_data(co_domain, sector, dtype)
        return cls(data, co_domain, co_domain, backend, labels)

    @classmethod
    def from_dense_block_trivial_sector(cls, vector, space, backend=None,
                                        label: str = None) -> SymmetricTensor:
        """Single-leg tensor from the coefficients in the trivial sector.

        Inverse of :meth:`to_dense_block_trivial_sector`. (The reference declares
        this API but leaves it unimplemented, _tensors.py:1019.)
        """
        if backend is None:
            backend = get_backend(space.symmetry)
        bb = backend.block_backend
        vector = bb.as_block(vector)
        i = int(np.nonzero(np.all(
            space.sector_decomposition == space.symmetry.trivial_sector[None, :],
            axis=1))[0][0])
        mult = int(space.multiplicities[i])
        assert bb.get_shape(vector) == (mult,)

        def func(shape, coupled):
            if np.all(coupled == space.symmetry.trivial_sector):
                return bb.reshape(vector, shape)
            return bb.zeros(shape, Dtype.float64)

        return cls.from_sector_block_func(func, [space], [], backend=backend,
                                          labels=[label])

    # --- methods ---------------------------------------------------------------------------

    def diagonal(self, check_offdiagonal: bool = False) -> DiagonalTensor:
        """The diagonal part as a :class:`DiagonalTensor` (reference :1425)."""
        return DiagonalTensor.from_tensor(self, check_offdiagonal=check_offdiagonal)

    def to_dense_block_trivial_sector(self):
        """For a single-leg tensor: the coefficients in the trivial sector.

        Reference: _tensors.py:1465.
        """
        assert self.num_legs == 1
        leg = self.codomain.factors[0] if self.num_codomain_legs == 1 \
            else self.domain.factors[0]
        bb = self.backend.block_backend
        trivial = self.symmetry.trivial_sector
        block = self.backend.get_sector_block(self, trivial) \
            if hasattr(self.backend, 'get_sector_block') else None
        if block is None:
            if hasattr(self.data, 'block'):
                # no-symmetry backend: the dense block IS the trivial sector
                return bb.reshape(self.data.block, (int(leg.dim),))
            # generic path via the data: find the block of the trivial sector
            i = int(np.nonzero(np.all(
                leg.sector_decomposition == trivial[None, :], axis=1))[0][0])
            mult = int(leg.multiplicities[i])
            for b, bi in zip(self.data.blocks, np.atleast_2d(self.data.block_inds)):
                if int(np.atleast_1d(bi)[0]) == i:
                    return bb.reshape(b, (mult,))
            return bb.zeros((mult,), self.dtype)
        return block

    def copy(self, deep=True) -> SymmetricTensor:
        data = self.backend.copy_data(self) if deep else self.data
        res = type(self).__new__(type(self))
        res.__dict__.update(self.__dict__)
        res.data = data
        res._labels = self._labels[:]
        return res

    def to_dense_block(self):
        if not self.symmetry.can_be_dropped:
            raise SymmetryError(f'to_dense_block is meaningless for {self.symmetry}.')
        return self.backend.to_dense_block(self)

    def as_SymmetricTensor(self, warning: str = None) -> SymmetricTensor:
        return self

    def to_dtype(self, dtype: Dtype) -> SymmetricTensor:
        res = self.copy(deep=False)
        res.data = self.backend.to_dtype(self, dtype)
        res.dtype = dtype
        return res

    def _get_item(self, idcs):
        return self.backend.get_element(self, idcs)



class DiagonalTensor(SymmetricTensor):
    r"""A tensor that is diagonal: :math:`\bigoplus_a \lambda_{a,m} \mathrm{id}_a`.

    Codomain and domain are the same single leg. Supports a full elementwise operator
    algebra (binary ops broadcast against scalars, comparisons produce bool diagonals).
    """

    _forbidden_dtypes = []

    def __init__(self, data, leg, backend=None, labels=None):
        self.leg = leg
        if backend is None:
            dtype = data.dtype
        else:
            dtype = backend.get_dtype_from_data(data)
        Tensor.__init__(self, [leg], [leg], backend, labels, dtype)
        self.data = data

    # --- constructors ------------------------------------------------------------------------

    @classmethod
    def from_diag(cls, diag, leg, backend=None, labels=None, tol=1e-6):
        """From the 1D dense diagonal in the public basis of `leg`."""
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)
        block = backend.block_backend.as_block(diag)
        data = backend.diagonal_from_block(block, leg, tol)
        return cls(data, leg, backend, labels)

    # reference API name (cyten DiagonalTensor.from_diag_block)
    from_diag_block = from_diag

    @classmethod
    def from_block_func(cls, func, leg, backend=None, labels=None, func_kwargs=None,
                        shape_kw: str = None):
        """Generate the per-sector diagonal blocks from a function of the block shape.

        Reference: _tensors.py:1593.
        """
        kwargs = func_kwargs or {}

        def sector_func(shape, coupled):
            if shape_kw is not None:
                return func(**{shape_kw: shape}, **kwargs)
            return func(shape, **kwargs)

        return cls.from_sector_block_func(sector_func, leg, backend=backend,
                                          labels=labels)

    @classmethod
    def from_zero(cls, leg, backend=None, labels=None, dtype=Dtype.float64):
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)

        def func(shape, coupled):
            return backend.block_backend.zeros(shape, dtype)

        return cls(backend.diagonal_from_sector_block_func(func, leg), leg, backend,
                   labels)

    @classmethod
    def from_eye(cls, leg, backend=None, labels=None, dtype=Dtype.float64):
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)

        def func(shape, coupled):
            return backend.block_backend.ones(shape, dtype)

        return cls(backend.diagonal_from_sector_block_func(func, leg), leg, backend,
                   labels)

    @classmethod
    def from_random_normal(cls, leg, sigma=1., backend=None, labels=None,
                           dtype=Dtype.float64, rng=None):
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)

        def func(shape, coupled):
            return backend.block_backend.block_random_normal(shape, dtype, sigma,
                                                             rng=rng)

        return cls(backend.diagonal_from_sector_block_func(func, leg), leg, backend,
                   labels)

    @classmethod
    def from_random_uniform(cls, leg, backend=None, labels=None, dtype=Dtype.float64,
                            rng=None):
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)

        def func(shape, coupled):
            return backend.block_backend.block_random_uniform(shape, dtype, rng=rng)

        return cls(backend.diagonal_from_sector_block_func(func, leg), leg, backend,
                   labels)

    @classmethod
    def from_sector_block_func(cls, func, leg, backend=None, labels=None):
        _, _, backend, _ = cls._init_parse_args([leg], [leg], backend)
        return cls(backend.diagonal_from_sector_block_func(func, leg), leg, backend,
                   labels)

    @classmethod
    def from_tensor(cls, tens: SymmetricTensor, check_offdiagonal: bool = True
                    ) -> DiagonalTensor:
        assert tens.num_codomain_legs == 1 == tens.num_domain_legs
        assert tens.codomain.factors[0] == tens.domain.factors[0]
        data = tens.backend.diagonal_data_from_full_tensor(
            tens, check_offdiagonal=check_offdiagonal)
        return cls(data, tens.domain.factors[0], tens.backend, tens.labels)

    # --- conversions ------------------------------------------------------------------------

    def as_SymmetricTensor(self, warning: str = None) -> SymmetricTensor:
        if warning is not None:
            warnings.warn(warning, stacklevel=2)
        data = self.backend.full_data_from_diagonal_tensor(self)
        return SymmetricTensor(data, self.codomain, self.domain, self.backend,
                               self.labels)

    def diag_block(self):
        """The diagonal as a 1D dense block (public basis)."""
        return self.backend.diagonal_to_block(self)

    @property
    def diag_numpy(self) -> np.ndarray:
        return self.backend.block_backend.to_numpy(self.diag_block())

    def diagonal(self) -> DiagonalTensor:
        """API parity with reference cyten/tensors/_tensors.py:2072."""
        return self

    def as_DiagonalTensor(self, dtype=None) -> DiagonalTensor:
        if dtype is None or dtype == self.dtype:
            return self
        return self._elementwise_unary(
            lambda b: self.backend.block_backend.to_dtype(b, dtype),
            maps_zero_to_zero=True)

    def elementwise_almost_equal(self, other: DiagonalTensor, rtol: float = 1e-5,
                                 atol: float = 1e-8) -> DiagonalTensor:
        """Elementwise ``|self - other| <= atol + rtol * |other|`` as a bool diagonal.

        Reference: cyten DiagonalTensor.elementwise_almost_equal.
        """
        return abs(self - other) <= (atol + rtol * abs(other))

    def diagonal_as_block(self, dtype=None):
        """API parity with reference cyten/tensors/_tensors.py:2075."""
        block = self.diag_block()
        if dtype is not None:
            block = self.backend.block_backend.to_dtype(block, dtype)
        return block

    def diagonal_as_numpy(self, numpy_dtype=None) -> np.ndarray:
        """API parity with reference cyten/tensors/_tensors.py:2084."""
        res = self.diag_numpy
        if numpy_dtype is not None:
            res = res.astype(numpy_dtype)
        return res

    def to_dense_block(self):
        return self.as_SymmetricTensor(warning=None).to_dense_block()

    def copy(self, deep=True) -> DiagonalTensor:
        res = super().copy(deep=deep)
        return res

    def _get_item(self, idcs):
        return self.as_SymmetricTensor()._get_item(idcs)

    # --- elementwise machinery ------------------------------------------------------------------

    def _elementwise_unary(self, func, func_kwargs=None, maps_zero_to_zero=False
                           ) -> DiagonalTensor:
        data = self.backend.diagonal_elementwise_unary(
            self, func, func_kwargs or {}, maps_zero_to_zero=maps_zero_to_zero)
        return DiagonalTensor(data, self.leg, self.backend, self.labels)

    def _elementwise_binary(self, other, func, func_kwargs=None,
                            partial_zero_is_zero=False) -> DiagonalTensor:
        assert isinstance(other, DiagonalTensor)
        assert self.leg == other.leg
        data = self.backend.diagonal_elementwise_binary(
            self, other, func, func_kwargs or {},
            partial_zero_is_zero=partial_zero_is_zero)
        return DiagonalTensor(data, self.leg, self.backend, self.labels)

    def _binary_operand(self, other, func, operand: str, right=False,
                        partial_zero_is_zero=False):
        if isinstance(other, Number):
            bb = self.backend.block_backend

            if right:
                def wrapped(block):
                    return func(other, block)
            else:
                def wrapped(block):
                    return func(block, other)

            return self._elementwise_unary(
                lambda b: bb.apply_elementwise(wrapped, b),
                maps_zero_to_zero=False)
        if isinstance(other, DiagonalTensor):
            if right:
                return other._elementwise_binary(
                    self, func, partial_zero_is_zero=partial_zero_is_zero)
            return self._elementwise_binary(
                other, func, partial_zero_is_zero=partial_zero_is_zero)
        if isinstance(other, Tensor):
            raise TypeError(f'Invalid operand {operand} for DiagonalTensor and '
                            f'{type(other).__name__}')
        return NotImplemented

    # operators
    def __abs__(self):
        return self._elementwise_unary(operator.abs, maps_zero_to_zero=True)

    def __add__(self, other):
        if isinstance(other, DiagonalTensor) or isinstance(other, Number):
            return self._binary_operand(other, operator.add, '+')
        return Tensor.__add__(self, other)

    def __radd__(self, other):
        if isinstance(other, Number):
            return self._binary_operand(other, operator.add, '+', right=True)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, DiagonalTensor) or isinstance(other, Number):
            return self._binary_operand(other, operator.sub, '-')
        return Tensor.__sub__(self, other)

    def __rsub__(self, other):
        if isinstance(other, Number):
            return self._binary_operand(other, operator.sub, '-', right=True)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, DiagonalTensor):
            return self._binary_operand(other, operator.mul, '*',
                                        partial_zero_is_zero=True)
        return Tensor.__mul__(self, other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        if isinstance(other, DiagonalTensor):
            return self._binary_operand(other, operator.truediv, '/')
        return Tensor.__truediv__(self, other)

    def __rtruediv__(self, other):
        if isinstance(other, Number):
            return self._binary_operand(other, operator.truediv, '/', right=True)
        return NotImplemented

    def __pow__(self, other):
        if isinstance(other, (Number, DiagonalTensor)):
            return self._binary_operand(other, operator.pow, '**')
        return NotImplemented

    def __lt__(self, other):
        return self._binary_operand(other, operator.lt, '<')

    def __le__(self, other):
        return self._binary_operand(other, operator.le, '<=')

    def __gt__(self, other):
        return self._binary_operand(other, operator.gt, '>')

    def __ge__(self, other):
        return self._binary_operand(other, operator.ge, '>=')

    def __bool__(self):
        if self.dtype == Dtype.bool:
            return self.all()
        raise TypeError('bool() of a non-boolean DiagonalTensor is ambiguous. '
                        'Use .all() or .any().')

    def all(self) -> bool:
        return self.backend.diagonal_all(self)

    def any(self) -> bool:
        return self.backend.diagonal_any(self)

    def _reduce_real(self, np_func):
        """Blockwise reduction to a float; works for every symmetry (no dense
        representation needed). Missing blocks count as implicit zeros.
        Reference: cyten/backends/abelian.py:1776 (reduce_DiagonalTensor)."""
        assert self.dtype.is_real
        bb = self.backend.block_backend
        data = self.data
        block = getattr(data, 'block', None)
        if block is not None:  # no-symmetry storage: one dense block
            return float(np_func(bb.to_numpy(block)))
        vals = [float(np_func(bb.to_numpy(b))) for b in data.blocks]
        if len(data.blocks) < self.leg.num_sectors:
            vals.append(0.)  # missing sectors are implicit zeros
        if not vals:
            return 0.
        return float(np_func(vals))

    def max(self):
        return self._reduce_real(np.max)

    def min(self):
        return self._reduce_real(np.min)

    def sum(self):
        return self.backend.diagonal_sum_all(self)

    def sqrt(self):
        bb = self.backend.block_backend
        return self._elementwise_unary(bb.sqrt, maps_zero_to_zero=True)



class Identity(DiagonalTensor):
    """The identity map on a leg, as a :class:`DiagonalTensor`."""

    def __init__(self, leg, backend=None, labels=None, dtype=Dtype.float64):
        if isinstance(leg, (list, tuple, TensorProduct)):
            raise TypeError('Identity takes a single leg; use '
                            'SymmetricTensor.from_eye for multiple legs.')
        _, _, backend, _ = Tensor._init_parse_args([leg], [leg], backend)

        def func(shape, coupled):
            return backend.block_backend.ones(shape, dtype)

        data = backend.diagonal_from_sector_block_func(func, leg)
        DiagonalTensor.__init__(self, data, leg, backend, labels)


class Mask(Tensor):
    r"""Boolean projection (or inclusion) between a large and a small leg.

    Projection: ``domain == [large_leg]``, ``codomain == [small_leg]``.
    Inclusion (= dagger of a projection): the other way around.
    The small leg keeps the relative basis order of the large leg.
    """

    _forbidden_dtypes = [Dtype.bfloat16, Dtype.float32, Dtype.float64,
                         Dtype.complex64, Dtype.complex128]

    def __init__(self, data, space_in: ElementarySpace, space_out: ElementarySpace,
                 is_projection: bool = None, backend=None, labels=None):
        if is_projection is None:
            if space_in.dim == space_out.dim:
                raise ValueError('Need to specify is_projection for equal dims.')
            is_projection = (space_in.dim > space_out.dim)
        elif is_projection is True:
            assert space_in.dim >= space_out.dim
        else:
            assert space_in.dim <= space_out.dim
        self.is_projection = is_projection
        codomain = [space_out]
        domain = [space_in]
        _, _, backend, _ = self._init_parse_args(codomain, domain, backend)
        Tensor.__init__(self, codomain, domain, backend, labels, Dtype.bool)
        self.data = data

    def test_sanity(self):
        super().test_sanity()
        assert self.small_leg.is_subspace_of(self.large_leg)
        self.backend.test_mask_sanity(self)

    @property
    def large_leg(self) -> ElementarySpace:
        return self.domain.factors[0] if self.is_projection \
            else self.codomain.factors[0]

    @property
    def small_leg(self) -> ElementarySpace:
        return self.codomain.factors[0] if self.is_projection \
            else self.domain.factors[0]

    # --- constructors ----------------------------------------------------------------------

    @classmethod
    def from_blockmask(cls, blockmask, large_leg: ElementarySpace, backend=None,
                       labels=None) -> Mask:
        """Projection mask from a 1D bool array in the public basis of `large_leg`."""
        _, _, backend, _ = cls._init_parse_args([large_leg], [large_leg], backend)
        blockmask = backend.block_backend.as_block(blockmask, Dtype.bool)
        data, small_leg = backend.mask_from_block(blockmask, large_leg)
        return cls(data, space_in=large_leg, space_out=small_leg, is_projection=True,
                   backend=backend, labels=labels)

    @classmethod
    def from_indices(cls, indices, large_leg: ElementarySpace, backend=None,
                     labels=None) -> Mask:
        blockmask = np.zeros(int(large_leg.dim), dtype=bool)
        blockmask[np.asarray(indices)] = True
        return cls.from_blockmask(blockmask, large_leg, backend, labels)

    # reference API name (cyten Mask.from_block_mask)
    from_block_mask = from_blockmask

    @classmethod
    def from_random(cls, large_leg: ElementarySpace, small_leg_dim: int = None,
                    backend=None, labels=None, p_keep: float = 0.5, rng=None) -> Mask:
        """A random projection mask (cf. reference _tensors.py Mask.from_random).

        If `small_leg_dim` is given, keeps exactly that many basis states (whole
        multiplets for dim > 1 sectors where required); else keeps each with
        probability `p_keep`.
        """
        if rng is None:
            rng = np.random.default_rng()
        if not large_leg.symmetry.can_be_dropped:
            # choose per-sector multiplicities to keep
            diag_blocks = [rng.random(int(m)) < p_keep
                           for m in large_leg.multiplicities]
            _, _, backend, _ = cls._init_parse_args([large_leg], [large_leg], backend)
            bb = backend.block_backend
            diag = DiagonalTensor.from_sector_block_func(
                lambda shape, c, _it=iter(diag_blocks): bb.as_block(next(_it),
                                                                    Dtype.bool),
                large_leg, backend=backend)
            return cls.from_DiagonalTensor(diag).set_labels(
                cls._init_parse_labels(labels, TensorProduct([large_leg]),
                                       TensorProduct([large_leg])))
        dim = int(large_leg.dim)
        if small_leg_dim is None:
            blockmask = rng.random(dim) < p_keep
        else:
            keep = rng.choice(dim, size=int(small_leg_dim), replace=False)
            blockmask = np.zeros(dim, dtype=bool)
            blockmask[keep] = True
        # dim>1 sectors need whole multiplets: OR over each multiplet
        if np.any(np.asarray(large_leg.sector_dims) > 1):
            internal = blockmask[large_leg.basis_perm]
            for d, m, slc in zip(large_leg.sector_dims, large_leg.multiplicities,
                                 large_leg.slices):
                seg = internal[slc[0]:slc[1]].reshape(int(d), -1)
                internal[slc[0]:slc[1]] = np.tile(np.any(seg, axis=0), int(d))
            blockmask = internal[large_leg.inverse_basis_perm]
        return cls.from_blockmask(blockmask, large_leg, backend, labels)

    @classmethod
    def from_zero(cls, large_leg: ElementarySpace, backend=None, labels=None) -> Mask:
        """The zero mask: keeps nothing (cf. reference Mask.from_zero)."""
        if large_leg.symmetry.can_be_dropped:
            return cls.from_blockmask(np.zeros(int(large_leg.dim), dtype=bool),
                                      large_leg, backend, labels)
        _, _, backend, _ = cls._init_parse_args([large_leg], [large_leg], backend)
        diag = DiagonalTensor.from_zero(large_leg, backend=backend, dtype=Dtype.bool)
        return cls.from_DiagonalTensor(diag)

    @classmethod
    def from_eye(cls, leg: ElementarySpace, is_projection: bool = True, backend=None,
                 labels=None) -> Mask:
        """The trivial mask that keeps everything."""
        if leg.symmetry.can_be_dropped:
            res = cls.from_blockmask(np.ones(int(leg.dim), dtype=bool), leg, backend,
                                     labels)
        else:
            diag = DiagonalTensor.from_eye(leg, backend=backend, dtype=Dtype.bool)
            res = cls.from_DiagonalTensor(diag)
            res.labels = res._init_parse_labels(labels, res.codomain, res.domain)
        if not is_projection:
            from ._functions import dagger

            res = dagger(res)
            res.labels = res._init_parse_labels(labels, res.codomain, res.domain)
        return res

    @classmethod
    def from_DiagonalTensor(cls, diag: DiagonalTensor) -> Mask:
        """Projection mask keeping entries where `diag` is True (nonzero)."""
        if diag.dtype != Dtype.bool:
            diag = diag._elementwise_unary(
                lambda b: diag.backend.block_backend.as_block(
                    diag.backend.block_backend.to_numpy(b).astype(bool), Dtype.bool),
                maps_zero_to_zero=True)
        data, small_leg = diag.backend.diagonal_to_mask(diag)
        return cls(data, space_in=diag.leg, space_out=small_leg, is_projection=True,
                   backend=diag.backend, labels=diag.labels)

    # --- conversions -------------------------------------------------------------------------

    def as_SymmetricTensor(self, warning: str = None, dtype=Dtype.float64
                           ) -> SymmetricTensor:
        if warning is not None:
            warnings.warn(warning, stacklevel=2)
        data = self.backend.full_data_from_mask(
            self if self.is_projection else _mask_as_projection(self), dtype)
        if self.is_projection:
            return SymmetricTensor(data, self.codomain, self.domain, self.backend,
                                   self.labels)
        # inclusion: dagger of the projection's full tensor
        from ._functions import dagger

        proj = _mask_as_projection(self)
        full = SymmetricTensor(
            self.backend.full_data_from_mask(proj, dtype),
            proj.codomain, proj.domain, self.backend, self.labels[::-1])
        return dagger(full).set_labels(self.labels)

    def as_DiagonalTensor(self, dtype=Dtype.bool) -> DiagonalTensor:
        """Inclusion ∘ projection: bool diagonal on the large leg."""
        data = self.backend.mask_to_diagonal(
            self if self.is_projection else _mask_as_projection(self), self.large_leg)
        res = DiagonalTensor(data, self.large_leg, self.backend,
                             [self.labels[0], self.labels[-1]])
        if dtype != Dtype.bool:
            res = res._elementwise_unary(
                lambda b: self.backend.block_backend.to_dtype(b, dtype),
                maps_zero_to_zero=True)
        return res

    def as_block_mask(self):
        """The mask as a 1D bool block in the public basis of the large leg
        (reference Mask.as_block_mask)."""
        return self.as_DiagonalTensor(dtype=Dtype.bool).diag_block()

    def as_numpy_mask(self) -> np.ndarray:
        return self.backend.block_backend.to_numpy(self.as_block_mask())

    def orthogonal_complement(self) -> Mask:
        """The opposite mask: keeps exactly what self discards (reference :568)."""
        return self.logical_not()

    def to_dense_block(self):
        return self.as_SymmetricTensor().to_dense_block()

    def blockmask(self) -> np.ndarray:
        """The 1D bool mask over the public basis of the large leg."""
        proj = self if self.is_projection else _mask_as_projection(self)
        return self.backend.block_backend.to_numpy(
            self.backend.mask_to_block(proj)).astype(bool)

    def copy(self, deep=True) -> Mask:
        res = type(self).__new__(type(self))
        res.__dict__.update(self.__dict__)
        res._labels = self._labels[:]
        return res

    def _get_item(self, idcs):
        return bool(self.as_SymmetricTensor(dtype=Dtype.float64)._get_item(idcs))

    # --- boolean algebra ------------------------------------------------------------------------

    def _binary(self, other, func) -> Mask:
        assert isinstance(other, Mask)
        assert self.is_projection == other.is_projection
        a = self if self.is_projection else _mask_as_projection(self)
        b = other if other.is_projection else _mask_as_projection(other)
        assert a.large_leg == b.large_leg
        data, small_leg = self.backend.mask_binary_operand(a, b, func)
        res = Mask(data, space_in=a.large_leg, space_out=small_leg,
                   is_projection=True, backend=self.backend, labels=a.labels)
        if not self.is_projection:
            from ._functions import dagger

            res = dagger(res)
        return res

    def __and__(self, other):
        bb = self.backend.block_backend
        return self._binary(other, lambda x, y: bb.xp.logical_and(x, y))

    def __or__(self, other):
        bb = self.backend.block_backend
        return self._binary(other, lambda x, y: bb.xp.logical_or(x, y))

    def __xor__(self, other):
        bb = self.backend.block_backend
        return self._binary(other, lambda x, y: bb.xp.logical_xor(x, y))

    def logical_not(self) -> Mask:
        bb = self.backend.block_backend
        a = self if self.is_projection else _mask_as_projection(self)
        data, small_leg = self.backend.mask_unary_operand(
            a, lambda x: bb.xp.logical_not(x))
        res = Mask(data, space_in=a.large_leg, space_out=small_leg,
                   is_projection=True, backend=self.backend, labels=a.labels)
        if not self.is_projection:
            from ._functions import dagger

            res = dagger(res)
        return res

    __invert__ = logical_not

    def all(self) -> bool:
        return self.small_leg.dim == self.large_leg.dim

    def any(self) -> bool:
        return self.small_leg.dim > 0

    def same_mask(self, other: Mask) -> bool:
        return bool(np.all(self.blockmask() == other.blockmask()))



def _mask_as_projection(mask: Mask) -> Mask:
    """View an inclusion mask as the corresponding projection (transposed data)."""
    assert not mask.is_projection
    data = mask.backend.mask_dagger(mask)
    return Mask(data, space_in=mask.large_leg, space_out=mask.small_leg,
                is_projection=True, backend=mask.backend, labels=mask.labels[::-1])


class ChargedTensor(Tensor):
    r"""A tensor living in a single (non-trivial) sector of the symmetry.

    Composed of an invariant part with one additional (hidden) domain leg — the charge
    leg, labelled ``'!'`` — and optionally a dense ``charged_state`` block fixing a
    state on that leg (required for conversion to dense blocks).
    Cf. reference _tensors.py:3007-3538.
    """

    _CHARGE_LEG_LABEL = '!'

    def __init__(self, invariant_part: SymmetricTensor, charged_state=None):
        assert invariant_part.num_domain_legs >= 1
        # domain[0] is the charge leg; it sits at the *last* legs position
        assert invariant_part.labels[-1] == self._CHARGE_LEG_LABEL, \
            'charge leg must be invariant_part.domain[0] (last legs position)'
        self.invariant_part = invariant_part
        self.charge_leg = invariant_part.domain.factors[0]
        if charged_state is not None:
            charged_state = invariant_part.backend.block_backend.as_block(
                charged_state)
        self.charged_state = charged_state
        codomain = invariant_part.codomain
        domain = TensorProduct(invariant_part.domain.factors[1:],
                               symmetry=invariant_part.symmetry)
        labels = invariant_part.labels[:-1]
        Tensor.__init__(self, codomain, domain, invariant_part.backend, labels,
                        invariant_part.dtype)

    @classmethod
    def from_invariant_part(cls, invariant_part, charged_state=None) -> ChargedTensor:
        return cls(invariant_part, charged_state)

    @classmethod
    def from_two_charge_legs(cls, invariant_part: SymmetricTensor, state1=None,
                             state2=None) -> ChargedTensor:
        """Combine the two charge legs of `invariant_part` into a single one.

        The invariant part must have charge legs (labels starting with ``'!'``) at its
        last two legs positions, i.e. at domain positions 0 and 1; they are combined
        into one pipe. If both `state1` (on domain[0], from tensor 1) and `state2` (on
        domain[1], from tensor 2) are given, the combined ``charged_state`` is their
        product state on the pipe. Reference: cyten/tensors/_tensors.py:3334 — where
        the state product is left unimplemented in all backends; here it works for
        all symmetries with ``can_be_dropped``.
        """
        from ._functions import combine_legs

        bang = cls._CHARGE_LEG_LABEL
        assert invariant_part.labels[-1].startswith(bang)
        assert invariant_part.labels[-2].startswith(bang)
        inv = combine_legs(invariant_part, [-2, -1])
        inv = inv.relabelled({inv.labels[-1]: bang})
        if state1 is None and state2 is None:
            state = None
        elif state1 is None or state2 is None:
            raise ValueError('Must specify either both or none of the states')
        else:
            # public combined basis of the pipe = C-flatten in legs order, i.e. the
            # leg at legs position -2 (domain[1], holding state2) is the major axis
            bb = invariant_part.backend.block_backend
            state = bb.reshape(
                bb.outer(bb.as_block(state2), bb.as_block(state1)), (-1,))
        return cls(inv, state)

    @classmethod
    def from_zero(cls, codomain, domain, charge, charged_state=None, backend=None,
                  labels=None, dtype=Dtype.float64):
        codomain, domain, backend, symmetry = cls._init_parse_args(codomain, domain,
                                                                   backend)
        charge_leg = _as_charge_leg(charge, symmetry)
        inv_domain = TensorProduct([charge_leg, *domain.factors], symmetry=symmetry)
        labels = cls._init_parse_labels(labels, codomain, domain)
        inv_labels = labels + [cls._CHARGE_LEG_LABEL]
        inv = SymmetricTensor.from_zero(codomain, inv_domain, backend, inv_labels,
                                        dtype)
        return cls(inv, charged_state)

    @classmethod
    def from_dense_block(cls, block, codomain, domain=None, charge=None, backend=None,
                         labels=None, tol=1e-6):
        """From a dense block; `charge` is the sector (or charge leg) it lives in."""
        codomain, domain, backend, symmetry = cls._init_parse_args(codomain, domain,
                                                                   backend)
        if not symmetry.can_be_dropped:
            raise SymmetryError('from_dense_block requires can_be_dropped.')
        charge_leg = _as_charge_leg(charge, symmetry)
        block = backend.block_backend.as_block(block)
        d_c = int(charge_leg.dim)
        shape = backend.block_backend.get_shape(block)
        expect_without = tuple(int(sp.dim) for sp in codomain.factors) \
            + tuple(int(sp.dim) for sp in reversed(domain.factors))
        if shape == expect_without:
            assert d_c == 1, 'need explicit charge axis for dim > 1 charge legs'
            block = backend.block_backend.reshape(block, shape + (1,))
        # the charge axis is the last axis of `block`, which is exactly the legs
        # position of domain[0] in the invariant part: legs order is
        # [*codomain, *reversed([charge, *domain])] = [*codomain, *rev(domain), charge]
        inv_domain = TensorProduct([charge_leg, *domain.factors], symmetry=symmetry)
        labels = cls._init_parse_labels(labels, codomain, domain)
        inv = SymmetricTensor.from_dense_block(block, codomain, inv_domain, backend,
                                               labels + [cls._CHARGE_LEG_LABEL],
                                               tol=tol)
        return cls(inv, charged_state=[1.] if d_c == 1 else None)

    @classmethod
    def from_block_func(cls, func, charge, codomain, domain=None, charged_state=None,
                        backend=None, labels=None, func_kwargs=None,
                        shape_kw: str = None):
        """Invariant part from :meth:`SymmetricTensor.from_block_func`.

        Reference: _tensors.py:3175.
        """
        codomain, domain, backend, symmetry = cls._init_parse_args(codomain, domain,
                                                                   backend)
        charge_leg = _as_charge_leg(charge, symmetry)
        inv_domain = TensorProduct([charge_leg, *domain.factors], symmetry=symmetry)
        labels = cls._init_parse_labels(labels, codomain, domain)
        inv = SymmetricTensor.from_block_func(
            func, codomain, inv_domain, backend=backend,
            labels=labels + [cls._CHARGE_LEG_LABEL], func_kwargs=func_kwargs,
            shape_kw=shape_kw)
        return cls(inv, charged_state)

    @classmethod
    def from_dense_block_single_sector(cls, vector, space, sector, backend=None,
                                       label: str = None) -> ChargedTensor:
        """Single-leg charged tensor from the components within one sector.

        Inverse of :meth:`to_dense_block_single_sector`. (The reference declares this
        API but leaves it unimplemented, _tensors.py:3281.)
        """
        if backend is None:
            backend = get_backend(space.symmetry)
        if space.symmetry.sector_dim(sector) > 1:
            raise NotImplementedError(
                'from_dense_block_single_sector: dim > 1 sectors')
        bb = backend.block_backend
        vector = bb.as_block(vector)
        sector = np.asarray(sector, dtype=int)

        def func(shape, coupled):
            if np.all(coupled == sector):
                return bb.reshape(vector, shape)
            return bb.zeros(shape, Dtype.float64)

        charge_leg = _as_charge_leg(sector, space.symmetry)
        inv = SymmetricTensor.from_sector_block_func(
            func, [space], [charge_leg], backend=backend,
            labels=[label, cls._CHARGE_LEG_LABEL])
        return cls(inv, charged_state=[1.])

    def to_dense_block_single_sector(self):
        """For a single-leg, single-sector charged tensor: the components in that
        sector. Reference: _tensors.py:3482."""
        if self.charged_state is None:
            raise ValueError('Unspecified charged_state')
        if self.num_legs > 1:
            raise ValueError('Expected a single leg')
        if self.charge_leg.num_sectors != 1 or int(self.charge_leg.multiplicities[0]) != 1:
            raise ValueError('Not a single sector.')
        if self.symmetry.sector_dim(self.charge_leg.sector_decomposition[0]) > 1:
            raise NotImplementedError(
                'to_dense_block_single_sector: dim > 1 sectors')
        bb = self.backend.block_backend
        inv = self.invariant_part
        if len(inv.data.blocks) == 0:
            leg = inv.codomain.factors[0]
            sector = self.charge_leg.sector_decomposition[0]
            i = int(np.nonzero(np.all(leg.sector_decomposition == sector[None, :],
                                      axis=1))[0][0])
            block = bb.zeros((int(leg.multiplicities[i]),), self.dtype)
        else:
            block = bb.reshape(inv.data.blocks[0], (-1,))
        return bb.block_item(bb.as_block(self.charged_state)) * block

    @classmethod
    def supports_symmetry(cls, symmetry: Symmetry) -> bool:
        """Whether the ChargedTensor concept is well defined for the symmetry.

        Reference: _tensors.py:3385.
        """
        return symmetry.has_symmetric_braid

    def test_sanity(self):
        super().test_sanity()
        self.invariant_part.test_sanity()
        if self.charged_state is not None:
            assert self.backend.block_backend.get_shape(self.charged_state) \
                == (int(self.charge_leg.dim),)
        if not self.symmetry.can_be_dropped:
            assert self.charged_state is None

    def copy(self, deep=True) -> ChargedTensor:
        inv = self.invariant_part.copy(deep=deep)
        state = self.charged_state
        if deep and state is not None:
            state = self.backend.block_backend.copy_block(state)
        return ChargedTensor(inv, state)

    def move_to_device(self, device: str):
        self.invariant_part.move_to_device(device)
        if self.charged_state is not None:
            bb = self.backend.block_backend
            self.charged_state = bb.as_device(bb.as_block(self.charged_state),
                                              device)
        return self

    @property
    def device(self) -> str:
        return self.invariant_part.device

    def to_dense_block(self):
        if self.charged_state is None:
            raise ValueError('charged_state required for to_dense_block')
        inv_block = self.invariant_part.to_dense_block()
        bb = self.backend.block_backend
        # contract the charge axis (last axis in legs order of invariant part)
        state = bb.as_block(self.charged_state, self.dtype)
        return bb.tensordot(inv_block, [self.invariant_part.num_legs - 1], state, [0])

    def as_SymmetricTensor(self, warning: str = None) -> SymmetricTensor:
        if not np.all(self.charge_leg.sector_decomposition
                      == self.symmetry.trivial_sector[None, :]):
            raise SymmetryError('Can not convert ChargedTensor with non-trivial '
                                'charge to SymmetricTensor.')
        from ._functions import squeeze_legs

        if self.charge_leg.dim == 1:
            inv = self.invariant_part
            res = squeeze_legs(inv, inv.num_legs - 1)
            if self.charged_state is not None:
                factor = self.backend.block_backend.block_item(self.charged_state)
                res = factor * res
            return res
        raise NotImplementedError

    def _get_item(self, idcs):
        if self.charged_state is None:
            raise ValueError('charged_state required for item access')
        block = self.to_dense_block()
        return self.backend.block_backend.get_block_element(block, idcs)



def check_same_legs(t1: Tensor, t2: Tensor) -> None:
    """Check that two tensors have the same (co)domain; raise ValueError otherwise.

    If matching labels sit at mismatched positions (leg order likely mixed up by
    accident), the error/warning message says so. Reference: _tensors.py:4017.
    """
    if not t1.symmetry.is_equivalent_to(t2.symmetry):
        raise ValueError('Incompatible symmetries')
    permuted_labels = any(
        l1 is not None and l1 in t2._labels and t2._labels.index(l1) != n1
        for n1, l1 in enumerate(t1._labels))
    if t1.domain != t2.domain or t1.codomain != t2.codomain:
        msg = 'Incompatible legs. '
        if permuted_labels:
            msg += (f'Should you permute_legs first? '
                    f'labels1={t1.labels}  labels2={t2.labels}')
        raise ValueError(msg)
    if permuted_labels:
        warnings.warn('Compatible legs with permuted labels detected. '
                      'Double check your leg order!', stacklevel=3)


def get_same_device(*tensors: Tensor, error_msg: str = 'Incompatible devices.') -> str:
    """If the given tensors live on the same device, return it; raise otherwise.

    Reference: _tensors.py:4772.
    """
    if len(tensors) == 0:
        raise ValueError('Need at least one tensor')
    device = tensors[0].device
    if not all(t.device == device for t in tensors[1:]):
        raise ValueError(error_msg)
    return device


def _as_charge_leg(charge, symmetry: Symmetry) -> ElementarySpace:
    """The hidden charge leg: a ket space with the given sector(s)."""
    if isinstance(charge, ElementarySpace):
        return charge
    charge = np.asarray(charge, dtype=int)
    if charge.ndim == 1:
        charge = charge[None, :]
    return ElementarySpace.from_defining_sectors(symmetry, charge)
