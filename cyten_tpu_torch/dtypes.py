"""Backend-independent dtypes.

Role-equivalent to the reference ``cyten/block_backends/dtypes.py`` (reference:
cyten/block_backends/dtypes.py:12-126): a small enum of supported scalar types with
promotion rules, independent of the concrete array library.

The torch block backend maps these dtypes to torch dtypes. numpy has no bfloat16, so
``Dtype.bfloat16.to_numpy`` raises; blocks of that dtype are converted to float32 on
their way to numpy.
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = ['Dtype', 'is_complex_scalar']


def is_complex_scalar(a) -> bool:
    """Is ``a`` a complex scalar with (possibly) non-zero imaginary part?

    ``isinstance(a, complex)`` misses ``np.complex64`` and 0-d torch tensors. For a
    device scalar the imaginary part cannot be read without a sync, so any
    complex-typed scalar counts as complex: a harmless conservative promotion.
    """
    if isinstance(a, complex):
        return a.imag != 0
    dt = getattr(a, 'dtype', None)
    if dt is None:
        return False
    if isinstance(dt, np.dtype):
        return np.issubdtype(dt, np.complexfloating)
    return bool(getattr(dt, 'is_complex', False))


class Dtype(enum.Enum):
    """Scalar data type of tensor entries.

    The enum *value* encodes ``(bytes_per_element, is_complex)`` as
    ``2 * bytes + is_complex`` so that promotion is a cheap max-like operation.
    """

    bool = 2 * 1 + 0
    bfloat16 = 2 * 2 + 0
    float32 = 2 * 4 + 0
    float64 = 2 * 8 + 0
    complex64 = 2 * 8 + 1
    complex128 = 2 * 16 + 1

    @property
    def is_complex(self) -> bool:
        return self.value % 2 == 1

    @property
    def is_real(self) -> bool:
        return self.value % 2 == 0 and self is not Dtype.bool

    @property
    def is_bool(self) -> bool:
        return self is Dtype.bool

    @property
    def itemsize(self) -> int:
        return self.value // 2

    @property
    def to_complex(self) -> Dtype:
        if self is Dtype.bool:
            raise ValueError('bool dtype can not be complexified')
        if self.is_complex:
            return self
        return Dtype(self.value + self.value + 1) if False else _TO_COMPLEX[self]

    @property
    def to_real(self) -> Dtype:
        if self is Dtype.bool:
            raise ValueError('bool has no real counterpart')
        if not self.is_complex:
            return self
        return _TO_REAL[self]

    @property
    def python_type(self):
        if self is Dtype.bool:
            return bool
        return complex if self.is_complex else float

    @property
    def zero_scalar(self):
        return self.python_type(0)

    @property
    def eps(self) -> float:
        """Machine epsilon of the (real part of the) dtype."""
        if self is Dtype.bool:
            raise ValueError('bool has no eps')
        if self is Dtype.bfloat16:
            return 2. ** -7  # 8-bit significand (7 stored bits)
        return float(np.finfo(self.to_numpy).eps)

    @property
    def to_numpy(self) -> np.dtype:
        if self is Dtype.bfloat16:
            raise ValueError('numpy has no bfloat16')
        return _TO_NUMPY[self]

    @classmethod
    def from_numpy(cls, dtype) -> Dtype:
        key = np.dtype(dtype)
        try:
            return _FROM_NUMPY[key]
        except KeyError:
            raise ValueError(f'unsupported numpy dtype: {dtype}') from None

    @classmethod
    def common(cls, *dtypes: Dtype) -> Dtype:
        """The smallest dtype that all given dtypes can be cast to losslessly."""
        if len(dtypes) == 0:
            raise ValueError('need at least one dtype')
        res = dtypes[0]
        for d in dtypes[1:]:
            res = _promote(res, d)
        return res

    def can_hold(self, other: Dtype) -> bool:
        return _promote(self, other) is self

    def convert_scalar(self, value):
        return self.python_type(value)

    def __repr__(self):
        return f'Dtype.{self.name}'


def _promote(a: Dtype, b: Dtype) -> Dtype:
    if a is b:
        return a
    if a is Dtype.bool:
        return b
    if b is Dtype.bool:
        return a
    cplx = a.is_complex or b.is_complex
    # real-part precision in bytes
    ra = a.itemsize // 2 if a.is_complex else a.itemsize
    rb = b.itemsize // 2 if b.is_complex else b.itemsize
    real_bytes = max(ra, rb)
    return _BUILD[(real_bytes, cplx)]


_TO_COMPLEX = {Dtype.bfloat16: Dtype.complex64,
               Dtype.float32: Dtype.complex64, Dtype.float64: Dtype.complex128,
               Dtype.complex64: Dtype.complex64, Dtype.complex128: Dtype.complex128}
_TO_REAL = {Dtype.complex64: Dtype.float32, Dtype.complex128: Dtype.float64}
# no 2-byte complex exists; promotion of bfloat16 with any complex dtype yields
# real_bytes >= 4, so (2, True) is unreachable.
_BUILD = {(2, False): Dtype.bfloat16,
          (4, False): Dtype.float32, (8, False): Dtype.float64,
          (4, True): Dtype.complex64, (8, True): Dtype.complex128}
_TO_NUMPY = {
    Dtype.bool: np.dtype(np.bool_),
    Dtype.float32: np.dtype(np.float32),
    Dtype.float64: np.dtype(np.float64),
    Dtype.complex64: np.dtype(np.complex64),
    Dtype.complex128: np.dtype(np.complex128),
}
_FROM_NUMPY = {v: k for k, v in _TO_NUMPY.items()}
