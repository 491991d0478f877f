"""Backend selection.

The counterpart of ``cyten_tpu/backends/factory.py``: pick the minimal tensor backend for
a symmetry (no_symmetry ⊂ abelian ⊂ fusion_tree) and cache instances per (tensor
backend, block backend, device).
"""

from __future__ import annotations

from ..blocks import get_block_backend
from ..symmetries import Symmetry
from ._backend import TensorBackend

__all__ = ['get_backend']

_instances: dict[tuple[str, str, str], TensorBackend] = {}


def get_backend(symmetry: Symmetry = None, block_backend: str = None,
                symmetry_backend: str = None, device: str = None) -> TensorBackend:
    """Get the (cached) tensor backend appropriate for a symmetry.

    Parameters
    ----------
    symmetry
        Select the minimal symmetry backend that supports it. Defaults to no symmetry.
    block_backend : {'torch'}, optional
        The dense-array backend.
    symmetry_backend : {'no_symmetry', 'abelian', 'fusion_tree'}, optional
        Override the automatic choice (must still support the symmetry).
    device : str, optional
        Where the blocks live. Defaults to the CUDA card; raises without one.
    """
    from .abelian import AbelianBackend
    from .fusion_tree import FusionTreeBackend
    from .no_symmetry import NoSymmetryBackend

    if symmetry_backend is None:
        if symmetry is None:
            symmetry_backend = 'no_symmetry'
        elif symmetry.num_factors == 0 or all(
                type(f).__name__ == 'NoSymmetry' for f in symmetry.factors):
            symmetry_backend = 'no_symmetry'
        elif symmetry.is_abelian and symmetry.has_trivial_braid:
            symmetry_backend = 'abelian'
        else:
            symmetry_backend = 'fusion_tree'
    cls = {'no_symmetry': NoSymmetryBackend, 'abelian': AbelianBackend,
           'fusion_tree': FusionTreeBackend}[symmetry_backend]
    bb = get_block_backend(block_backend, device)
    key = (symmetry_backend, bb.name, str(bb.device))
    res = _instances.get(key)
    if res is None:
        res = _instances[key] = cls(bb)
    if symmetry is not None and not res.supports_symmetry(symmetry):
        raise ValueError(f'{symmetry_backend} backend does not support {symmetry}')
    return res
