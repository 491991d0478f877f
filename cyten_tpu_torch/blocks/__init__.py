"""Block backends: dense-array algebra under the symmetric-tensor machinery.

The counterpart of ``cyten_tpu/blocks/``: the :class:`BlockBackend` contract, the torch
implementation, and the grouped-GEMM kernel that carries the block-sparse contractions.
"""

from .backend import Block, BlockBackend, default_device, get_block_backend
from .torch_backend import TorchBlockBackend
from .grouped_gemm import grouped_matmul, grouped_matmul_plain
from ..dtypes import Dtype

__all__ = ['Block', 'BlockBackend', 'Dtype', 'TorchBlockBackend', 'default_device',
           'get_block_backend', 'grouped_matmul', 'grouped_matmul_plain']
