"""Global configuration for cyten_tpu_torch.

The knobs of ``cyten_tpu.config`` that the ported modules read, under the same names.
"""

from __future__ import annotations

import dataclasses

import torch

#: ``Config.matmul_precision`` -> ``torch.set_float32_matmul_precision``
_TORCH_F32_PRECISION = {'float32': 'highest', 'tensorfloat32': 'high',
                        'default': 'medium'}


@dataclasses.dataclass
class Config:
    # --- semantics / checks ---
    do_fusion_input_checks: bool = True

    # --- backend defaults ---
    default_block_backend: str = 'torch'

    # --- execution policy ---
    #: precision of float32 matrix products done by PyTorch itself. Setting it
    #: calls ``torch.set_float32_matmul_precision`` with 'float32' -> 'highest'
    #: (full f32), 'tensorfloat32' -> 'high' (TF32 tensor cores) and 'default'
    #: -> 'medium' (bf16 passes); None leaves torch's setting alone. The default
    #: is torch's own default, so constructing the config sets nothing. This covers
    #: the plain torch products of the port (e.g. the MPO channel mixing). The
    #: grouped-GEMM kernel (blocks/grouped_gemm.py) computes full f32 whatever
    #: this says: it has no TF32 path yet.
    matmul_precision: str | None = 'float32'
    #: bfloat16 blocks: products accumulate in f32 and are cast back to bf16 once.
    #: The grouped-GEMM kernel always accumulates bf16 in f32.
    bf16_accumulate_f32: bool = True
    #: fuse both MPO applications of the two-site effective-Hamiltonian matvec
    #: into one channel-mixing product per (vR*, vR) sector group
    #: (algorithms.dmrg._apply_bond_mixing). Abelian backends only.
    bond_channel_fusion: bool = True

    def __setattr__(self, name, value):
        if name == 'matmul_precision' and value is not None and name in self.__dict__:
            if value not in _TORCH_F32_PRECISION:
                raise ValueError(f'unknown matmul_precision {value!r}')
            torch.set_float32_matmul_precision(_TORCH_F32_PRECISION[value])
        object.__setattr__(self, name, value)


config = Config()
