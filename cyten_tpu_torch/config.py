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
    #: precision of float32 matrix products. The grouped-GEMM kernel
    #: (blocks/grouped_gemm.py) reads it when it plans a list with an f32 result:
    #: 'float32' (and None) exactly, 'tensorfloat32' on the TF32 tensor cores,
    #: 'default' as one bf16 pass, with f32 sums; f64 and bf16 lists ignore it.
    #: Setting it also calls ``torch.set_float32_matmul_precision`` with 'float32'
    #: -> 'highest', 'tensorfloat32' -> 'high' and 'default' -> 'medium' for the
    #: plain torch products of the port (e.g. the MPO channel mixing); None leaves
    #: torch's setting alone. The default is torch's own default, so constructing
    #: the config sets nothing.
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
