"""How far a single-site QR-TDVP step of ``cyten_tpu_torch`` moves when its input moves
by the rounding, on two starting states of the parity TFI chain at L=8 (chi_max 16).

For each ground state (g=1: full rank; g=3: Schmidt values down to the rounding) it
prints the smallest Schmidt value, how far the product A C of one fused right-moving
step at site 3 (the gauge-free part of its output) moves when theta moves by 1e-15
(the largest of three seeded draws), and how far the fused engine's state vector lies
from the eager engine's after three real-time sweeps (|a - b| / |a|). The card test
``tests/test_torch_cuda.py::test_fused_tdvp_site_step_graph_matches_cpu`` and the small
evolution phase of ``chip_smoke.py`` start from the g=1 state for this reason.

Run on the CPU from the repo root: ``PYTHONPATH=. python scripts/torch_tdvp_conditioning.py``
(about a minute).
"""

import numpy as np
import torch

from cyten_tpu_torch import Dtype
from cyten_tpu_torch.algorithms import DMRGEngine, SimpleMPS, TDVPQREngine, TFIModel
from cyten_tpu_torch.algorithms.dmrg import _with_blocks
from cyten_tpu_torch.tensors import permute_legs, tdot

L, SITE = 8, 3


def full_vector(psi) -> np.ndarray:
    s = psi.get_theta1(0)
    for k in range(1, psi.L):
        s = tdot(s, psi.Bs[k].relabelled({'p': f'p{k}'}), 'vR', 'vL')
    return np.asarray(s.to_numpy()).reshape(-1)


def site_step_AC(psi, model, th0):
    """A C of the fused right-moving step at SITE, after the steps before it."""
    eng = TDVPQREngine(psi.copy(), model, dt=0.05, fused=True,
                       lanczos_options={'N_max': 12})
    th = th0
    for k in range(SITE):
        _, C, eng.LPs[k + 1] = eng._fused_step('R', k, th)
        th = permute_legs(tdot(C, psi.Bs[k + 1], 'vR', 'vL'), codomain=['vL', 'p'],
                          domain=['vR'])
    A, C, _ = eng._fused_step('R', SITE, th)
    return np.asarray(tdot(A, C, 'vR', 'vL').to_numpy())


def main():
    rng = np.random.default_rng(0)
    model = TFIModel(L=L, g=1.5, conserve='parity', device='cpu')
    for g0 in (1.0, 3.0):
        model0 = TFIModel(L=L, g=g0, conserve='parity', device='cpu')
        psi = SimpleMPS.from_product_state(model0.site_legs, [0] * L, backend=model0.backend)
        DMRGEngine(psi, model0, chi_max=16, eps=1e-14).run(n_sweeps=3)
        s_min = min(float(np.abs(np.diag(S.to_numpy())).min()) for S in psi.Ss[1:])
        th0 = psi.get_theta1(0)
        ac = site_step_AC(psi, model, th0)
        moved = 0.
        for _ in range(3):
            noise = [1e-15 * torch.from_numpy(rng.standard_normal(tuple(b.shape))).to(b.dtype)
                     for b in th0.data.blocks]
            th1 = _with_blocks(th0, [b + n for b, n in zip(th0.data.blocks, noise)])
            moved = max(moved, float(np.abs(site_step_AC(psi, model, th1) - ac).max()))
        states = {}
        for fused in (False, True):
            p = SimpleMPS([B.to_dtype(Dtype.complex128) for B in psi.Bs], list(psi.Ss))
            eng = TDVPQREngine(p, model, dt=0.05, fused=fused, lanczos_options={'N_max': 12})
            for _ in range(3):
                eng.sweep()
            states[fused] = full_vector(p)
        a, b = states[False], states[True]
        print(f'ground state at g={g0}: chi {psi.max_chi()}, smallest Schmidt value '
              f'{s_min:.3e}; A C at site {SITE} moves by {moved:.3e} when theta moves by '
              f'1e-15; fused against eager QR after 3 sweeps |a - b| / |a| '
              f'{np.linalg.norm(a - b) / np.linalg.norm(a):.3e}', flush=True)


if __name__ == '__main__':
    main()
