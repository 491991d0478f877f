"""iTDVP and VUMPS in the PyTorch port (``algorithms/itdvp.py``,
``algorithms/vumps.py``), against cyten_tpu and the exact energy density.

The infinite transverse-field Ising chain (parity) at g=1.5 in both packages;
cyten_tpu runs on its numpy block backend. The state is the port's iDMRG ground state
at chi 16, made canonical by the window method, and crosses to cyten_tpu by the
persistence schema. Held: two iTDVP steps in imaginary time and two in real time
(after a quench to g=2.5), the energy density and the read-out ``psi``'s Schmidt values
to 1e-10; the refusal of a cell whose Schmidt values no longer match its tensors (as
cyten_tpu's tests/test_itdvp.py); VUMPS from a loose iDMRG warm start as cyten_tpu's
test_vumps_tfi_gapped, at 7 of its 40 iterations (the energy is within 1e-12 after
them): the exact energy density to 1e-12, the gradient norm below 1e-8, and the first
step's gradient norm against cyten_tpu's to 1e-10.
"""

import numpy as np
import pytest

from cyten_tpu.algorithms import TFIModel as RefTFIModel
from cyten_tpu.algorithms import VUMPSEngine as RefVUMPSEngine
from cyten_tpu.algorithms import iTDVPEngine as RefiTDVPEngine

from cyten_tpu_torch.algorithms import (
    SimpleMPS, TFIModel, VUMPSEngine, iDMRGEngine, iTDVPEngine,
    tfi_exact_infinite_gs_energy,
)
from cyten_tpu_torch.tensors import SymmetricTensor, dagger, norm, tdot
from test_torch_excited import to_ref
# an autouse fixture: one thread for torch and the BLAS
from test_torch_krylov_evolution import one_thread  # noqa: F401

G = 1.5


def models(g=G):
    return (TFIModel(L=2, J=1., g=g, conserve='parity', bc='infinite', device='cpu'),
            RefTFIModel(L=2, J=1., g=g, conserve='parity', bc='infinite',
                        block_backend='numpy'))


def schmidt(S):
    return np.sort(np.abs(np.diag(np.asarray(S.to_numpy()))))[::-1]


def ground_state(n_steps, tol, eps=1e-14, n_cells=20):
    """The port's iDMRG state at chi 16, made canonical by the window method."""
    model, _ = models()
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                       bc='infinite')
    eng = iDMRGEngine(psi, model, chi_max=16, eps=eps)
    eng.run(n_steps=n_steps, tol=tol)
    return eng.psi.canonicalize_infinite(n_cells=n_cells)


@pytest.fixture(scope='module')
def gs():
    return ground_state(150, 1e-13)


@pytest.mark.parametrize('imaginary', [True, False])
def test_two_steps_match_cyten_tpu(gs, imaginary):
    port, ref = models(G if imaginary else 2.5)
    dt = 0.05 if imaginary else 0.02
    engs = (iTDVPEngine(gs.copy(), port, dt=dt, imaginary=imaginary),
            RefiTDVPEngine(to_ref(gs), ref, dt=dt, imaginary=imaginary))
    assert engs[0].lanczos_options == engs[1].lanczos_options
    for _ in range(2):
        for eng in engs:
            eng.step()
    assert engs[0].env_iters == engs[1].env_iters
    assert abs(engs[0].env_energy_cell - engs[1].env_energy_cell) < 1e-10
    assert engs[0].LW.dtype.is_complex == (not imaginary)
    assert abs(engs[0].energy_density() - engs[1].energy_density()) < 1e-10
    out, ref_out = engs[0].psi, engs[1].psi
    assert out.bc == 'infinite'
    for S, ref_S in zip(out.Ss, ref_out.Ss):
        np.testing.assert_allclose(schmidt(S), schmidt(ref_S), rtol=0, atol=1e-10)
    # the read-out cell is canonical B form
    for B in out.Bs:
        E = tdot(B, dagger(B), ['p', 'vR'], ['p*', 'vR*'])
        eye = SymmetricTensor.from_eye([B.get_leg_co_domain('vL')], backend=B.backend,
                                       labels=E.labels, dtype=E.dtype)
        assert float(norm(E + (-1.) * eye)) < 1e-10
    if imaginary:  # the ground state stays (cyten_tpu's test_itdvp_imaginary_time_...)
        assert abs(engs[0].energy_density() - tfi_exact_infinite_gs_energy(1., G)) < 1e-12


def test_rejects_non_canonical(gs):
    """cyten_tpu's test_itdvp_rejects_non_canonical, on the converged cell: squared
    Schmidt values no longer match the cell's tensors at the wrap."""
    model, _ = models()
    bad = gs.copy()
    S2 = bad.Ss[0] * bad.Ss[0]
    bad.Ss[0] = ((1. / float(norm(S2))) * S2).relabelled(['vL', 'vL*'])
    with pytest.raises(ValueError, match='not canonical'):
        iTDVPEngine(bad, model, dt=0.05)


def test_vumps_tfi_gapped():
    """From a loose iDMRG warm start (20 steps to 1e-5 at eps 1e-12, as cyten_tpu's
    _warm_start), VUMPS converges the uniform fixed point to the exact free-fermion
    energy density."""
    model, ref_model = models()
    psi = ground_state(20, 1e-5, eps=1e-12, n_cells=16)
    eng = VUMPSEngine(psi.copy(), model)
    ref = RefVUMPSEngine(to_ref(psi), ref_model)
    assert eng.lanczos_options == ref.lanczos_options
    assert abs(eng.step() - ref.step()) < 1e-10
    assert abs(eng.energy_estimate - ref.energy_estimate) < 1e-10
    e = eng.run(max_iter=6, tol=1e-11)
    assert abs(e - tfi_exact_infinite_gs_energy(1., G)) < 1e-12
    assert eng.grad_norm < 1e-8
    out = eng.psi
    assert abs(model.energy(out) - tfi_exact_infinite_gs_energy(1., G)) < 1e-10
