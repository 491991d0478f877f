"""TEBD and finite TDVP in the PyTorch port (``algorithms/tebd.py``,
``algorithms/tdvp.py``), against cyten_tpu and exact evolution.

The models are the transverse-field Ising chain (parity) built from the same parameters
in both packages; cyten_tpu runs on its numpy block backend. States made by the port
cross to cyten_tpu by the persistence schema (``to_ref``). Single steps are compared
with cyten_tpu, by what a gauge leaves alone: one TEBD sweep, finite (the full state
vector and the Schmidt values) and infinite (the Schmidt values and the bond energies),
in real and imaginary time, to 1e-12; one sweep of ``TDVPEngine``, ``TDVP2Engine`` and
``TDVPQREngine`` (eager, and ``fused=True`` against cyten_tpu's eager engine) from one
DMRG state, the full state vector to 1e-10. Whole runs
of the port alone against ``scipy.linalg.expm`` at L=6 with the bounds of cyten_tpu's
tests/test_tdvp.py, at fewer steps: 1-TDVP (energy and norm to 1e-10, overlap to 1e-8)
and TDVP2 from a product state (chi grows; overlap and norm to 1e-8);
``refresh_Ss`` against the SVD engine's Schmidt values to 1e-8.
"""

import functools

import numpy as np
import pytest
import scipy.linalg

from cyten_tpu.algorithms import SimpleMPS as RefSimpleMPS
from cyten_tpu.algorithms import TFIModel as RefTFIModel
from cyten_tpu.algorithms.tdvp import TDVP2Engine as RefTDVP2Engine
from cyten_tpu.algorithms.tdvp import TDVPEngine as RefTDVPEngine
from cyten_tpu.algorithms.tdvp import TDVPQREngine as RefTDVPQREngine
from cyten_tpu.algorithms.tebd import TEBDEngine as RefTEBDEngine
from cyten_tpu.tensors import tdot as ref_tdot

from cyten_tpu_torch.algorithms import (
    DMRGEngine, SimpleMPS, TDVP2Engine, TDVPEngine, TDVPQREngine, TEBDEngine, TFIModel,
)
from cyten_tpu_torch.algorithms.tdvp import KEffective
from cyten_tpu_torch.tensors import tdot
from test_torch_excited import to_ref
# an autouse fixture: one thread for torch and the BLAS
from test_torch_krylov_evolution import one_thread  # noqa: F401

L, G = 6, 1.5


def full_state(psi, dot=tdot):
    """The state vector of a finite MPS (site 0 slowest)."""
    s = psi.get_theta1(0)
    for i in range(1, psi.L):
        s = dot(s, psi.Bs[i].relabelled({'p': f'p{i}'}), 'vR', 'vL')
    return np.asarray(s.to_numpy()).reshape(-1)


def dense_tfi(L, g):
    sx = np.array([[0., 1.], [1., 0.]])
    sz = np.diag([1., -1.])

    def op(o, i):
        return functools.reduce(np.kron, [o if k == i else np.eye(2) for k in range(L)])

    return sum(-op(sx, i) @ op(sx, i + 1) for i in range(L - 1)) \
        + sum(-g * op(sz, i) for i in range(L))


def schmidt(S):
    return np.sort(np.abs(np.diag(np.asarray(S.to_numpy()))))[::-1]


def models(g=G, bc='finite', n=L):
    return (TFIModel(L=n, J=1., g=g, conserve='parity', bc=bc, device='cpu'),
            RefTFIModel(L=n, J=1., g=g, conserve='parity', bc=bc, block_backend='numpy'))


@pytest.fixture(scope='module')
def dmrg_state():
    """A DMRG state of the chain at g=3 (chi 8, full rank at L=6), made by the port."""
    model0, _ = models(g=3.0)
    psi = SimpleMPS.from_product_state(model0.site_legs, [0] * L, backend=model0.backend)
    DMRGEngine(psi, model0, chi_max=8, eps=1e-14).run(n_sweeps=2)
    return psi


@pytest.mark.parametrize('imaginary', [False, True])
def test_tebd_sweep_finite_matches_cyten_tpu(imaginary):
    port, ref = models()
    psi = SimpleMPS.from_product_state(port.site_legs, [0] * L, backend=port.backend)
    ref_psi = to_ref(psi)
    for eng in (TEBDEngine(psi, port, dt=0.1, chi_max=8, imaginary=imaginary),
                RefTEBDEngine(ref_psi, ref, dt=0.1, chi_max=8, imaginary=imaginary)):
        eng.run(2)
    got, want = full_state(psi), full_state(ref_psi, ref_tdot)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.iscomplexobj(got) != imaginary
    for S, ref_S in zip(psi.Ss, ref_psi.Ss):
        np.testing.assert_allclose(schmidt(S), schmidt(ref_S), rtol=0, atol=1e-12)


@pytest.mark.parametrize('imaginary', [False, True])
def test_tebd_sweep_infinite_matches_cyten_tpu(imaginary):
    """iTEBD: the wrap-around bond, and (imaginary time) the window canonicalization."""
    port, ref = models(bc='infinite', n=2)
    psi = SimpleMPS.from_product_state(port.site_legs, [0, 0], backend=port.backend,
                                       bc='infinite')
    ref_psi = to_ref(psi)
    engs = (TEBDEngine(psi, port, dt=0.1, chi_max=8, imaginary=imaginary),
            RefTEBDEngine(ref_psi, ref, dt=0.1, chi_max=8, imaginary=imaginary))
    for eng in engs:
        eng.run(2)
    for S, ref_S in zip(psi.Ss, ref_psi.Ss):
        np.testing.assert_allclose(schmidt(S), schmidt(ref_S), rtol=0, atol=1e-12)
    assert abs(engs[0].energy() - engs[1].energy()) < 1e-12
    assert psi.max_chi() == ref_psi.max_chi() > 1


@pytest.fixture(scope='module')
def svd_run(dmrg_state):
    """``dmrg_state`` (its state vector) and one real-time step of TDVPEngine from it
    on the port at dt 0.05 (the engine, its energy before the step)."""
    port, _ = models()
    psi = dmrg_state.copy()
    eng = TDVPEngine(psi, port, dt=0.05, imaginary=False)
    E0 = eng.energy()
    eng.run(1)
    return full_state(dmrg_state), eng, E0


@pytest.fixture(scope='module')
def qr_run(dmrg_state):
    """One real-time step of the eager TDVPQREngine from ``dmrg_state`` on the port at
    dt 0.05 (the engine)."""
    port, _ = models()
    eng = TDVPQREngine(dmrg_state.copy(), port, dt=0.05)
    eng.run(1)
    return eng


@pytest.mark.parametrize('engine', ['TDVP', 'TDVP2', 'QR', 'QR fused'])
def test_tdvp_sweep_matches_cyten_tpu(dmrg_state, svd_run, qr_run, engine):
    """One sweep of each engine from ``dmrg_state`` (the SVD and QR engines' steps are
    the fixtures'). The fused engine (12 fixed Krylov steps, its turning point and last
    site fused too) is held to cyten_tpu's host-driven QR engine, which it approximates
    far below the bound: cyten_tpu's own fused steps, unjitted, take seconds here."""
    port, ref = models()
    ref_psi = to_ref(dmrg_state)
    if engine == 'TDVP':
        engs = (svd_run[1], RefTDVPEngine(ref_psi, ref, dt=0.05))
    elif engine == 'TDVP2':
        engs = (TDVP2Engine(dmrg_state.copy(), port, dt=0.05, chi_max=8),
                RefTDVP2Engine(ref_psi, ref, dt=0.05, chi_max=8))
    elif engine == 'QR':
        engs = (qr_run, RefTDVPQREngine(ref_psi, ref, dt=0.05))
    else:
        engs = (TDVPQREngine(dmrg_state.copy(), port, dt=0.05, fused=True,
                             lanczos_options={'N_max': 12}),
                RefTDVPQREngine(ref_psi, ref, dt=0.05))
    if engine != 'QR fused':
        assert engs[0].lanczos_options == engs[1].lanczos_options
    for eng in engs:
        if eng not in (svd_run[1], qr_run):  # the fixtures have swept once
            eng.sweep()
    psi = engs[0].psi
    got, want = full_state(psi), full_state(ref_psi, ref_tdot)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if engine.startswith('QR'):  # the refreshed Schmidt values
        for S, ref_S in zip(psi.Ss[1:], ref_psi.Ss[1:]):
            np.testing.assert_allclose(schmidt(S), schmidt(ref_S), rtol=0, atol=1e-10)


def test_tdvp_real_time_exact(svd_run):
    """cyten_tpu's test_tdvp_real_time_exact at 1 of its 40 steps: at full bond
    dimension 1-TDVP reproduces the exact unitary evolution and conserves energy and
    norm."""
    arr, eng, E0 = svd_run
    arr = arr / np.linalg.norm(arr)
    assert abs(eng.energy() - E0) < 1e-10
    arr_t = scipy.linalg.expm(-1j * dense_tfi(L, G) * eng.dt) @ arr
    arr_tdvp = full_state(eng.psi)
    assert abs(np.linalg.norm(arr_tdvp) - 1.) < 1e-10
    assert abs(abs(np.vdot(arr_t, arr_tdvp)) - 1.) < 1e-8


def test_tdvp2_grows_chi_from_product_state():
    """cyten_tpu's test_tdvp2_grows_chi_from_product_state (dt 0.02, 50 steps, to full
    rank 8) at dt 0.1 and one step, which grows chi from 1 to 4."""
    port, _ = models()
    psi = SimpleMPS.from_product_state(port.site_legs, [0] * L, backend=port.backend)
    arr0 = full_state(psi)
    dt, n_steps = 0.1, 1
    TDVP2Engine(psi, port, dt=dt, chi_max=8, eps=1e-12).run(n_steps)
    assert psi.max_chi() == 4
    arr_t = scipy.linalg.expm(-1j * dense_tfi(L, G) * dt * n_steps) @ arr0
    arr = full_state(psi)
    assert abs(abs(np.vdot(arr_t, arr)) - 1.) < 1e-8
    assert abs(np.linalg.norm(arr) - 1.) < 1e-8


def test_refresh_ss_matches_svd_engine(svd_run, qr_run):
    """cyten_tpu's test_tdvp_qr_matches_svd_engine at 1 of its 10 steps: the QR engine
    reproduces the SVD engine's state, and its refreshed Schmidt values that engine's;
    ``KEffective`` is hermitian on a bond centre."""
    psi_svd, psi_qr, eng = svd_run[1].psi, qr_run.psi, qr_run
    v1, v2 = full_state(psi_svd), full_state(psi_qr)
    assert abs(abs(np.vdot(v1, v2)) / (np.linalg.norm(v1) * np.linalg.norm(v2)) - 1) < 1e-8
    for i in range(1, L):
        np.testing.assert_allclose(schmidt(psi_svd.Ss[i]), schmidt(psi_qr.Ss[i]),
                                   rtol=0, atol=1e-8)
    K = KEffective(eng.LPs[2], eng.RPs[1])
    C = eng._Cs[2]
    k = np.vdot(C.to_numpy(), K.matvec(C).to_numpy())
    assert abs(k.imag) < 1e-12 * abs(k)
