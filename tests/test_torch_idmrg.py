"""The infinite chain in the PyTorch port: the infinite MPS's canonical forms and
correlation length (``algorithms/mps.py``), ``iDMRGEngine`` and
``MultiCellIDMRGEngine`` (``algorithms/idmrg.py``), against cyten_tpu and exact
thermodynamic-limit energies.

cyten_tpu runs on its numpy block backend; states made by the port cross to it by the
persistence schema, tensors made by it cross to the port by ``tools/interop.py``. Held:
the boundary environments, the H-channel identity, ``_diag_phases`` and
``_fix_qr_phases`` (real and complex) to 1e-12; three iDMRG steps (energy per site,
Schmidt values) to 1e-10; both ``canonicalize_infinite`` methods (Schmidt values, bond
energies) and ``correlation_length`` to 1e-8, the latter also against 1/ln g within
cyten_tpu's tolerance; the first two multi-cell steps to 1e-10. Whole runs as
cyten_tpu's tests/test_idmrg.py: the gapped infinite TFI within 1e-9, and the L=4
multi-cell Heisenberg run within 2e-4 of the Bethe energy, in the 8 of its 20 steps
that reach that (it is 1.9e-4 from it there).
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import HeisenbergModel as RefHeisenbergModel
from cyten_tpu.algorithms import SimpleMPS as RefSimpleMPS
from cyten_tpu.algorithms import TFIModel as RefTFIModel
from cyten_tpu.algorithms.idmrg import MultiCellIDMRGEngine as RefMultiCellIDMRGEngine
from cyten_tpu.algorithms.idmrg import _diag_phases as ref_diag_phases
from cyten_tpu.algorithms.idmrg import _fix_qr_phases as ref_fix_qr_phases
from cyten_tpu.algorithms.idmrg import iDMRGEngine as RefiDMRGEngine
from cyten_tpu.tensors import qr as ref_qr

from cyten_tpu_torch.algorithms import (
    DMRGEngine, HeisenbergModel, MpoTensors, MultiCellIDMRGEngine, SimpleMPS, TFIModel,
    iDMRGEngine, tfi_exact_infinite_gs_energy,
)
from cyten_tpu_torch.algorithms.idmrg import _diag_phases, _fix_qr_phases
from cyten_tpu_torch.tensors import SymmetricTensor, dagger, eye, norm, permute_legs, tdot
from test_torch_excited import to_ref
from test_torch_interop import to_port

G = 1.5


def _close(got, want, tol=1e-12):
    g, w = np.asarray(got.to_numpy()), np.asarray(want.to_numpy())
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))


def _values(S):
    return np.sort(np.abs(np.diag(np.asarray(S.to_numpy()))))[::-1]


def _pair(conserve):
    """An infinite two-site chain in both packages, and its product state."""
    if conserve == 'parity':
        port = TFIModel(L=2, g=G, conserve='parity', bc='infinite', device='cpu')
        ref = RefTFIModel(L=2, g=G, conserve='parity', block_backend='numpy',
                          bc='infinite')
        state = [0, 0]
    else:
        port = HeisenbergModel(L=2, conserve='Sz', bc='infinite', device='cpu')
        ref = RefHeisenbergModel(L=2, conserve='Sz', block_backend='numpy',
                                 bc='infinite')
        state = [0, 1]
    psi = SimpleMPS.from_product_state(port.site_legs, state, backend=port.backend,
                                       bc='infinite')
    ref_psi = RefSimpleMPS.from_product_state(ref.site_legs, state, backend=ref.backend,
                                              bc='infinite')
    return port, ref, psi, ref_psi


@pytest.fixture(scope='module')
def tfi():
    """The gapped infinite TFI at g=1.5, converged by the port's iDMRG at chi 32."""
    model = TFIModel(L=2, g=G, conserve='parity', bc='infinite', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                       bc='infinite')
    eng = iDMRGEngine(psi, model, chi_max=32, eps=1e-12)
    e = eng.run(n_steps=150, tol=1e-12)
    return model, eng, e


def test_idmrg_tfi_against_exact(tfi):
    """cyten_tpu's test_idmrg_tfi_gapped."""
    model, eng, e = tfi
    e_exact = tfi_exact_infinite_gs_energy(1.0, G)
    assert abs(e - e_exact) < 1e-9
    # the converged centre wavefunction is canonical: its bond energy agrees
    assert abs(eng.bond_energy() - e_exact) < 1e-5
    out = eng.psi
    assert out.bc == 'infinite' and out.L == 2
    assert abs(model.energy(out) - e_exact) < 1e-4
    big = out.enlarge_unit_cell(3)
    assert big.L == 6 and big.bc == 'infinite' and big.Bs[4] is not out.Bs[0]
    assert abs(model.energy(out) - sum(
        complex(big.bond_expectation_value(model.H_bonds[k % 2], k)).real
        for k in range(6)) / 6) < 1e-12


@pytest.mark.parametrize('conserve', ['parity', 'Sz'])
def test_three_steps_against_cyten_tpu(conserve):
    model, ref_model, psi, ref_psi = _pair(conserve)
    port = iDMRGEngine(psi, model, chi_max=32, eps=1e-12)
    ref = RefiDMRGEngine(ref_psi, ref_model, chi_max=32, eps=1e-12)
    assert port.lanczos_options == ref.lanczos_options
    for LP, ref_LP in zip((port.LP, port.RP), (ref.LP, ref.RP)):
        assert LP.labels == ref_LP.labels
        _close(LP, ref_LP)
    for step in range(3):
        e, ref_e = port.step(), ref.step()
        assert (e is None) == (ref_e is None) == (step == 0)
        if e is not None:
            assert abs(e - ref_e) < 1e-10
        got, want = _values(port.S), _values(ref.S)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert abs(port.E_window - ref.E_window) < 1e-10
    # the H-channel identity on the grown environment, and the energy subtraction on it
    eye_H = port._eye_at_channel(port.LP)
    ref_eye_H = ref._eye_at_channel(ref.LP)
    assert eye_H.labels == ref_eye_H.labels
    _close(eye_H, ref_eye_H)
    assert port._eye_at_channel(port.LP) is eye_H  # kept for the same legs


@pytest.mark.parametrize('dtype', ['float64', 'complex128'])
def test_qr_phases_against_cyten_tpu(dtype):
    rng = np.random.default_rng(7)
    sym = ct.u1_symmetry
    be = ct.get_backend(sym, 'numpy')
    V = ct.ElementarySpace.from_defining_sectors(sym, [[-1], [0], [1]], [2, 3, 2])
    p = ct.ElementarySpace.from_defining_sectors(sym, [[-1], [1]], [1, 1])
    M = ct.SymmetricTensor.from_random_normal([V, p], [V], backend=be, rng=rng,
                                              labels=['vL', 'p', 'vR'],
                                              dtype=ct.Dtype[dtype])
    Q, R = ref_qr(M, new_labels=['vR', 'vL'])
    D = _diag_phases(to_port(R), ['a', 'a*'])
    ref_D = ref_diag_phases(R, ['a', 'a*'])
    assert D.labels == ref_D.labels and D.dtype.name == dtype
    _close(D, ref_D)
    got = _fix_qr_phases(to_port(Q), to_port(R))
    want = ref_fix_qr_phases(Q, R)
    for g, w in zip(got, want):
        _close(g, w)
    diag = np.diag(np.asarray(got[1].to_numpy()))
    assert np.all(np.abs(diag.imag) < 1e-14) and np.all(diag.real > 0)


def _iso_errors(psi):
    errs = []
    for B in psi.Bs:
        E = tdot(B, dagger(B), ['p', 'vR'], ['p*', 'vR*'])
        ey = eye([B.get_leg_co_domain('vL')], backend=B.backend, labels=['vL', 'vL*'],
                 dtype=B.dtype).as_SymmetricTensor()
        errs.append(float(norm(E + (-1.) * ey)))
    return errs


@pytest.mark.parametrize('method', ['fixed_point', 'window'])
def test_canonicalize_infinite_against_cyten_tpu(tfi, method):
    model, eng, _ = tfi
    kw = {'n_cells': 16} if method == 'window' else {}
    psi = eng.psi
    ref_psi = to_ref(psi)
    psi.canonicalize_infinite(**kw)
    ref_psi.canonicalize_infinite(**kw)
    assert max(_iso_errors(psi)) < 1e-10
    ref_model = RefTFIModel(L=2, g=G, conserve='parity', block_backend='numpy',
                            bc='infinite')
    for i in range(2):
        got, want = _values(psi.Ss[i]), _values(ref_psi.Ss[i])
        n = min(len(got), len(want))
        np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-8)
        e = complex(psi.bond_expectation_value(model.H_bonds[i], i)).real
        ref_e = complex(ref_psi.bond_expectation_value(ref_model.H_bonds[i], i)).real
        assert abs(e - ref_e) < 1e-8
    assert abs(model.energy(psi) - tfi_exact_infinite_gs_energy(1.0, G)) < 1e-9


def test_fixed_point_restores_a_scrambled_gauge(tfi):
    """cyten_tpu's test_canonicalize_infinite_fixed_point: a random invertible gauge
    (singular values clipped to [1/3, 3]) on every bond ruins the B form; the
    fixed-point method restores it with the bond energies unchanged."""
    model, eng, _ = tfi
    psi = eng.psi
    psi.canonicalize_infinite()
    assert max(_iso_errors(psi)) < 1e-12
    rng = np.random.default_rng(42)
    backend, L = model.backend, psi.L
    Gs, Ginvs = [], []
    for i in range(L):
        ey = eye([psi.Bs[i].get_leg_co_domain('vL')], backend=backend,
                 labels=['vL', 'vR'], dtype=psi.Bs[i].dtype).as_SymmetricTensor()
        D = int(ey.codomain.factors[0].dim)
        M = np.eye(D) + 0.3 * rng.standard_normal((D, D))
        Gt = SymmetricTensor.from_dense_block(M, ey.codomain, ey.domain, backend,
                                              ey.labels, tol=None)
        u_, s_, vt_ = np.linalg.svd(Gt.to_numpy())
        M = u_ @ np.diag(np.clip(s_, 1. / 3., 3.)) @ vt_
        Gs.append(SymmetricTensor.from_dense_block(M, ey.codomain, ey.domain, backend,
                                                   ey.labels, tol=None))
        Ginvs.append(SymmetricTensor.from_dense_block(np.linalg.inv(M), ey.codomain,
                                                      ey.domain, backend, ey.labels,
                                                      tol=None))
    Bs = [permute_legs(tdot(tdot(Gs[i], psi.Bs[i], 'vR', 'vL'), Ginvs[(i + 1) % L],
                            'vR', 'vL'), codomain=['vL', 'p'], domain=['vR'])
          for i in range(L)]
    psi_g = SimpleMPS(Bs, list(psi.Ss), bc='infinite')
    assert max(_iso_errors(psi_g)) > 0.1
    psi_g.canonicalize_infinite()
    assert max(_iso_errors(psi_g)) < 1e-12
    for i in range(L):
        e = complex(psi.bond_expectation_value(model.H_bonds[i], i)).real
        e_g = complex(psi_g.bond_expectation_value(model.H_bonds[i], i)).real
        assert abs(e - e_g) < 1e-10
        np.testing.assert_allclose(_values(psi_g.Ss[i]), _values(psi.Ss[i]), atol=1e-6)


def test_correlation_length(tfi):
    """Against cyten_tpu's on the same state, and against xi = 1/ln g (the tolerance of
    cyten_tpu's test_correlation_length at g=1.5)."""
    _, eng, _ = tfi
    psi = eng.psi
    xi = psi.correlation_length()
    assert abs(xi - to_ref(psi).correlation_length()) < 1e-8
    xi_exact = 1. / np.log(G)
    assert abs(xi - xi_exact) / xi_exact < 0.05


def test_multicell_heisenberg_against_bethe():
    """cyten_tpu's test_multicell_idmrg_uniform_heisenberg (the first two steps also
    against its engine, which makes the window engine between given environments)."""
    m4 = HeisenbergModel(L=4, conserve='Sz', bc='infinite', device='cpu')
    psi4 = SimpleMPS.from_product_state(m4.site_legs, [0, 1, 0, 1], backend=m4.backend,
                                        bc='infinite')
    ref_m4 = RefHeisenbergModel(L=4, conserve='Sz', bc='infinite', block_backend='numpy')
    ref = RefMultiCellIDMRGEngine(to_ref(psi4), ref_m4, chi_max=16, eps=1e-12)
    eng = MultiCellIDMRGEngine(psi4, m4, chi_max=16, eps=1e-12)
    for _ in range(2):
        eng.step()
        ref.step()
        assert abs(eng.E_prev - ref.E_prev) < 1e-10
    e = eng.run(n_steps=6, tol=1e-9)
    assert eng.n_steps == 8
    assert abs(e - (0.25 - np.log(2))) < 2e-4
    psi = eng.psi
    assert psi.L == 4 and psi.bc == 'infinite'
    psi.Bs[0].test_sanity()


def test_refusals():
    model = TFIModel(L=2, g=G, conserve='parity', bc='infinite', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                       bc='infinite')
    for engine in (iDMRGEngine, MultiCellIDMRGEngine):
        with pytest.raises(NotImplementedError, match='mesh'):
            engine(psi, model, mesh=object())

    class LongRange:
        bc = 'infinite'
        H_mpo = MpoTensors(model.H_mpo)

    LongRange.H_mpo.max_range = 2
    with pytest.raises(ValueError, match='nearest neighbors'):
        iDMRGEngine(psi, LongRange())
    # a public finite engine refuses an infinite chain
    with pytest.raises(NotImplementedError, match='infinite'):
        DMRGEngine(psi, model)
    heis = HeisenbergModel(L=2, conserve='Sz', bc='infinite', device='cpu')
    with pytest.raises(ValueError, match='trivial charge'):
        SimpleMPS.from_product_state(heis.site_legs, [0, 0], backend=heis.backend,
                                     bc='infinite')
