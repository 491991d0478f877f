"""One-site DMRG with subspace expansion (``algorithms/dmrg1.py``) in the PyTorch port,
against cyten_tpu and exact diagonalization.

The states are made by the port and carried over to cyten_tpu (numpy block backend)
exactly, by the persistence schema. ``_heff1_matvec_impl`` and both expansions are held
to cyten_tpu's on U(1) and SU(2) to 1e-12 of their largest entry; one ``update_site`` in
each direction with each mixer to 1e-10 in E and the Schmidt values (and, for the
density-matrix mixer, whose eigenvectors ``torch.linalg.eigh`` fixes up to a phase, in
the projector ``A A^†``). Whole runs against exact diagonalization as cyten_tpu's
tests/test_dmrg1.py runs them, cut to the sweeps they need: the TFI (five sweeps) and
Sz (three) chains at L=8, the SU(2) chain at L=6 with the expand mixer (three). Then the
ports of ``test_fuser_tensor_unitary`` and ``test_tensor_from_grid_pipe_legs_work``.
"""

import numpy as np
import pytest

from cyten_tpu.algorithms import HeisenbergModel as RefHeisenbergModel
from cyten_tpu.algorithms.dmrg1 import DMRG1SEngine as RefDMRG1SEngine
from cyten_tpu.algorithms.dmrg1 import _expansion_left as ref_expansion_left
from cyten_tpu.algorithms.dmrg1 import _expansion_right as ref_expansion_right
from cyten_tpu.algorithms.dmrg1 import _heff1_matvec_impl as ref_heff1_matvec
from cyten_tpu.tensors import compose as ref_compose, dagger as ref_dagger
from cyten_tpu.tensors import permute_legs as ref_permute_legs
from cyten_tpu.tensors import pinv as ref_pinv, scale_axis as ref_scale_axis

import cyten_tpu_torch as ctt
from cyten_tpu_torch.algorithms import (
    DMRG1SEngine, DMRGEngine, HeisenbergModel, HEffective1, SimpleMPS, TFIModel,
    heisenberg_exact_finite_gs_energy, tfi_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg1 import (
    _expansion_left, _expansion_right, _heff1_matvec_impl,
)
from cyten_tpu_torch.tensors import (
    combine_legs, compose, dagger, fuser_tensor, permute_legs, pinv, scale_axis,
    tensor_from_grid,
)
from test_torch_excited import to_ref


def _close(got, want, tol=1e-12):
    g, w = np.asarray(got.to_numpy()), np.asarray(want.to_numpy())
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))


def _schmidt(S):
    return np.sort(np.abs(np.diag(np.asarray(S.to_numpy()))))[::-1]


def _state(conserve):
    """The Heisenberg chain at L=6 (U(1) or SU(2)) in both packages, on a state one
    two-site sweep from a product state, made by the port and carried over."""
    L = 6
    model = HeisenbergModel(L=L, conserve=conserve, device='cpu')
    ref_model = RefHeisenbergModel(L=L, conserve=conserve, block_backend='numpy')
    if conserve == 'Sz':
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                           backend=model.backend)
    else:
        psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
    DMRGEngine(psi, model, chi_max=4, eps=1e-13).sweep()
    return model, ref_model, psi


@pytest.fixture(scope='module', params=['Sz', 'SU(2)'])
def state(request):
    return _state(request.param)


@pytest.fixture(scope='module')
def sz_state():
    return _state('Sz')


def _engines(state, **kw):
    model, ref_model, psi = state
    return (DMRG1SEngine(psi.copy(), model, chi_max=32, eps=1e-13, alpha=1e-2, **kw),
            RefDMRG1SEngine(to_ref(psi), ref_model, chi_max=32, eps=1e-13, alpha=1e-2,
                            **kw))


def _left_isometry(psi, k, scale_axis, pinv):
    """A_k = S_k B_k S_{k+1}^-1 of a canonical state, by the package's own functions."""
    return scale_axis(scale_axis(psi.Bs[k], psi.Ss[k], 'vL'),
                      pinv(psi.Ss[k + 1], cutoff=1e-14), 'vR')


@pytest.mark.parametrize('i', [0, 3])
def test_heff1_matvec_and_expansions(state, i):
    port, ref = _engines(state)
    for k in range(i):  # the left environments up to site i, on the carried state
        port.update_LP(k, _left_isometry(port.psi, k, scale_axis, pinv))
        ref.update_LP(k, _left_isometry(ref.psi, k, ref_scale_axis, ref_pinv))
    _close(port.LPs[i], ref.LPs[i])
    theta, ref_theta = port.psi.get_theta1(i), ref.psi.get_theta1(i)
    _close(theta, ref_theta)
    W, ref_W = port.model.H_mpo[i], ref.model.H_mpo[i]
    _close(_heff1_matvec_impl(port.LPs[i], port.RPs[i], W, theta),
           ref_heff1_matvec(ref.LPs[i], ref.RPs[i], ref_W, ref_theta))
    Hth = HEffective1(port.LPs[i], port.RPs[i], W, use_jit=True,
                      matmul_precision='float32').matvec(theta)
    _close(Hth, _heff1_matvec_impl(port.LPs[i], port.RPs[i], W, theta), 0.)
    th = permute_legs(theta, codomain=['vL', 'p'], domain=['vR'])
    ref_th = ref_permute_legs(ref_theta, codomain=['vL', 'p'], domain=['vR'])
    P = _expansion_right(port.LPs[i], W, th, 0.3)
    ref_P = ref_expansion_right(ref.LPs[i], ref_W, ref_th, 0.3)
    assert P.labels == ref_P.labels
    _close(P, ref_P)
    th = permute_legs(theta, codomain=['vL'], domain=['vR', 'p'])
    ref_th = ref_permute_legs(ref_theta, codomain=['vL'], domain=['vR', 'p'])
    P = _expansion_left(port.RPs[i], W, th, 0.3)
    ref_P = ref_expansion_left(ref.RPs[i], ref_W, ref_th, 0.3)
    assert P.labels == ref_P.labels
    _close(P, ref_P)


@pytest.mark.parametrize('mixer', ['expand', 'density_matrix'])
@pytest.mark.parametrize('i, move_right', [(2, True), (3, False)])
def test_update_site_against_cyten_tpu(sz_state, mixer, i, move_right):
    port, ref = _engines(sz_state, mixer=mixer)
    for k in range(i):
        port.update_LP(k, _left_isometry(port.psi, k, scale_axis, pinv))
        ref.update_LP(k, _left_isometry(ref.psi, k, ref_scale_axis, ref_pinv))
    port.update_site(i, move_right)
    ref.update_site(i, move_right)
    assert abs(port.E - ref.E) < 1e-10
    bond = i + 1 if move_right else i
    got, want = _schmidt(port.psi.Ss[bond]), _schmidt(ref.psi.Ss[bond])
    n = int((want > 1e-10).sum())
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-10)
    assert np.all(got[n:] < 1e-9)
    assert port.psi.bond_dimensions() == ref.psi.bond_dimensions()
    if mixer == 'density_matrix' and move_right:
        # the new left isometry A = S_i B_i S_{i+1}^-1, by its projector A A^†
        A = _left_isometry(port.psi, i, scale_axis, pinv)
        ref_A = _left_isometry(ref.psi, i, ref_scale_axis, ref_pinv)
        _close(compose(A, dagger(A)), ref_compose(ref_A, ref_dagger(ref_A)), 1e-10)


def test_default_mixer_and_refusals():
    model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
    assert DMRG1SEngine(psi, model).mixer == 'expand'
    with pytest.raises(NotImplementedError, match='mesh'):
        DMRG1SEngine(psi, model, mesh=object())
    with pytest.raises(ValueError, match='mixer'):
        DMRG1SEngine(psi, model, mixer='white')


def test_tfi_expand_mixer_against_exact():
    """cyten_tpu's test_dmrg1s_tfi_expand_mixer, five of its 18 sweeps (alpha 3.2e-6
    after them: the state's energy within 1e-5)."""
    L, g = 8, 1.2
    model = TFIModel(L=L, J=1.0, g=g, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRG1SEngine(psi, model, chi_max=16, eps=1e-14, alpha=1e-2, alpha_decay=0.2,
                       alpha_min=1e-10)
    assert eng.mixer == 'expand'
    E = eng.run(n_sweeps=5, tol=1e-13)
    assert abs(E - tfi_exact_finite_gs_energy(L, 1.0, g)) < 1e-10
    assert psi.max_chi() == 16  # chi grew from the product state
    assert abs(model.energy(psi) - E) < 1e-5


@pytest.mark.parametrize('mixer', ['expand', 'density_matrix'])
def test_heisenberg_sz_against_exact(mixer):
    """cyten_tpu's test_dmrg1s_heisenberg_sz and its density-matrix cross-check, three
    of their 12 sweeps."""
    L = 8
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    eng = DMRG1SEngine(psi, model, chi_max=32, eps=1e-14, alpha=1e-2, mixer=mixer)
    E = eng.run(n_sweeps=3, tol=1e-13)
    assert abs(E - heisenberg_exact_finite_gs_energy(L, 1.0)) < 1e-10


def test_su2_expand_mixer_against_exact():
    """cyten_tpu's test_dmrg1s_expand_mixer_su2, three of its eight sweeps: the CG-aware
    fuser on the fusion-tree backend."""
    L = 6
    m = HeisenbergModel(L=L, conserve='SU(2)', device='cpu')
    psi = SimpleMPS.from_singlet_pairs(m.site_leg, L, backend=m.backend)
    eng = DMRG1SEngine(psi, m, chi_max=24, mixer='expand')
    assert eng.mixer == 'expand'
    E = eng.run(n_sweeps=3)
    assert abs(E - heisenberg_exact_finite_gs_energy(L, 1.)) < 1e-10


@pytest.mark.parametrize('sym_name, sectors, mults', [
    ('su2', [[0], [1]], [2, 1]), ('fibonacci', [[0], [1]], [1, 2])])
def test_fuser_tensor_unitary(sym_name, sectors, mults):
    """fuser_tensor is exactly unitary and reproduces the pipe's sector counts."""
    sym = {'su2': ctt.su2_symmetry, 'fibonacci': ctt.fibonacci_anyon_category}[sym_name]
    be = ctt.get_backend(sym, device='cpu')
    V = ctt.ElementarySpace.from_defining_sectors(sym, sectors, mults)
    W = ctt.ElementarySpace.from_defining_sectors(sym, sectors, [1, 1])
    S = fuser_tensor([V, W], backend=be, labels=['a', 'b', 'f'])
    S.test_sanity()
    fused = S.domain.factors[0]
    tp = ctt.TensorProduct([V, W])
    np.testing.assert_array_equal(fused.sector_decomposition, tp.sector_decomposition)
    np.testing.assert_array_equal(fused.multiplicities, tp.multiplicities)
    # unitarity: S^dag S = id_fused and S S^dag = id_{V (x) W}
    eye_f = ctt.SymmetricTensor.from_eye([fused], backend=be, dtype=S.dtype)
    assert ctt.almost_equal(compose(dagger(S), S), eye_f, rtol=1e-12, atol=1e-12)
    eye_vw = ctt.SymmetricTensor.from_eye([V, W], backend=be, dtype=S.dtype)
    assert ctt.almost_equal(compose(S, dagger(S)), eye_vw, rtol=1e-12, atol=1e-12)


def test_tensor_from_grid_pipe_legs_work():
    """Grids over fusion-tree pipe legs direct-sum natively (the fuser flattens the
    pipe), as the expand mixer needs."""
    be = ctt.get_backend(ctt.su2_symmetry, device='cpu')
    V = ctt.ElementarySpace(ctt.su2_symmetry, [[0], [1]], [2, 1])
    rng = np.random.default_rng(0)
    t = ctt.SymmetricTensor.from_random_normal([V, V], [V, V], backend=be, rng=rng,
                                               labels=list('abcd'))
    tc = combine_legs(t, ['c', 'd'])
    G = tensor_from_grid([[tc, tc]], row_leg=0, col_leg=2)
    G.test_sanity()
    assert abs(float(G.legs[2].dim) - 2 * float(tc.legs[2].dim)) < 1e-10
    g, d = G.to_numpy(), tc.to_numpy()
    assert abs(np.linalg.norm(g) ** 2 - 2 * np.linalg.norm(d) ** 2) < 1e-8
