"""Two-site DMRG of the PyTorch port against cyten_tpu and exact diagonalization.

Inputs are drawn once in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.export_tensor).
"""

import os

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import HeisenbergModel as JaxHeisenbergModel
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import _heff_matvec_impl as jax_heff_matvec
from cyten_tpu.algorithms.models import heisenberg_exact_finite_gs_energy

from cyten_tpu_torch.algorithms import (
    DMRGEngine, FaultError, HeisenbergModel, SimpleMPS,
)
from cyten_tpu_torch.algorithms.dmrg import HEffective, _heff_matvec_impl
from test_torch_interop import to_port


def build_workload(backend, chi, seed=0):
    """The U(1) bond environment of bench.py:190-218 (build_workload), at small chi."""
    rng = np.random.default_rng(seed)
    charges = np.arange(-4, 5)
    weights = np.exp(-0.4 * charges ** 2)
    mults = np.maximum(1, np.round(chi * weights / weights.sum()).astype(int))
    v_leg = ct.ElementarySpace(ct.u1_symmetry, charges[:, None], mults)
    p_leg = ct.ElementarySpace(ct.u1_symmetry, [[-1], [1]], [1, 1])
    w_leg = ct.ElementarySpace.from_defining_sectors(
        ct.u1_symmetry, np.array([[0], [2], [-2], [0], [0]]), unique_sectors=False)
    LP = ct.SymmetricTensor.from_random_normal(
        [v_leg], [v_leg, w_leg], backend=backend, labels=[['vR*'], ['vR', 'wR']], rng=rng)
    RP = ct.SymmetricTensor.from_random_normal(
        [v_leg, w_leg], [v_leg], backend=backend, labels=['vL', 'wL', 'vL*'], rng=rng)
    W = ct.SymmetricTensor.from_random_normal(
        [w_leg, p_leg], [p_leg, w_leg], backend=backend, labels=['wL', 'p', 'wR', 'p*'],
        rng=rng)
    theta = ct.SymmetricTensor.from_random_normal(
        [v_leg, p_leg, p_leg], [v_leg], backend=backend, labels=['vL', 'p0', 'p1', 'vR'],
        rng=rng)
    W1 = W.relabelled({'p': 'p0', 'p*': 'p0*'})
    W2 = W.relabelled({'p': 'p1', 'p*': 'p1*'})
    return LP, RP, W1, W2, theta


def test_heff_matvec_matches_cyten_tpu():
    args = build_workload(ct.get_backend(ct.u1_symmetry, 'jax'), chi=32)
    ref = jax_heff_matvec(*args)
    got = _heff_matvec_impl(*(to_port(t) for t in args))
    assert got.labels == ref.labels
    # f64, the same block products summed in another order: the tensor-op
    # tolerance of cyten_tpu/testing/asserting.py:14
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-12, atol=1e-12)
    LP, RP, W1, W2, theta = (to_port(t) for t in args)
    H = HEffective(LP, RP, W1.relabelled({'p0': 'p', 'p0*': 'p*'}),
                   W2.relabelled({'p1': 'p', 'p1*': 'p*'}))
    np.testing.assert_allclose(H.matvec(theta).to_numpy(), ref.to_numpy(),
                               rtol=1e-12, atol=1e-12)


def test_heisenberg_dmrg_energy():
    L = 8
    E_exact = heisenberg_exact_finite_gs_energy(L, 1.)
    # cyten_tpu as tests/test_dmrg.py runs it (numpy block backend)
    jm = JaxHeisenbergModel(L=L, conserve='Sz', block_backend='numpy')
    jpsi = JaxSimpleMPS.from_product_state(jm.site_legs, [0, 1] * (L // 2),
                                           backend=jm.backend)
    E_jax = JaxDMRGEngine(jpsi, jm, chi_max=32, eps=1e-13).run(n_sweeps=10)
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=32, eps=1e-13)
    E = eng.run(n_sweeps=10)
    # ground-state energies to 1e-9 (BASELINE.md:17)
    assert abs(E - E_exact) < 1e-9
    assert abs(E - E_jax) < 1e-9
    assert psi.max_chi() == 16


def test_port_model_tensors_match_cyten_tpu():
    jm = JaxHeisenbergModel(L=4, conserve='Sz', block_backend='numpy')
    model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
    for Wj, Wp in zip(jm.H_mpo, model.H_mpo):
        assert Wp.labels == Wj.labels
        np.testing.assert_array_equal(Wp.to_numpy(), Wj.to_numpy())
    np.testing.assert_array_equal(model.H_bonds[0].to_numpy(), jm.H_bonds[0].to_numpy())


def _mpo_to_dense(Ws):
    """The operator of a finite MPO chain, [ket sites..., bra sites...] as a matrix."""
    res = np.ones((1, 1, 1))  # [ket, bra, w]
    for W in Ws:
        w = W.to_numpy()  # [wL, p, wR, p*]
        res = np.einsum('kbx,xpyq->kpbqy', res, w)
        k, p, b, q, y = res.shape
        res = res.reshape(k * p, b * q, y)
    return res[..., 0]


def test_mpo_from_bond_op_matches_cyten_tpu():
    from cyten_tpu.algorithms.models import mpo_from_bond_op as jax_mpo_from_bond_op

    from cyten_tpu_torch.algorithms import mpo_from_bond_op

    L = 3
    jm = JaxHeisenbergModel(L=L, conserve='Sz', block_backend='numpy')
    ref = _mpo_to_dense(jax_mpo_from_bond_op(jm.H_bonds[0], L))
    got = _mpo_to_dense(mpo_from_bond_op(to_port(jm.H_bonds[0]), L))
    # the factors are fixed only up to signs of the bond vectors; the operator is
    # unique: f64 to the tensor-op tolerance
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, _mpo_to_dense(jm.H_mpo), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('conserve', ['Sz', 'None'])
def test_singlet_pairs_and_theta_match_cyten_tpu(conserve):
    jm = JaxHeisenbergModel(L=4, conserve=conserve, block_backend='numpy')
    jpsi = JaxSimpleMPS.from_singlet_pairs(jm.site_leg, 4, backend=jm.backend)
    model = HeisenbergModel(L=4, conserve=conserve, device='cpu')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, 4, backend=model.backend)
    for Bj, Bp in zip(jpsi.Bs, psi.Bs):
        assert Bp.labels == Bj.labels
        np.testing.assert_allclose(Bp.to_numpy(), Bj.to_numpy(), rtol=1e-15, atol=0)
    for i in range(3):  # two-site wavefunctions: f64 products of two blocks
        np.testing.assert_allclose(psi.get_theta2(i).to_numpy(),
                                   jpsi.get_theta2(i).to_numpy(), rtol=1e-12, atol=1e-12)


def test_non_finite_sweep_raises_fault_error():
    model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8)
    RP = eng.RPs[1]
    RP.data.blocks = [b * float('nan') for b in RP.data.blocks]
    with pytest.raises(FaultError):
        eng.run(n_sweeps=2)


# the options still to port: mesh (with shard_axis_name) and an infinite chain
@pytest.mark.parametrize('kwargs', [{'mesh': object()}, {'bc': 'infinite'}])
def test_unported_engine_options_raise(kwargs):
    from cyten_tpu_torch.algorithms import TFIModel

    if kwargs.get('bc') == 'infinite':
        model = TFIModel(L=2, conserve='None', bc='infinite', device='cpu')
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 0], backend=model.backend,
                                           bc='infinite')
        kwargs = {}
    else:
        model = HeisenbergModel(L=2, conserve='Sz', device='cpu')
        psi = SimpleMPS.from_product_state(model.site_legs, [0, 1], backend=model.backend)
    with pytest.raises(NotImplementedError):
        DMRGEngine(psi, model, **kwargs)


# the settings of cyten_tpu's own tests of the two methods: tests/test_dmrg.py
# (test_dmrg_adaptive_svd) and tests/test_randomized_svd.py (test_dmrg_with_randomized_svd)
@pytest.mark.parametrize('method', ['randomized', 'adaptive'])
def test_dynamic_svd_methods_run(method):
    from cyten_tpu_torch.algorithms import TFIModel, tfi_exact_finite_gs_energy

    if method == 'adaptive':
        L, tol = 8, 1e-9
        model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
        state, chi_max, n_sweeps = [0, 1] * (L // 2), 32, 14
        E_exact = heisenberg_exact_finite_gs_energy(L, 1.)
    else:
        L, tol = 10, 1e-7
        model = TFIModel(L=L, J=1., g=1.5, conserve='parity', device='cpu')
        state, chi_max, n_sweeps = [0] * L, 24, 12
        E_exact = tfi_exact_finite_gs_energy(L, 1., 1.5)
    psi = SimpleMPS.from_product_state(model.site_legs, state, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=chi_max, eps=1e-13, dynamic_svd=method)
    assert abs(eng.run(n_sweeps=n_sweeps) - E_exact) < tol


def test_checkpoint_not_ported_raises(tmp_path):
    """run(checkpoint=...) is ported (tests/test_torch_checkpoint.py): what raises now
    is a fault with no checkpoint yet in the directory to roll back to."""
    model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8)
    RP = eng.RPs[1]
    RP.data.blocks = [b * float('nan') for b in RP.data.blocks]
    with pytest.raises(FaultError, match='no checkpoint to roll back to'):
        eng.run(n_sweeps=2, checkpoint=str(tmp_path / 'ckpt'))
    assert os.listdir(tmp_path / 'ckpt') == []
