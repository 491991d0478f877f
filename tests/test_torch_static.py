"""Static mode of the PyTorch port against cyten_tpu and exact diagonalization.

The fused Lanczos, the steady truncated SVD, the static bond update and static DMRG
runs. Inputs are made in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.to_port). The cyten_tpu side is jitted, as bench.py and its
engine call it; eager JAX computes the same values and takes several times as long
to compile op by op.
"""

import jax
import numpy as np
import pytest
import torch

import bench as jax_bench
import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.dmrg import _get_static_bond_fn as jax_static_bond_fn
from cyten_tpu.algorithms.models import TFIModel as JaxTFIModel
from cyten_tpu.tensors import permute_legs as jax_permute_legs
from cyten_tpu.tensors.krylov_based import lanczos_fused as jax_lanczos_fused
from cyten_tpu.tensors.steady import steady_truncated_svd as jax_steady_svd

from cyten_tpu_torch.algorithms import (
    DMRGEngine, HeisenbergModel, SimpleMPS, TFIModel, heisenberg_exact_finite_gs_energy,
    tfi_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import (
    HEffective, _freeze_bond, _get_static_bond_fn, _PrefixMask,
)
from cyten_tpu_torch import get_backend, u1_symmetry
from cyten_tpu_torch.backends.data import DiagonalBlockData
from cyten_tpu_torch.bench import build_workload
from cyten_tpu_torch.tensors import (
    DiagonalTensor, SymmetricTensor, compose, dagger, inner, norm, permute_legs, svd,
    svd_apply_mask,
)
from cyten_tpu_torch.tensors.krylov_based import lanczos_fused
from cyten_tpu_torch.tensors.steady import steady_truncated_svd
from test_torch_interop import to_port


def assert_right_isometric(psi, tol):
    """Every B of psi (but the first) is right-isometric: M M^dag == 1 for M = B as
    [vL | p, vR]."""
    for i in range(1, psi.L):
        B = psi.Bs[i]
        M = permute_legs(B, codomain=['vL'], domain=['vR', 'p'])
        eye = SymmetricTensor.from_eye(M.codomain.factors, backend=B.backend,
                                       dtype=B.dtype)
        assert float(norm(compose(M, dagger(M)) - eye)) < tol, i


def test_tfi_model_matches_cyten_tpu():
    model = TFIModel(L=5, g=1.3, device='cpu')
    ref = JaxTFIModel(L=5, g=1.3, block_backend='numpy')
    for W, W_ref in zip(model.H_mpo, ref.H_mpo):
        assert W.labels == W_ref.labels
        np.testing.assert_array_equal(W.to_numpy(), ref.backend.block_backend.to_numpy(
            W_ref.to_dense_block()))
    for h, h_ref in zip(model.H_bonds, ref.H_bonds):
        np.testing.assert_array_equal(h.to_numpy(), ref.backend.block_backend.to_numpy(
            h_ref.to_dense_block()))
    # the infinite chain's model exists (tests/test_torch_bench.py), its finite engine
    # does not: the infinite MPS is not ported
    model = TFIModel(L=4, bc='infinite', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * 4, backend=model.backend)
    with pytest.raises(NotImplementedError):
        DMRGEngine(psi, model)


def test_steady_truncated_svd_matches_cyten_tpu():
    backend = ct.get_backend(ct.u1_symmetry, 'jax')
    LP, RP, W1, W2, theta = jax_bench.build_workload(backend, chi=32)
    v_leg, p_leg = theta.get_leg_co_domain('vL'), theta.get_leg_co_domain('p0')
    B = ct.SymmetricTensor.from_random_normal(
        [v_leg, p_leg], [v_leg], backend=backend, labels=['vL', 'p1', 'vR'],
        rng=np.random.default_rng(1))
    thp = jax_permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    Vh_prev = jax_permute_legs(B, codomain=['vL'], domain=['vR', 'p1'])
    U_ref, S_ref, Vh_ref, err_ref = jax.jit(jax_steady_svd)(thp, Vh_prev)
    U, S, Vh, err = steady_truncated_svd(to_port(thp), to_port(Vh_prev))
    assert U.labels == U_ref.labels and Vh.labels == Vh_ref.labels
    # f64; the warm start fixes the gauge, and both packages take the QRs from
    # LAPACK's Householder QR, so U and Vh agree entry by entry
    for got, ref in ((U, U_ref), (S, S_ref), (Vh, Vh_ref)):
        np.testing.assert_allclose(got.to_numpy(), np.asarray(ref.to_numpy()),
                                   rtol=0, atol=1e-10)
    assert abs(float(err) - float(err_ref)) < 1e-10


def test_steady_svd_drops_numerically_zero_values():
    """A spectrum that falls below sqrt(eps) * s_max (as a converged DMRG state at
    eps=0 has) and a warm start off by 1e-6: U stays an isometry on the values it
    keeps and is zero on the others. cyten_tpu's absolute 1e-30 cutoff amplifies
    the roundoff of those columns instead (ROADMAP.md Queue 3)."""
    backend = get_backend(u1_symmetry, device='cpu')
    LP, RP, W1, W2, theta = build_workload(backend, 24)
    thp = permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    U, S, Vh = svd(thp, new_labels=['vR', 'vL'])
    blocks = [torch.logspace(0, -20, b.shape[0], dtype=b.dtype) for b in S.data.blocks]
    S = DiagonalTensor(DiagonalBlockData(blocks, S.data.block_inds, S.data.dtype),
                       S.leg, backend, S.labels)
    thp = compose(compose(U, S), Vh)
    _, mask = _freeze_bond(HEffective(LP, RP, W1, W2), theta,
                           theta.get_leg_co_domain('vL'))
    _, _, Vh_prev = _PrefixMask(mask).apply(U, S, Vh)
    Vh_prev = Vh_prev + 1e-6 * SymmetricTensor.from_random_normal(
        Vh_prev.codomain, Vh_prev.domain, backend=backend, rng=np.random.default_rng(2))
    U, S, Vh, _ = steady_truncated_svd(thp, Vh_prev)
    G = compose(dagger(U), U).to_numpy()
    kept = np.round(np.diag(G))
    assert set(kept) == {0., 1.}
    np.testing.assert_allclose(G, np.diag(kept), rtol=0, atol=1e-10)
    # exactly the values below sqrt(eps) * s_max are dropped
    s = np.concatenate([b.numpy() for b in S.data.blocks])
    assert int(kept.sum()) == int((s > s.max() * np.finfo(np.float64).eps ** 0.5).sum())


def test_fused_lanczos_matches_cyten_tpu():
    """As tests/test_krylov.py:111 runs it: the centre H_eff of TFI L=8 after one
    sweep."""
    L, g = 8, 1.2
    model = JaxTFIModel(L=L, J=1., g=g, conserve='parity', block_backend='jax')
    psi = JaxSimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = JaxDMRGEngine(psi, model, chi_max=16, eps=1e-13)
    eng.sweep()
    i = L // 2
    parts = (eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i], model.H_mpo[i + 1])
    theta0 = psi.get_theta2(i)
    E_ref, th_ref, _ = jax_lanczos_fused(JaxHEffective(*parts), theta0, {'N_max': 25})
    E, th, N = lanczos_fused(HEffective(*(to_port(t) for t in parts)), to_port(theta0),
                             {'N_max': 25})
    assert N == 25
    assert abs(E - E_ref) < 1e-10  # energies to 1e-10, as tests/test_krylov.py:111
    assert abs(abs(inner(to_port(th_ref), th)) - 1.) < 1e-8


@pytest.mark.parametrize('svd_mode', ['steady', 'exact'])
def test_static_bond_fn_matches_cyten_tpu(svd_mode):
    """One static bond update of bench.py's build_step_state at chi=24."""
    backend = ct.get_backend(ct.u1_symmetry, 'jax')
    LP, RP, W1, W2, S, B1, B2, tmpl, mask = jax_bench.build_step_state(backend, 24)
    impl_ref = jax_static_bond_fn(10, svd_mode)
    ref = jax.jit(lambda H, *args: impl_ref(H, *args, mask))(
        JaxHEffective(LP, RP, W1, W2), S, B1, B2, tmpl)
    LP, RP, W1, W2, S, B1, B2, tmpl = (to_port(t) for t in (LP, RP, W1, W2, S, B1, B2,
                                                            tmpl))
    H = HEffective(LP, RP, W1, W2)
    port_mask = None
    if svd_mode == 'exact':
        _, port_mask = _freeze_bond(H, tmpl, S.leg)
        port_mask = _PrefixMask(port_mask)
    got = _get_static_bond_fn(10, svd_mode)(H, S, B1, B2, tmpl, port_mask)
    # the energies, in f64 after the same ten iterations
    assert abs(got[0] - float(ref[0])) < 1e-9 * abs(float(ref[0]))
    # the exact SVD fixes each singular vector's sign by its own convention, so
    # there only S is compared; the steady SVD's warm start fixes the gauge
    names = ['new_B_i', 'S', 'B', 'LP', 'RP'] if svd_mode == 'steady' else ['S']
    for name in names:
        k = ['new_B_i', 'S', 'B', 'LP', 'RP'].index(name) + 1
        assert got[k].labels == ref[k].labels, name
        np.testing.assert_allclose(got[k].to_numpy(), np.asarray(ref[k].to_numpy()),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_prefix_mask_equals_svd_apply_mask():
    backend = ct.get_backend(ct.u1_symmetry, 'numpy')
    LP, RP, W1, W2, theta = jax_bench.build_workload(backend, chi=12)
    LP, RP, W1, W2, theta = (to_port(t) for t in (LP, RP, W1, W2, theta))
    kept = theta.get_leg_co_domain('vL')
    _, mask = _freeze_bond(HEffective(LP, RP, W1, W2), theta, kept)
    U, S, Vh = svd(permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1']),
                   new_labels=['vR', 'vL'])
    for got, ref in zip(_PrefixMask(mask).apply(U, S, Vh), svd_apply_mask(U, S, Vh, mask)):
        assert got.legs == ref.legs and got.labels == ref.labels
        np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())


@pytest.mark.parametrize('svd_mode', ['steady', 'exact'])
def test_static_mode_heisenberg(svd_mode):
    """tests/test_dmrg.py:406-447: static sweeps after four dynamic ones keep the
    exact energy and the canonical form."""
    L = 6
    E_exact = heisenberg_exact_finite_gs_energy(L, 1.)
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-12)
    for _ in range(4):
        eng.sweep()
    eng.enable_static_mode(n_lanczos=20, svd_mode=svd_mode)
    for _ in range(2):
        E = eng.sweep()
    assert abs(E - E_exact) < 1e-9  # ground-state energies (BASELINE.md:17)
    if svd_mode == 'steady':
        # one Jacobi and one Newton-Schulz pass are second-order corrections at
        # the fixed point: the energy holds
        eng.enable_static_mode(n_lanczos=20, svd_mode='steady',
                               steady_svd_options={'n_jacobi': 1, 'ns_polish': 1})
        E = eng.sweep()
        assert abs(E - E_exact) < 1e-9
    assert_right_isometric(psi, 1e-8)


def test_auto_static_tfi():
    """tests/test_dmrg.py:579-592: auto_static flips the engine into static mode
    once the structures saturate; a static sweep keeps the exact energy."""
    L, g = 10, 1.3
    E_exact = tfi_exact_finite_gs_energy(L, 1., g)
    model = TFIModel(L=L, J=1., g=g, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=12, eps=1e-12, auto_static=True)
    E = eng.run(n_sweeps=8, tol=1e-13)
    assert eng.static_mode is True
    assert abs(E - E_exact) < 1e-9
    assert abs(eng.sweep() - E_exact) < 1e-9
    assert_right_isometric(psi, 1e-8)


def test_dmrg_with_fused_lanczos():
    """tests/test_krylov.py:137: lanczos_options={'fused': True} on the dynamic
    engine reaches the exact energy."""
    L, g = 8, 1.3
    model = TFIModel(L=L, J=1., g=g, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13,
                     lanczos_options={'N_max': 20, 'fused': True})
    E = eng.run(n_sweeps=8, tol=1e-12)
    assert abs(E - tfi_exact_finite_gs_energy(L, 1., g)) < 1e-9


def test_static_mode_rejects_unknown_svd_mode():
    model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1],
                                       backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8)
    with pytest.raises(ValueError):
        eng.enable_static_mode(svd_mode='randomized')
