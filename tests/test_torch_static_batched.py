"""Chi bucketing, the device-form fused Lanczos and the batched static sweep of the
PyTorch port against cyten_tpu.

Inputs are made in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.to_port), or built by both packages from the same arguments.
cyten_tpu runs on the CPU, as its own tests run it; the port runs on the CPU, where
its kernels take their plain versions.
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.models import TFIModel as JaxTFIModel
from cyten_tpu.tensors import truncate_singular_values as jax_truncate
from cyten_tpu.tensors.krylov_based import _close_structure as jax_close_structure
from cyten_tpu.tensors.krylov_based import lanczos_fused as jax_lanczos_fused

from cyten_tpu_torch.algorithms import (
    DMRGEngine, SimpleMPS, TFIModel, tfi_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import HEffective
from cyten_tpu_torch.tensors import inner, truncate_singular_values
from cyten_tpu_torch.tensors.krylov_based import _close_structure, fused_lanczos_impl
from test_torch_interop import to_port


@pytest.mark.parametrize('chi_max, svd_min, pad', [(12, None, 4), (20, 0.3, 4), (9, None, 3),
                                                   (None, 0.5, 8)])
def test_truncate_pad_to_multiple_matches_cyten_tpu(chi_max, svd_min, pad):
    """Random spectra on five U(1) sectors: the same kept values per sector, the same
    error and norm (the unpadded cut's, as cyten_tpu reports them)."""
    leg = ct.ElementarySpace.from_defining_sectors(
        ct.u1_symmetry, np.array([[-2], [-1], [0], [1], [2]]), [3, 7, 10, 6, 2])
    S = ct.DiagonalTensor.from_random_uniform(leg, backend=ct.get_backend(
        ct.u1_symmetry, 'numpy'), labels=['vL', 'vL*'], rng=np.random.default_rng(7))
    mask_ref, err_ref, norm_ref = jax_truncate(S, chi_max=chi_max, svd_min=svd_min,
                                               pad_to_multiple=pad)
    mask, err, new_norm = truncate_singular_values(to_port(S), chi_max=chi_max,
                                                   svd_min=svd_min, pad_to_multiple=pad)
    np.testing.assert_array_equal(mask.small_leg.multiplicities,
                                  mask_ref.small_leg.multiplicities)
    assert all(m % pad == 0 or m == full for m, full in zip(
        mask.small_leg.multiplicities, [3, 7, 10, 6, 2]) if m)
    np.testing.assert_array_equal(mask.as_DiagonalTensor().to_numpy(),
                                  np.asarray(mask_ref.as_DiagonalTensor().to_numpy()))
    assert abs(err - err_ref) < 1e-12 and abs(new_norm - norm_ref) < 1e-12


@pytest.mark.parametrize('L, N, dtype', [(6, 12, 'float64'), (4, 12, 'float64'),
                                         (6, 12, 'float32')],
                         ids=['L6', 'L4-closes', 'L6-float32'])
def test_fused_lanczos_impl_matches_cyten_tpu(L, N, dtype):
    """The centre bond of TFI after one sweep. At L=4 the Krylov space (8 states)
    closes before N, so a beta vanishes and the Gershgorin shift is exercised. E to
    1e-12; theta to 1e-10 up to one global sign, which jnp.linalg.eigh does not
    fix. In float32 (both packages' tensors cast to it, so the port's alphas and
    betas are an f32 buffer) to tests/test_pallas_grouped.py's f32 tolerance: the
    sums run in another order, and cyten_tpu solves its Ritz problem in f32."""
    model = JaxTFIModel(L=L, J=1., g=1.2, conserve='parity', block_backend='jax')
    psi = JaxSimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = JaxDMRGEngine(psi, model, chi_max=16, eps=1e-13)
    eng.sweep()
    i = L // 2 - 1
    dt = ct.Dtype[dtype]
    parts = tuple(t.to_dtype(dt) for t in (eng.LPs[i], eng.RPs[i + 1], model.H_mpo[i],
                                          model.H_mpo[i + 1]))
    H_ref = JaxHEffective(*parts)
    theta0 = jax_close_structure(H_ref, psi.get_theta2(i).to_dtype(dt))
    E_ref, th_ref, _ = jax_lanczos_fused(H_ref, theta0, {'N_max': N})
    H = HEffective(*(to_port(t) for t in parts))
    E, th = fused_lanczos_impl(H, _close_structure(H, to_port(theta0)), N)
    assert E.ndim == 0  # a device scalar: nothing was read on the host
    assert th.dtype.name == dtype
    rtol, atol_E, atol_theta = {'float64': (0., 1e-12, 1e-10),
                                'float32': (2e-5, 2e-4, 2e-4)}[dtype]
    assert abs(float(E) - E_ref) < atol_E + rtol * abs(E_ref)
    ref = to_port(th_ref).to_numpy()
    got = th.to_numpy()
    sign = np.sign(float(inner(to_port(th_ref), th)))
    np.testing.assert_allclose(got, sign * ref, rtol=rtol, atol=atol_theta)


def test_static_batched_half_sweep_matches_cyten_tpu():
    """tests/test_dmrg.py::test_static_batched_half_sweep on both packages: TFI L=12,
    g=1.2, chi_max=8 bucketed to multiples of 4, four sweeps and one static steady
    sweep; then the same runs, two batched sweeps at the exact energy and in step with
    cyten_tpu's, and a per-bond static sweep that agrees."""
    L, g = 12, 1.2
    E_exact = tfi_exact_finite_gs_energy(L, 1., g)
    model_ref = JaxTFIModel(L=L, J=1., g=g, conserve='parity', block_backend='jax')
    psi_ref = JaxSimpleMPS.from_product_state(model_ref.site_legs, [0] * L,
                                              backend=model_ref.backend)
    ref = JaxDMRGEngine(psi_ref, model_ref, chi_max=8, eps=1e-14, pad_chi_multiple=4)
    model = TFIModel(L=L, J=1., g=g, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-14, pad_chi_multiple=4)
    for e in (ref, eng):
        for _ in range(4):
            e.sweep()
        e.enable_static_mode(n_lanczos=20, svd_mode='steady')
        e.sweep()
    runs = eng._static_runs()
    assert runs == ref._static_runs()
    assert any(b1 - b0 >= 3 * p for b0, b1, p in runs), runs  # a real run
    for _ in range(2):
        E_ref = ref.sweep_static_batched()
        E = eng.sweep_static_batched()
        assert abs(E - E_ref) < 1e-9
    assert abs(E - E_exact) < 1e-8
    for i in [*range(L - 1), *range(L - 2, -1, -1)]:
        eng.update_bond(i)  # the per-bond static sweep, E read at every bond
    assert abs(eng.E - E) < 1e-10


def test_graphs_need_the_card_and_static_mode():
    """On the CPU static mode runs eagerly (no graph pool); the batched sweep needs
    static mode, and the bench step's graph needs CUDA and the steady SVD."""
    from cyten_tpu_torch.bench import step_run

    model = TFIModel(L=4, J=1., g=1.2, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * 4, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=4)
    with pytest.raises(RuntimeError):
        eng.sweep_static_batched()
    eng.enable_static_mode(svd_mode='steady')
    assert eng._graph_pool is None and eng.static_graphs() == []
    with pytest.raises(ValueError):
        step_run(8, device='cpu', graph=True)
