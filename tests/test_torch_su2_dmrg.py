"""SU(2) two-site DMRG of the PyTorch port against cyten_tpu and exact
diagonalization, on the fusion-tree backend.

Inputs are drawn once in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.export_tensor). Tolerances: 1e-12 for tensor operations and the
Lanczos solve at f64, 1e-9 on ground-state energies (``BASELINE.md``, the SU(2)
Heisenberg anchor).
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import HeisenbergModel as JaxHeisenbergModel
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.dmrg import _heff_matvec_impl as jax_heff_matvec
from cyten_tpu.algorithms.models import heisenberg_exact_finite_gs_energy
from cyten_tpu.tensors.krylov_based import fused_lanczos_impl as jax_fused_lanczos

import cyten_tpu_torch.algorithms.dmrg as port_dmrg
from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS
from cyten_tpu_torch.algorithms.dmrg import HEffective, _heff_matvec_impl
from cyten_tpu_torch.tensors.krylov_based import _device_norm, fused_lanczos_impl
from test_torch_interop import to_port


def build_su2_workload(block_backend='numpy', chi_mult=8, seed=0):
    """The SU(2) bond environment of bench.py:383-415 (build_su2_workload) in
    cyten_tpu: ``LP, RP, W1, W2, theta`` with spins j = 0..2 on the virtual leg."""
    backend = ct.get_backend(ct.su2_symmetry, block_backend)
    rng = np.random.default_rng(seed)
    jj = np.arange(5)
    weights = np.exp(-0.5 * (jj / 2.0 - 0.5) ** 2)
    mults = np.maximum(1, np.round(chi_mult * weights / weights.sum()).astype(int))
    v_leg = ct.ElementarySpace(ct.su2_symmetry, jj[:, None], mults)
    W = JaxHeisenbergModel(L=2, conserve='SU(2)', backend=backend,
                           bc='infinite').H_mpo[0]
    p_leg = W.get_leg_co_domain('p')
    w_leg = W.get_leg_co_domain('wL')
    kw = dict(backend=backend, rng=rng)
    LP = ct.SymmetricTensor.from_random_normal([v_leg], [v_leg, w_leg],
                                               labels=[['vR*'], ['vR', 'wR']], **kw)
    RP = ct.SymmetricTensor.from_random_normal([v_leg, w_leg], [v_leg],
                                               labels=[['vL', 'wL'], ['vL*']], **kw)
    theta = ct.SymmetricTensor.from_random_normal([v_leg, p_leg, p_leg], [v_leg],
                                                  labels=['vL', 'p0', 'p1', 'vR'], **kw)
    return (LP, RP, W.relabelled({'p': 'p0', 'p*': 'p0*'}),
            W.relabelled({'p': 'p1', 'p*': 'p1*'}), theta)


def test_port_bench_workload_is_the_reference_one():
    """``cyten_tpu_torch.bench.build_su2_workload`` draws the same tensors."""
    from cyten_tpu_torch.bench import build_su2_workload as port_build

    ref = build_su2_workload()
    got = port_build(to_port(ref[0]).backend, chi_mult=8)
    for g, r in zip(got, ref):
        assert g.labels == r.labels
        np.testing.assert_array_equal(g.to_numpy(), r.to_numpy())


def test_device_norm_weighs_quantum_dimensions():
    """The norm that static mode reads on the device (``_device_norm``) is the
    qdim-weighted norm of cyten_tpu, for a block-sparse and a diagonal tensor; the
    parent's plain Frobenius norm of the blocks differs by far more."""
    theta = build_su2_workload()[4]
    got = float(_device_norm(to_port(theta)))
    assert abs(got - ct.tensors.norm(theta)) < 1e-12 * got
    frobenius = np.sqrt(sum(float(np.sum(b ** 2)) for b in theta.data.blocks))
    assert abs(frobenius - got) > 0.1 * got
    S = ct.tensors.svd(ct.tensors.permute_legs(theta, ['vL', 'p0'], ['vR', 'p1']))[1]
    got = float(_device_norm(to_port(S)))
    assert abs(got - ct.tensors.norm(S)) < 1e-12 * got


def test_heff_matvec_matches_cyten_tpu():
    args = build_su2_workload()
    ref = jax_heff_matvec(*args)
    got = _heff_matvec_impl(*(to_port(t) for t in args))
    assert got.labels == ref.labels
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-12, atol=1e-12)


def test_matvec_takes_the_planar_order(monkeypatch):
    """On the fusion-tree backend the matvec contracts in cyten_tpu's planar order
    (theta first, dmrg.py:262-269), not the lhs-small order of the abelian
    backends, which moves legs past each other."""
    seen = []
    tdot = port_dmrg.tdot

    def recording(a, b, *args, **kwargs):
        seen.append(tuple(a.labels))
        return tdot(a, b, *args, **kwargs)

    monkeypatch.setattr(port_dmrg, 'tdot', recording)
    LP, RP, W1, W2, theta = (to_port(t) for t in build_su2_workload())
    _heff_matvec_impl(LP, RP, W1, W2, theta)
    assert seen[0] == tuple(theta.labels)


def _on_jax(t):
    """``t`` (numpy block backend) with its blocks as jax arrays, on the jax block
    backend, which cyten_tpu's fused Lanczos (a ``lax.scan``) needs."""
    import jax.numpy as jnp
    from cyten_tpu.backends.data import BlockSparseData

    data = BlockSparseData([jnp.asarray(b) for b in t.data.blocks], t.data.block_inds,
                           t.data.dtype, is_sorted=True)
    return ct.SymmetricTensor(data, t.codomain, t.domain,
                              ct.get_backend(ct.su2_symmetry, 'jax'), t.labels)


def test_fused_lanczos_matches_cyten_tpu():
    """``fused_lanczos_impl`` on an SU(2) theta: the Krylov vectors in the qdim
    metric, so E and the Ritz vector (up to its sign) agree with cyten_tpu's to
    1e-12."""
    from cyten_tpu.tensors.krylov_based import _close_structure

    LP, RP, W1, W2, theta = build_su2_workload()
    W1 = W1.relabelled({'p0': 'p', 'p0*': 'p*'})
    W2 = W2.relabelled({'p1': 'p', 'p1*': 'p*'})
    theta = _close_structure(JaxHEffective(LP, RP, W1, W2, use_jit=False), theta)
    H = JaxHEffective(*map(_on_jax, (LP, RP, W1, W2)), use_jit=False)
    E_ref, th_ref = jax_fused_lanczos(H, _on_jax(theta), 8)
    E, th = fused_lanczos_impl(HEffective(*map(to_port, (LP, RP, W1, W2))),
                               to_port(theta), 8)
    assert abs(float(E) - float(E_ref)) < 1e-12 * abs(float(E_ref))
    got, ref = th.to_numpy(), np.asarray(th_ref.to_numpy())
    np.testing.assert_allclose(got * np.sign(np.vdot(got, ref)), ref, rtol=1e-12,
                               atol=1e-12)


def test_heisenberg_L8_matches_exact_and_cyten_tpu():
    L = 8
    model = HeisenbergModel(L, conserve='SU(2)', device='cpu')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
    E = DMRGEngine(psi, model, chi_max=16).run(n_sweeps=6)
    assert abs(E - heisenberg_exact_finite_gs_energy(L, 1.)) < 1e-9
    jmodel = JaxHeisenbergModel(L=L, conserve='SU(2)', block_backend='numpy')
    jpsi = JaxSimpleMPS.from_singlet_pairs(jmodel.site_legs[0], L, backend=jmodel.backend)
    E_ref = JaxDMRGEngine(jpsi, jmodel, chi_max=16).run(n_sweeps=6)
    assert abs(E - E_ref) < 1e-9


def test_static_mode():
    """Static mode on the fusion-tree backend (the counterpart of
    tests/test_dmrg.py::test_static_mode_fusion_tree, L=6): theta assembly, fused
    Lanczos, SVD, frozen-multiplet truncation and environment updates; with the
    steady SVD, then with the exact one (a prefix of multiplets per coupled sector,
    ``_PrefixMask``)."""
    L = 6
    model = HeisenbergModel(L, conserve='SU(2)', device='cpu')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-12)
    for _ in range(4):
        eng.sweep()
    E_exact = heisenberg_exact_finite_gs_energy(L, 1.)
    eng.enable_static_mode(n_lanczos=16, svd_mode='steady')
    for _ in range(2):
        E = eng.sweep_static_batched()
    assert abs(E - E_exact) < 1e-9
    eng.enable_static_mode(n_lanczos=16, svd_mode='exact')
    assert abs(eng.sweep() - E_exact) < 1e-9


def test_static_runs_period_two_match_cyten_tpu():
    """The counterpart of tests/test_dmrg.py::test_static_batched_half_sweep_period2_su2
    (L=20, 8 multiplets, pad 4), eagerly, after two dynamic sweeps: SU(2) spin-1/2
    bonds alternate between integer and half-integer spin, so the repeating
    structures have period 2, and ``_static_runs`` finds the runs cyten_tpu finds."""
    L = 20
    model = HeisenbergModel(L, conserve='SU(2)', device='cpu')
    psi = SimpleMPS.from_singlet_pairs(model.site_leg, L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-14, pad_chi_multiple=4)
    jmodel = JaxHeisenbergModel(L=L, conserve='SU(2)', block_backend='numpy')
    jpsi = JaxSimpleMPS.from_singlet_pairs(jmodel.site_legs[0], L, backend=jmodel.backend)
    jeng = JaxDMRGEngine(jpsi, jmodel, chi_max=8, eps=1e-14, pad_chi_multiple=4)
    for _ in range(2):  # the bulk has saturated: a run of five period-2 cells
        E, E_ref = eng.sweep(), jeng.sweep()
    assert abs(E - E_ref) < 1e-9
    runs = eng._static_runs()
    assert runs == jeng._static_runs()
    assert any(p == 2 and (b1 - b0) // p >= 2 for b0, b1, p in runs), runs


@pytest.mark.parametrize('sym', ['U1', 'SU2'])
def test_steady_svd_keeps_a_kept_sector_theta_lacks(sym):
    """A sector of the frozen allocation in which theta has no block (kept with zero
    weight, as eps=0 keeps it): the steady SVD keeps it, with zero singular values
    and Vh still an isometry, and U S Vh is theta. cyten_tpu's steady SVD drops the
    sector (tensors/steady.py:126), and then B is not right-isometric."""
    from cyten_tpu_torch import ElementarySpace, get_backend, su2_symmetry, u1_symmetry
    from cyten_tpu_torch.tensors import (
        SymmetricTensor, compose, dagger, norm, permute_legs, svd,
    )
    from cyten_tpu_torch.tensors.steady import steady_truncated_svd

    rng = np.random.default_rng(11)
    if sym == 'SU2':
        symmetry, sectors = su2_symmetry, [[0], [1], [2], [3]]
    else:
        symmetry, sectors = u1_symmetry, [[-2], [-1], [0], [1], [2]]
    backend = get_backend(symmetry, device='cpu')
    v = ElementarySpace(symmetry, sectors, rng.integers(2, 4, size=len(sectors)))
    p = ElementarySpace(symmetry, sectors[:2], [1, 1])
    thp = SymmetricTensor.from_random_normal([v, p], [v, p], backend=backend,
                                             labels=['vL', 'p0', 'p1', 'vR'], rng=rng)
    Vh_prev = svd(thp, new_labels=['vR', 'vL'])[2]
    # drop every block of one coupled sector of [vL, p0]
    if sym == 'SU2':
        lost = {int(thp.data.block_inds[1, 0])}
        keep = [n for n, (i, _) in enumerate(thp.data.block_inds) if i not in lost]
    else:
        charge = [int(v.sector_decomposition[a, 0] + p.sector_decomposition[b, 0])
                  for a, b, *_ in thp.data.block_inds]
        keep = [n for n, q in enumerate(charge) if q != charge[len(charge) // 2]]
    assert len(keep) < len(thp.data.blocks)
    thp.data = type(thp.data)([thp.data.blocks[n] for n in keep],
                              thp.data.block_inds[keep], thp.data.dtype, is_sorted=True)
    U, S, Vh, _ = steady_truncated_svd(thp, Vh_prev)
    assert len(S.data.blocks) == S.leg.num_sectors  # every kept sector stays
    eye = SymmetricTensor.from_eye(Vh.codomain.factors, backend=backend)
    assert float(norm(compose(Vh, dagger(Vh)) - eye)) < 1e-10
    back = compose(compose(U, S), Vh)
    assert float(norm(back - thp)) < 1e-10 * float(norm(thp))
