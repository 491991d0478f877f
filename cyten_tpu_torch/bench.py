"""The port's bench: the static DMRG bond update of ``bench.py``, timed on the card.

The counterpart of ``bench.py``'s ``build_workload`` (:190), ``build_golden_workload``
(:334), ``build_su2_workload`` (:383), ``su2_run`` (:523, and :func:`golden_run`, its
golden-chain form), ``build_step_state`` (:598), ``step_run`` (:649),
``accuracy_bf16work`` (:1124) and ``su2_step_with_compile`` (:1188, here
:func:`su2_step`), and of ``scripts/exp_r5_step_decomp.py``
(:func:`step_decomposition`). Everything runs on
``device`` (default: the CUDA card). Times are host-clock seconds around work that
ends in ``torch.cuda.synchronize()``, except those of ``step_run(graph=True)``: CUDA
events around graph steps.

    from cyten_tpu_torch.bench import step_run, step_decomposition
    s_per_step, flops_per_step = step_run(4096)
    s_per_step, _ = step_run(4096, precision='default', env_dtype='bfloat16')
    print(step_decomposition())
    s_per_matvec = su2_run(512)
    s_per_matvec = golden_run(512)
    capture_s, s_per_step = su2_step(512, graph=True)

Not ported: the int8-environment GEMM probe of the script (:67-113).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .algorithms import DMRGEngine, GoldenChainModel, HeisenbergModel, SimpleMPS
from .algorithms.models import mpo_from_bond_op
from .algorithms.dmrg import (
    HEffective, _GraphedStep, _PrefixMask, _freeze_bond, _get_static_bond_fn,
    _heff_matvec_impl,
)
from .backends import get_backend
from .backends.data import BlockSparseData
from .blocks.grouped_gemm import grouped_matmul
from .blocks.probe import scale2, scale2_plain
from .config import config
from .dtypes import Dtype
from .symmetries import (
    ElementarySpace, fibonacci_anyon_category, su2_symmetry, u1_symmetry,
)
from .tensors import DiagonalTensor, SymmetricTensor, scalar_multiply, tdot
from .tensors.krylov_based import _device_norm
from .tools.flops import tdot_flops

__all__ = ['build_workload', 'build_golden_workload', 'build_su2_workload',
           'build_step_state', 'step_flops', 'step_run', 'step_decomposition',
           'accuracy_bf16work', 'su2_run', 'su2_step', 'golden_run', 'HEIS24_E_REF',
           'GOLDEN28_E_REF']

#: f64 DMRG energy of the L=24 U(1) Heisenberg open chain at chi=512, the reference
#: of the accuracy protocol (``bench.py:1121``, ``HEIS24_E_REF``)
HEIS24_E_REF = -10.45378576040958

#: f64 DMRG energy of the L=28 Fibonacci golden chain (J=1, open) at chi_max=512
#: multiplets, eps=0, N_max=10: ``cyten_tpu`` on the CPU with its numpy block
#: backend, the tenth sweep from ``SimpleMPS.from_fusion_pairs`` (the centre bond
#: holds 512 multiplets from the seventh; sweeps 4-10 within 9e-14 of each other).
#: Re-taken by ``PYTHONPATH=. python tests/test_torch_golden_chain.py --golden28-ref``.
GOLDEN28_E_REF = -20.81543265454313


def build_workload(backend, chi: int, dtype=Dtype.float64, seed: int = 0):
    """The U(1) DMRG bond environment of bench.py:190-218 (build_workload):
    ``LP, RP, W1, W2, theta`` with nine charge sectors of total multiplicity ~chi."""
    rng = np.random.default_rng(seed)
    charges = np.arange(-4, 5)
    weights = np.exp(-0.4 * charges ** 2)
    mults = np.maximum(1, np.round(chi * weights / weights.sum()).astype(int))
    v_leg = ElementarySpace(u1_symmetry, charges[:, None], mults)
    p_leg = ElementarySpace(u1_symmetry, [[-1], [1]], [1, 1])
    w_leg = ElementarySpace.from_defining_sectors(
        u1_symmetry, np.array([[0], [2], [-2], [0], [0]]), unique_sectors=False)
    kw = dict(backend=backend, rng=rng, dtype=dtype)
    LP = SymmetricTensor.from_random_normal([v_leg], [v_leg, w_leg],
                                            labels=[['vR*'], ['vR', 'wR']], **kw)
    RP = SymmetricTensor.from_random_normal([v_leg, w_leg], [v_leg],
                                            labels=['vL', 'wL', 'vL*'], **kw)
    W = SymmetricTensor.from_random_normal([w_leg, p_leg], [p_leg, w_leg],
                                           labels=['wL', 'p', 'wR', 'p*'], **kw)
    theta = SymmetricTensor.from_random_normal([v_leg, p_leg, p_leg], [v_leg],
                                               labels=['vL', 'p0', 'p1', 'vR'], **kw)
    W1 = W.relabelled({'p': 'p0', 'p*': 'p0*'})
    W2 = W.relabelled({'p': 'p1', 'p*': 'p1*'})
    return LP, RP, W1, W2, theta


def build_golden_workload(backend, chi_mult: int = 512, dtype=Dtype.float64,
                          seed: int = 0):
    """The Fibonacci golden-chain DMRG bond environment of bench.py:334-380
    (build_golden_workload): ``LP, RP, W1, W2, theta`` on the fusion-tree ``backend``,
    the virtual leg holding both sectors (1 and tau) with multiplicities split by
    quantum dimension (1 : phi), ``chi_mult`` multiplets in all.

    W is the bulk golden-chain MPO tensor, built on the CPU as bench.py builds it on
    the host, so the workload is the same on every device, and cast to its real part,
    as there: the factorisation is complex128 with imaginary parts of about 1e-16,
    the operator real."""
    rng = np.random.default_rng(seed)
    cpu = get_backend(fibonacci_anyon_category, device='cpu')
    model = GoldenChainModel(L=2, backend=cpu)
    W = mpo_from_bond_op(model.H_bonds[0], 2, bc='infinite')[0]  # bulk tensor
    if W.dtype.is_complex:
        W = W.to_dtype(W.dtype.to_real)
    if dtype != W.dtype:
        W = W.to_dtype(dtype)
    if backend is not cpu:
        bb = backend.block_backend
        W = W.copy(deep=False)
        W.backend = backend
        W.data = BlockSparseData([bb.as_block(b, W.dtype) for b in W.data.blocks],
                                 W.data.block_inds, W.dtype, is_sorted=True)
    fib = W.symmetry
    phi = (1 + 5 ** 0.5) / 2
    m_tau = max(1, int(round(chi_mult * phi / (1 + phi))))
    v_leg = ElementarySpace(fib, [[0], [1]], [chi_mult - m_tau, m_tau])
    p_leg = W.get_leg_co_domain('p')
    w_leg = W.get_leg_co_domain('wL')
    kw = dict(backend=backend, rng=rng, dtype=W.dtype)
    LP = SymmetricTensor.from_random_normal([v_leg], [v_leg, w_leg],
                                            labels=[['vR*'], ['vR', 'wR']], **kw)
    RP = SymmetricTensor.from_random_normal([v_leg, w_leg], [v_leg],
                                            labels=[['vL', 'wL'], ['vL*']], **kw)
    theta = SymmetricTensor.from_random_normal([v_leg, p_leg, p_leg], [v_leg],
                                               labels=['vL', 'p0', 'p1', 'vR'], **kw)
    W1 = W.relabelled({'p': 'p0', 'p*': 'p0*'})
    W2 = W.relabelled({'p': 'p1', 'p*': 'p1*'})
    return LP, RP, W1, W2, theta


def build_su2_workload(backend, chi_mult: int = 512, dtype=Dtype.float64, seed: int = 0):
    """The SU(2) DMRG bond environment of bench.py:383-415 (build_su2_workload):
    ``LP, RP, W1, W2, theta`` on the fusion-tree ``backend``, with spins j = 0..2 on
    the virtual leg. ``chi_mult`` counts multiplets; the state dimension is
    sum (2j+1) * mult. W is the bulk SU(2) Heisenberg MPO tensor."""
    rng = np.random.default_rng(seed)
    jj = np.arange(5)  # 2*j = 0..4
    weights = np.exp(-0.5 * (jj / 2.0 - 0.5) ** 2)
    mults = np.maximum(1, np.round(chi_mult * weights / weights.sum()).astype(int))
    v_leg = ElementarySpace(su2_symmetry, jj[:, None], mults)
    W = HeisenbergModel(L=2, conserve='SU(2)', backend=backend, bc='infinite').H_mpo[0]
    if dtype != W.dtype:
        W = W.to_dtype(dtype)
    p_leg = W.get_leg_co_domain('p')
    w_leg = W.get_leg_co_domain('wL')
    kw = dict(backend=backend, rng=rng, dtype=dtype)
    LP = SymmetricTensor.from_random_normal([v_leg], [v_leg, w_leg],
                                            labels=[['vR*'], ['vR', 'wR']], **kw)
    RP = SymmetricTensor.from_random_normal([v_leg, w_leg], [v_leg],
                                            labels=[['vL', 'wL'], ['vL*']], **kw)
    theta = SymmetricTensor.from_random_normal([v_leg, p_leg, p_leg], [v_leg],
                                               labels=['vL', 'p0', 'p1', 'vR'], **kw)
    W1 = W.relabelled({'p': 'p0', 'p*': 'p0*'})
    W2 = W.relabelled({'p': 'p1', 'p*': 'p1*'})
    return LP, RP, W1, W2, theta


def build_step_state(backend, chi: int, seed: int = 0, dtype=Dtype.float64,
                     workload=None):
    """The static-mode step state of bench.py:598-646 (build_step_state):
    ``LP, RP, W1, W2, S, B1, B2, theta_tmpl, mask``. ``mask`` keeps the full
    multiplicities of the bond leg, so a step returns the state to its own structure.
    ``workload`` picks the environment: :func:`build_workload` (the default, U(1)) or
    :func:`build_su2_workload`, where ``chi`` counts multiplets and the mask keeps
    whole multiplets per sector.
    """
    LP, RP, W1, W2, theta = (workload or build_workload)(backend, chi, dtype, seed)
    v_leg = theta.get_leg_co_domain('vL')
    p_leg = theta.get_leg_co_domain('p0')
    rng = np.random.default_rng(seed + 1)
    kw = dict(backend=backend, labels=['vL', 'p', 'vR'], rng=rng, dtype=dtype)
    B1 = SymmetricTensor.from_random_normal([v_leg, p_leg], [v_leg], **kw)
    B2 = SymmetricTensor.from_random_normal([v_leg, p_leg], [v_leg], **kw)
    S = DiagonalTensor.from_random_uniform(v_leg, backend=backend, labels=['vL', 'vL*'],
                                           rng=rng, dtype=dtype) + 1.5
    theta_tmpl, mask = _freeze_bond(HEffective(LP, RP, W1, W2), theta, v_leg)
    if mask.small_leg != v_leg:
        raise AssertionError('the frozen mask does not keep the bond leg')
    return LP, RP, W1, W2, S, B1, B2, theta_tmpl, mask


def step_flops(LP, RP, W1, W2, theta, n_lanczos: int) -> int:
    """Contraction FLOPs of one static step, counted as bench.py:759-775 counts them:
    the exact GEMM FLOPs of the matvec chain LP, W1, W2, RP times ``n_lanczos + 2``
    (the two environment updates count as one matvec each). The SVD is in the time
    but not in the FLOPs. The chain's intermediates are computed to read their
    block structure."""
    flops = tdot_flops(LP, theta, ['vR'], ['vL'])
    x = tdot(LP, theta, 'vR', 'vL')
    flops += tdot_flops(x, W1, ['wR', 'p0'], ['wL', 'p0*'])
    x = tdot(x, W1, ['wR', 'p0'], ['wL', 'p0*'])
    flops += tdot_flops(x, W2, ['wR', 'p1'], ['wL', 'p1*'])
    x = tdot(x, W2, ['wR', 'p1'], ['wL', 'p1*'])
    flops += tdot_flops(x, RP, ['vR', 'wR'], ['vL', 'wL'])
    return flops * (n_lanczos + 2)


def _slope(seconds_of, lengths, repeats: int) -> float:
    """Seconds per call of the work that ``seconds_of(n)`` times ``n`` times: the best
    of ``repeats`` times for each of ``lengths``, then the slope between the
    shortest and the longest, or the mean of a single length (an upper bound that
    includes the fixed cost)."""
    times = {n: min(seconds_of(n) for _ in range(repeats)) for n in lengths}
    n1, n2 = min(times), max(times)
    slope = (times[n2] - times[n1]) / (n2 - n1) if n2 > n1 else 0.
    return slope if slope > 0 else times[n2] / n2


def _seconds_per_call(run, carry, lengths, repeats: int, events: bool = False) -> float:
    """:func:`_slope` of ``run(carry, n)``, which does the work ``n`` times and returns
    the new carry: timed on the host clock, ``run`` ending in a device sync, or with
    CUDA events around it (``events``)."""
    state = [carry]

    def seconds_of(n):
        if not events:
            t0 = time.perf_counter()
            state[0] = run(state[0], n)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state[0] = run(state[0], n)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    return _slope(seconds_of, lengths, repeats)


def step_run(chi: int, n_lanczos: int = 10, lengths=(2, 6), repeats: int = 3,
             precision: str = 'float32', svd_mode: str = 'steady', env_dtype=None,
             work_dtype=None, dtype=Dtype.float32, device: str = 'cuda', seed: int = 0,
             graph: bool = False):
    """Time the full static DMRG step of bench.py:649-775 (step_run) on ``device``.

    One step is one static-mode bond update (theta assembly, ``n_lanczos``
    iterations of the fused Lanczos, SVD, frozen-chi truncation, both environment
    updates) on the :func:`build_step_state` state (built in ``dtype``), whose
    outputs are fed back as the next step's inputs; LP and RP are renormalised each
    step. ``precision`` sets ``config.matmul_precision`` for the run.

    ``env_dtype`` (a :class:`Dtype` or its name, e.g. 'bfloat16') stores LP and RP
    in that dtype, cast again after every step as the engine's static path casts
    them (``DMRGEngine(env_dtype=...)``): theta and the Lanczos vectors stay in the
    working dtype. ``work_dtype`` casts the whole state (LP, RP, W1, W2, S, B1, B2
    and the theta template) to that dtype, and then ``env_dtype`` is not applied:
    every intermediate stays in it, the reductions and factorisations accumulating
    wider inside.

    It runs one warm-up step, then ``repeats`` runs of each of ``lengths`` steps, and
    takes the slope of the best times over the lengths (:func:`_slope`). Returns
    ``(seconds per step, FLOPs per step)`` with the FLOPs of :func:`step_flops`, and
    leaves the grouped-GEMM launches of one step in ``step_run.launches_per_step``,
    the energy of the warm-up step in ``step_run.energy`` and the dtypes of its
    outputs ``(S, B1, B2, LP, RP)`` in ``step_run.out_dtypes``.

    ``graph=False`` runs the steps eagerly and times them on the host clock.
    ``graph=True`` (CUDA, ``svd_mode='steady'``: the counterpart of ``bench.py``'s
    jitted ``lax.scan`` of steps, :703-727) captures one step after the warm-up step
    as static mode captures a bond update (``algorithms/dmrg.py::_GraphedStep``) and
    times runs of ``_GraphedStep.run`` with CUDA events: each step fills the graph's
    slots with the carry, replays it and copies its outputs out, as the engine does.
    """
    backend = get_backend(u1_symmetry, device=device)
    dtype, env_dtype, work_dtype = (Dtype[d] if isinstance(d, str) else d
                                    for d in (dtype, env_dtype, work_dtype))
    LP, RP, W1, W2, S, B1, B2, theta_tmpl, mask = build_step_state(backend, chi,
                                                                   dtype=dtype)
    flops = step_flops(LP, RP, W1, W2, theta_tmpl, n_lanczos)
    impl = _get_static_bond_fn(n_lanczos, svd_mode)
    mask = _PrefixMask(mask)
    if work_dtype is not None:
        LP, RP, W1, W2, S, B1, B2, theta_tmpl = (
            t.to_dtype(work_dtype) for t in (LP, RP, W1, W2, S, B1, B2, theta_tmpl))
        env_dtype = None  # the environments are in work_dtype already
    if env_dtype is not None:
        LP, RP = LP.to_dtype(env_dtype), RP.to_dtype(env_dtype)

    if graph and not (torch.device(device).type == 'cuda' and svd_mode == 'steady'):
        raise ValueError('step_run(graph=True) needs CUDA and svd_mode="steady"')

    def step(S, B1, B2, LP, RP):
        """One step: the new carry ``(S, B1, B2, LP, RP)``, then E."""
        E, nB1, S2, B2n, LPn, RPn = impl(HEffective(LP, RP, W1, W2), S, B1, B2,
                                         theta_tmpl, mask)
        LPn = scalar_multiply(1. / _device_norm(LPn), LPn)
        RPn = scalar_multiply(1. / _device_norm(RPn), RPn)
        if env_dtype is not None:  # the engine's static path casts them so
            LPn, RPn = LPn.to_dtype(env_dtype), RPn.to_dtype(env_dtype)
        return S2.relabelled(['vL', 'vL*']), nB1, B2n, LPn, RPn, E

    def run(carry, n):
        for _ in range(n):
            *carry, _ = step(*carry)
        backend.block_backend.synchronize()
        return carry

    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        launches = grouped_matmul.launches
        *carry, E = step(S, B1, B2, LP, RP)
        step_run.energy = float(E)
        step_run.out_dtypes = tuple(t.dtype for t in carry)
        step_run.launches_per_step = grouped_matmul.launches - launches
        if graph:
            g = _GraphedStep(step, carry)
            step_run.launches_per_step = g.graph.launches.get(grouped_matmul, 0)

            def replays(carry, n):
                for _ in range(n):
                    *carry, _ = g.run(carry)
                return carry

            t_step = _seconds_per_call(replays, carry, lengths, repeats, events=True)
        else:
            t_step = _seconds_per_call(run, carry, lengths, repeats)
    finally:
        config.matmul_precision = old
    return t_step, flops


step_run.launches_per_step = None
step_run.energy = None
step_run.out_dtypes = None


def _matvec_slope(args, lengths=(10, 50), repeats: int = 2) -> float:
    """Seconds per effective-Hamiltonian matvec, each output renormalised (in f32)
    and fed back, from the slope over ``lengths`` (scripts/exp_r5_step_decomp.py
    :126-156). A complex output of a real input (anyonic tree plans carry complex
    twist phases whose sum is real for a real Hamiltonian) is fed back as its real
    part, as bench.py:560-566 does, so that every matvec sees the input's dtype."""
    LP, RP, W1, W2, theta = args

    def run(th, n):
        for _ in range(n):
            out = _heff_matvec_impl(LP, RP, W1, W2, th)
            out = scalar_multiply(1. / _device_norm(out), out)
            th = out if out.dtype == th.dtype else out.to_dtype(th.dtype)
        LP.backend.block_backend.synchronize()
        return th

    return _seconds_per_call(run, run(theta, 1), lengths, repeats)


def step_decomposition(chi: int = 4096, lengths=(2, 6), repeats: int = 1,
                       device: str = 'cuda') -> dict:
    """Where the time of the chi=4096 step goes: the port of
    scripts/exp_r5_step_decomp.py, its phases in this order.

    1. The probe kernel against its plain version on a [256, 256] f32 array
       (``probe_works``: bitwise equal; the script's :51-65).
    2. The bare matvec at chi with bf16 storage and ``matmul_precision='default'``,
       slope-timed (``matvec{chi}_bf16_default_ms``; :115-161).
    3. The ``n_lanczos`` slope of the full f32 step (10 against 5 iterations) with
       the steady SVD: ms per Lanczos iteration and the intercept (theta assembly,
       SVD, truncation, environment updates), eagerly and, on CUDA, also as CUDA
       graphs timed by CUDA events (the keys with ``_graph``); and the step with the
       exact SVD (:163-183).

    Returns a dict of the results; ms values are unrounded.
    """
    res = {}
    x = torch.ones((256, 256), dtype=torch.float32, device=device)
    res['probe_works'] = bool(torch.equal(scale2(x), scale2_plain(x)))

    backend = get_backend(u1_symmetry, device=device)
    args = [t.to_dtype(Dtype.bfloat16) for t in build_workload(backend, chi)]
    old = config.matmul_precision
    config.matmul_precision = 'default'
    try:
        res[f'matvec{chi}_bf16_default_ms'] = _matvec_slope(args) * 1e3
    finally:
        config.matmul_precision = old
    del args

    for graph in ((False, True) if torch.device(device).type == 'cuda' else (False,)):
        tag = '_graph' if graph else ''
        for n_l in (10, 5):
            t, flops = step_run(chi, n_lanczos=n_l, lengths=lengths, repeats=repeats,
                                svd_mode='steady', device=device, graph=graph)
            res[f'step{chi}_f32_nl{n_l}{tag}_ms'] = t * 1e3
            res[f'step{chi}_f32_nl{n_l}{tag}_tflops'] = flops / t / 1e12
        a, b = res[f'step{chi}_f32_nl10{tag}_ms'], res[f'step{chi}_f32_nl5{tag}_ms']
        res[f'per_lanczos_iter{tag}_ms'] = (a - b) / 5
        res[f'intercept{tag}_ms'] = a - 10 * res[f'per_lanczos_iter{tag}_ms']
    t, _ = step_run(chi, n_lanczos=10, lengths=lengths, repeats=repeats,
                    svd_mode='exact', device=device)
    res[f'step{chi}_f32_exactsvd_ms'] = t * 1e3
    return res


def accuracy_bf16work(chi: int = 1024, L: int = 24, e_ref: float = HEIS24_E_REF,
                      n_bf16_sweeps: int = 6, device: str = 'cuda'):
    """The end-to-end accuracy of bench.py:1124-1186 (accuracy_bf16work): the U(1)
    Heisenberg chain run in bf16, then one f32 polish sweep, against ``e_ref``.

    ``n_bf16_sweeps`` sweeps with the state demoted to bf16 before each (the engine's
    ``env_dtype`` keeps LP/RP bf16), one-pass matmuls (``matmul_precision='default'``)
    and the adaptive growth SVD; then LP, RP, the Bs and the Ss are cast back to f32,
    ``env_dtype`` dropped, and one sweep runs at ``'float32'``. ``eps=0`` with
    ``chi_max=chi`` keeps production-sized blocks. The working dtype is f32, as in
    ``cyten_tpu``'s run (JAX's default without x64): the MPO and the state are built
    in f32. ``cyten_tpu``'s cache-clearing between sweeps has no counterpart.

    Returns ``(E, E_bf16, dE)``: the polished energy, that of the last bf16 sweep
    and ``|E - e_ref|`` (None without ``e_ref``). Prints each sweep's energy and
    seconds to stderr.
    """
    import sys

    model = HeisenbergModel(L=L, conserve='Sz', device=device)
    model.H_mpo = [W.to_dtype(Dtype.float32) for W in model.H_mpo]
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend, dtype=Dtype.float32)
    eng = DMRGEngine(psi, model, chi_max=chi, eps=0., pad_chi_multiple=chi // 4,
                     env_dtype=Dtype.bfloat16, matmul_precision='default',
                     dynamic_svd='adaptive', lanczos_options={'N_max': 10, 'P_tol': 1e-10})
    bb = model.backend.block_backend
    E_b = None
    for sweep_i in range(n_bf16_sweeps):
        t0 = time.perf_counter()
        for i in range(L):  # the engine's env_dtype covers LP/RP
            eng.psi.Bs[i] = eng.psi.Bs[i].to_dtype(Dtype.bfloat16)
            eng.psi.Ss[i] = eng.psi.Ss[i].to_dtype(Dtype.bfloat16)
        E_b = eng.sweep()
        bb.synchronize()
        print(f'accuracy sweep {sweep_i + 1}/{n_bf16_sweeps}: E={E_b:.8f}, '
              f'{time.perf_counter() - t0:.2f} s', file=sys.stderr, flush=True)
    # converge, then polish: one full-precision f32 sweep
    eng.env_dtype = None
    eng.matmul_precision = 'float32'
    for i in range(L):
        eng.psi.Bs[i] = eng.psi.Bs[i].to_dtype(Dtype.float32)
        eng.psi.Ss[i] = eng.psi.Ss[i].to_dtype(Dtype.float32)
    eng.LPs = [t if t is None else t.to_dtype(Dtype.float32) for t in eng.LPs]
    eng.RPs = [t if t is None else t.to_dtype(Dtype.float32) for t in eng.RPs]
    t0 = time.perf_counter()
    E = eng.sweep()
    bb.synchronize()
    print(f'accuracy polish sweep: E={E:.8f}, {time.perf_counter() - t0:.2f} s',
          file=sys.stderr, flush=True)
    return float(E), float(E_b), None if e_ref is None else abs(float(E) - e_ref)


def su2_run(chi_mult: int = 512, lengths=(10, 50), repeats: int = 2,
            precision: str = 'float32', device: str = 'cuda', builder=None):
    """Seconds per fusion-tree effective-Hamiltonian matvec on the ``builder``
    environment (f64; default :func:`build_su2_workload`, and
    :func:`build_golden_workload` for the golden chain), slope-timed over ``lengths``
    as bench.py:523-596 (su2_run) times it, each output renormalised and fed back.
    bench.py's second value, a time on its numpy backend, has no counterpart."""
    builder = builder or build_su2_workload
    symmetry = (fibonacci_anyon_category if builder is build_golden_workload
                else su2_symmetry)
    backend = get_backend(symmetry, device=device)
    args = builder(backend, chi_mult)
    old = config.matmul_precision
    config.matmul_precision = precision
    try:
        return _matvec_slope(args, lengths, repeats)
    finally:
        config.matmul_precision = old


def golden_run(chi_mult: int = 512, lengths=(10, 50), repeats: int = 2,
               precision: str = 'float32', device: str = 'cuda'):
    """Seconds per golden-chain matvec at ``chi_mult`` multiplets: :func:`su2_run` on
    :func:`build_golden_workload`, the counterpart of bench.py's
    ``golden_matvec_512mult_ms`` (:1376-1380)."""
    return su2_run(chi_mult, lengths, repeats, precision, device,
                   builder=build_golden_workload)


def su2_step(chi_mult: int = 512, n_lanczos: int = 10, svd_mode: str = 'steady',
             lengths=(5, 25), graph: bool = False, device: str = 'cuda'):
    """The static SU(2) bond update of bench.py:1188-1215 (su2_step_with_compile):
    one step on the :func:`build_step_state` state of :func:`build_su2_workload`
    (f64), called again and again on the same inputs, slope-timed over ``lengths``.

    Returns ``(setup seconds, seconds per step)``. Eagerly (``graph=False``) the
    setup is the first call, which builds the tree-move plans and the device
    constants; with ``graph=True`` (CUDA, ``svd_mode='steady'``) it is the capture of
    the step as a CUDA graph after that first call (:class:`_GraphedStep`), where
    ``cyten_tpu`` reports its compile seconds, and the steps are graph replays timed
    with CUDA events. Leaves the grouped-GEMM launches of one step in
    ``su2_step.launches_per_step`` and the energy of the first in ``su2_step.energy``.
    """
    backend = get_backend(su2_symmetry, device=device)
    LP, RP, W1, W2, S, B1, B2, theta_tmpl, mask = build_step_state(
        backend, chi_mult, workload=build_su2_workload)
    impl = _get_static_bond_fn(n_lanczos, svd_mode)
    mask = _PrefixMask(mask)
    if graph and not (torch.device(device).type == 'cuda' and svd_mode == 'steady'):
        raise ValueError('su2_step(graph=True) needs CUDA and svd_mode="steady"')

    def step(LP, RP, S, B1, B2):
        return impl(HEffective(LP, RP, W1, W2), S, B1, B2, theta_tmpl, mask)

    inputs = (LP, RP, S, B1, B2)
    t0 = time.perf_counter()
    launches = grouped_matmul.launches
    su2_step.energy = float(step(*inputs)[0])
    su2_step.launches_per_step = grouped_matmul.launches - launches
    setup_s = time.perf_counter() - t0
    if graph:
        g = _GraphedStep(step, inputs)
        setup_s = g.capture_seconds
        su2_step.launches_per_step = g.graph.launches.get(grouped_matmul, 0)

        def run(carry, n):
            for _ in range(n):
                g.run(inputs)
            return carry
    else:
        def run(carry, n):
            for _ in range(n):
                step(*inputs)
            backend.block_backend.synchronize()
            return carry

    return setup_s, _seconds_per_call(run, None, lengths, 1, events=graph)


su2_step.launches_per_step = None
su2_step.energy = None
