"""The environment updates of two-site DMRG (``_update_LP_impl``, ``_update_RP_impl``)
of the PyTorch port against cyten_tpu, and the pair lists they hand the grouped GEMM:
their contractions with the MPO tensor are the thin lists that the kernel runs in its
thin form (``blocks/grouped_gemm.py::_thin_form``), the others go to the tiled kinds.

Inputs are drawn once in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.to_port). On the CPU the port's grouped GEMM is its plain version,
which rounds the operands as the kernel's kind for ``config.matmul_precision`` does;
JAX on the CPU computes f32 products in full whatever the precision.
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms.dmrg import _update_LP_impl as jax_update_LP
from cyten_tpu.algorithms.dmrg import _update_RP_impl as jax_update_RP
from cyten_tpu.dtypes import Dtype as JaxDtype

from cyten_tpu_torch.algorithms.dmrg import _update_LP_impl, _update_RP_impl
from cyten_tpu_torch.blocks import grouped_gemm
from cyten_tpu_torch.config import config
from test_torch_dmrg import build_workload
from test_torch_interop import to_port

# the central charge of the virtual leg holds 17 states at chi = 64, more than THIN_K
# and THIN_S: the contractions with LP and the site tensor are not thin
CHI = 64
UPDATES = {'LP': (_update_LP_impl, jax_update_LP), 'RP': (_update_RP_impl, jax_update_RP)}
# the form of each grouped-GEMM list an update makes, in order: its contraction with
# the MPO tensor W is thin (tdot(t, W): K and N at most 3; compose(W, tp): M and K at
# most 3), the contractions with the environment and the site tensor are not
FORMS = {'LP': [None, 'tall', None], 'RP': [None, 'wide', None]}
# the update against cyten_tpu's full f32 result: f32 rounding at 'float32'; one
# operand rounding per product (2^-11 for TF32, 2^-8 for bf16) over the chain of
# three products at the other two (as the matvec's, test_torch_precision.py)
RTOL = {'float32': 1e-5, 'tensorfloat32': 3e-3, 'default': 2e-2}


def _operands(dtype):
    """``(environment, W, site tensor)`` of each update in cyten_tpu, in ``dtype``: LP
    or RP of the bench's bond environment at CHI, its MPO tensor W [wL, p | p*, wR],
    and a random site tensor [vL, p | vR] (A of the LP update, B of the RP one)."""
    backend = ct.get_backend(ct.u1_symmetry, 'numpy')
    LP, RP, W1, _, theta = build_workload(backend, CHI)
    v_leg, p_leg = theta.codomain.factors[0], theta.codomain.factors[1]
    X = ct.SymmetricTensor.from_random_normal([v_leg, p_leg], [v_leg], backend=backend,
                                              labels=['vL', 'p', 'vR'],
                                              rng=np.random.default_rng(1))
    W = W1.relabelled({'p0': 'p', 'p0*': 'p*'})
    LP, RP, W, X = (t.to_dtype(dtype) for t in (LP, RP, W, X))
    return {'LP': (LP, W, X), 'RP': (RP, W, X)}


@pytest.fixture
def precision_restored():
    old = config.matmul_precision
    yield
    config.matmul_precision = old


@pytest.mark.parametrize('update', list(UPDATES))
def test_thin_form_takes_the_w_contractions(update, monkeypatch):
    """Of the three lists of an environment update, the contraction with W is thin
    (tall for LP's tdot(t, W), wide for RP's compose(W, tp)) and the contractions
    with the environment and the site tensor are left to the tiled kinds."""
    forms = []
    plain = grouped_gemm.grouped_matmul_plain

    def recording(As, Bs, out_ids=None, n_out=None, pairs=None, precision=None):
        PA, PB = (As, Bs) if pairs is None else (grouped_gemm._select(As, pairs[0]),
                                                  grouped_gemm._select(Bs, pairs[1]))
        ids = np.arange(len(PA)) if out_ids is None else np.asarray(out_ids)
        MN = np.zeros((int(ids.max()) + 1 if n_out is None else n_out, 2), np.int64)
        for A, B, o in zip(PA, PB, ids.tolist()):
            MN[o] = A.shape[0], B.shape[1]
        forms.append(grouped_gemm._thin_form(MN, [A.shape[1] for A in PA]))
        return plain(As, Bs, out_ids, n_out, pairs, precision)

    monkeypatch.setattr(grouped_gemm, 'grouped_matmul_plain', recording)
    env, W, X = (to_port(t) for t in _operands(JaxDtype.float64)[update])
    UPDATES[update][0](env, W, X)
    assert forms == FORMS[update]


@pytest.mark.parametrize('update', list(UPDATES))
def test_update_matches_cyten_tpu_f64(update):
    """The port's update against cyten_tpu's on the same inputs, in f64."""
    args = _operands(JaxDtype.float64)[update]
    ref = UPDATES[update][1](*args)
    got = UPDATES[update][0](*(to_port(t) for t in args))
    assert got.labels == ref.labels
    # f64, the same block products summed in another order: the tensor-op
    # tolerance of cyten_tpu/testing/asserting.py:14
    np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('precision', list(RTOL))
@pytest.mark.parametrize('update', list(UPDATES))
def test_update_matches_cyten_tpu_at_precision(update, precision, precision_restored):
    """The port's update in f32 at each ``matmul_precision`` against cyten_tpu's full
    f32 result, within the rounding of the operands of its three products; at
    'tensorfloat32' and 'default' the operands are rounded (the mode is not a no-op)."""
    args = _operands(JaxDtype.float32)[update]
    ref = np.asarray(UPDATES[update][1](*args).to_numpy())
    port = [to_port(t) for t in args]
    config.matmul_precision = precision
    got = UPDATES[update][0](*port).to_numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < RTOL[precision]
    if precision != 'float32':
        config.matmul_precision = 'float32'
        exact = UPDATES[update][0](*port).to_numpy()
        assert np.linalg.norm(got - exact) > 0
