"""SU(2) symmetry data and fusion trees of the PyTorch port against cyten_tpu.

Every sector up to 2j = 4. The port's symmetry layer is host-side numpy, as
cyten_tpu's is; the recoupling data is exact arithmetic evaluated once, so the two
packages must agree to the last bit (F, R, B, C symbols, fusion tensors, Z
isomorphisms), and the fusion-tree enumeration tree by tree.
"""

import itertools

import numpy as np
import pytest

import cyten_tpu as ct

import cyten_tpu_torch as ctt

JJ = range(5)  # 2j = 0..4
SYM_J = ct.su2_symmetry
SYM_P = ctt.symmetries.su2_symmetry


def _s(jj):
    return np.array([jj])


def _admissible_six():
    """(a, b, c, d, e, f) with a x b -> f, f x c -> d, b x c -> e, a x e -> d."""
    for a, b, c, d in itertools.product(JJ, repeat=4):
        for e in JJ:
            if not (SYM_J.can_fuse_to(_s(b), _s(c), _s(e))
                    and SYM_J.can_fuse_to(_s(a), _s(e), _s(d))):
                continue
            for f in JJ:
                if (SYM_J.can_fuse_to(_s(a), _s(b), _s(f))
                        and SYM_J.can_fuse_to(_s(f), _s(c), _s(d))):
                    yield a, b, c, d, e, f


def _admissible_three():
    for a, b, c in itertools.product(JJ, repeat=3):
        if SYM_J.can_fuse_to(_s(a), _s(b), _s(c)):
            yield a, b, c


def test_symbols_equal_cyten_tpu():
    """F and C symbols of every admissible sextuple, R and B symbols of every
    admissible triple, exactly."""
    six = list(_admissible_six())
    assert len(six) > 100
    for args in six:
        s = [_s(x) for x in args]
        np.testing.assert_array_equal(SYM_P.f_symbol(*s), SYM_J.f_symbol(*s))
    c_six = [args for args in itertools.product(JJ, repeat=6)
             if all(SYM_J.can_fuse_to(*[_s(args[k]) for k in ks])
                    for ks in ((0, 1, 4), (4, 2, 3), (0, 2, 5), (5, 1, 3)))]
    assert len(c_six) > 100
    for args in c_six:
        s = [_s(x) for x in args]
        np.testing.assert_array_equal(SYM_P.c_symbol(*s), SYM_J.c_symbol(*s))
    for args in _admissible_three():
        s = [_s(x) for x in args]
        np.testing.assert_array_equal(SYM_P.r_symbol(*s), SYM_J.r_symbol(*s))
        np.testing.assert_array_equal(SYM_P.b_symbol(*s), SYM_J.b_symbol(*s))


def test_f_symbols_unitary():
    """Each F move, as a matrix from the e channel to the f channel at fixed
    (a, b, c, d), is orthogonal (to 1e-14): an independent check of the data. With
    2j <= 2 for a, b and c, every channel (2j <= 4) is in the table."""
    blocks: dict = {}
    for a, b, c, d, e, f in _admissible_six():
        if max(a, b, c) > 2:
            continue
        F = SYM_P.f_symbol(*[_s(x) for x in (a, b, c, d, e, f)])
        blocks.setdefault((a, b, c, d), {})[(e, f)] = float(F.reshape(-1)[0])
    for entries in blocks.values():
        es = sorted({e for e, _ in entries})
        fs = sorted({f for _, f in entries})
        M = np.array([[entries.get((e, f), 0.) for f in fs] for e in es])
        np.testing.assert_allclose(M @ M.T, np.eye(len(es)), atol=1e-14)


@pytest.mark.parametrize('Z_a, Z_b', [(False, False), (True, False), (False, True),
                                      (True, True)])
def test_fusion_tensors_equal_cyten_tpu(Z_a, Z_b):
    """The CG (fusion) tensors, with and without Z isomorphisms on either leg, and
    the Z isomorphisms, Frobenius-Schur indicators and quantum dimensions."""
    for a, b, c in _admissible_three():
        got = SYM_P.fusion_tensor(_s(a), _s(b), _s(c), Z_a, Z_b)
        np.testing.assert_array_equal(got, SYM_J.fusion_tensor(_s(a), _s(b), _s(c), Z_a, Z_b))
    for a in JJ:
        np.testing.assert_array_equal(SYM_P.Z_iso(_s(a)), SYM_J.Z_iso(_s(a)))
        assert SYM_P.frobenius_schur(_s(a)) == SYM_J.frobenius_schur(_s(a))
        assert SYM_P.qdim(_s(a)) == SYM_J.qdim(_s(a)) == a + 1


def _tree_key(t):
    return (t.uncoupled.tolist(), t.coupled.tolist(), t.are_dual.tolist(),
            t.inner_sectors.tolist(), t.multiplicities.tolist())


@pytest.mark.parametrize('n', [1, 2, 3, 4])
def test_fusion_trees_enumeration_equals_cyten_tpu(n):
    """Every fusion tree of n uncoupled sectors (2j <= 4, n <= 3; 2j <= 2 at n = 4),
    each with a pattern of dual legs drawn from a seed, into every coupled sector, in
    the same order,
    and the dense trees (``as_block``) to 1e-14."""
    rng = np.random.default_rng(n)
    top = 5 if n < 4 else 3
    count = 0
    for unc in itertools.product(range(top), repeat=n):
        uncoupled = np.array(unc)[:, None]
        are_dual = rng.integers(0, 2, size=n).astype(bool)
        for c in range(2 * top):
            got = list(ctt.symmetries.fusion_trees(SYM_P, uncoupled, _s(c), are_dual))
            ref = list(ct.symmetries.fusion_trees(SYM_J, uncoupled, _s(c), are_dual))
            assert [_tree_key(t) for t in got] == [_tree_key(t) for t in ref]
            for tp, tj in zip(got[:2], ref[:2]):
                np.testing.assert_allclose(tp.as_block(), tj.as_block(), atol=1e-14,
                                           rtol=0)
            count += len(got)
    assert count > 0
