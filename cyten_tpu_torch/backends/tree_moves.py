"""Host-side planning of leg permutations for the fusion-tree backend.

A copy of ``cyten_tpu/backends/tree_moves.py``. Role-equivalent to the reference's
instruction engine + tree mappings (cyten/backends/fusion_tree_backend.py:
PermuteLegsInstructionEngine :2698, Braid/Bend/TwistInstruction :2566-2697,
TreePairMapping :3181, FactorizedTreeMapping :3373, transform_tensor :3297).

Instead of transforming tensors through a chain of elementary instructions, the
full sequence of moves is composed **symbolically on tree pairs** on the host, into
one static plan — a list of (gather slice, scale, multiplicity-axis permutation,
scatter slice) entries per coupled sector — which the backend applies as dense
on-device ops. Plans are memoized on the
(codomain, domain, permutation, levels) key, so repeated calls (e.g. inside DMRG
sweeps) reuse them.

For an abelian graded symmetry (products of U(1), Z_N and one fermionic factor) every
tree is fixed by its uncoupled sectors and a move maps it to one tree with a sign, which
depends only on the parities of the legs' sectors. Its plan (:class:`AbelianPlan`) is
therefore built from the sector tables of both sides with numpy, the sign of each
parity pattern composed once on FermionParity trees; the tree-pair composition, whose
cost grows with the number of tree pairs (thousands at chi 1024 with two charges),
stays the path of every other symmetry (``ABELIAN_PLANS = False`` sends these there
too, as the parity tests do).

Move conventions (tensor ``T = sum block[Y, X] hconj(Y) ∘ X``; Y = codomain tree,
X = domain tree). ``over`` always means: the plane-LEFT strand of the exchanged
pair passes in front (which the level rule translates to "the higher level goes
over", reference _tensors.py:5519-5537):

- domain braid (plane-adjacent domain factors j, j+1): ``T' = T ∘ B``, i.e.
  ``X -> X.braid(j, not over)`` — the tree-level ``overbraid`` flag is mirrored
  relative to the plane-level chirality, exactly like for codomain trees below.
  Pinned amplitude-by-amplitude against the reference implementation
  (tests/test_ref_oracle_braiding.py); with the un-mirrored flag, a codomain
  crossing and a domain crossing of the same pair at the same heights do NOT
  cancel, which breaks every braid-and-bend roundtrip
  (tests/test_ftb_structure.py::test_long_range_braid_roundtrip).
- codomain braid: ``T' = B ∘ T`` and ``B ∘ hconj(Y) = hconj(Y ∘ B^dagger)``, i.e.
  ``Y -> Y.braid(j, not over, do_conj=True)`` (the vertical mirror flips chirality).
- right bends: ``FusionTree.bend_leg`` moves the last domain leg up
  (``bend_downward=True``) or the last codomain leg down (``False``).
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from math import prod

import numpy as np

from ..symmetries import TensorProduct
from ..symmetries.trees import FusionTree, fusion_trees
from ..tools.misc import iter_common_sorted_arrays

__all__ = ['permute_legs_plan', 'PermutePlan', 'PlanEntry', 'AbelianPlan']

CUTOFF = 1e-16

# chirality of the domain braids inside the left-bend composites (False = "the
# moving leg passes in front", in the plane-level `over` convention of
# _moves_factory). Validated by the planar rotation-roundtrip and double-transpose
# identities on Fibonacci tensors, the golden-chain benchmark energies, and the
# two-convention coherence test (test_fusion_tree_backend.py::test_lb_dm_chirality).
_LB_DM = False


def _rotation_direction(rot: int, n_flat: int) -> int:
    """Signed rotation for the planar path: the shorter way around.

    Module-level so tests can force the long direction and verify the coherence
    of the left-bend composites against the pure-right route
    (test_fusion_tree_backend.py::test_lb_dm_chirality).
    """
    return rot if rot <= n_flat // 2 else rot - n_flat


@dataclass(frozen=True)
class PlanEntry:
    old_block_key: tuple  # (i, j) into old (co)domain sector decompositions
    old_row_slc: slice
    old_col_slc: slice
    new_block_key: tuple
    new_row_slc: slice
    new_col_slc: slice
    coeff: complex
    mult_shape: tuple  # old sub-block as [row mults..., col mults...]
    axis_perm: tuple  # permutation to the new [row mults..., col mults...] order
    new_shape_2d: tuple


@dataclass(frozen=True)
class PermutePlan:
    entries: tuple
    complex_coeffs: bool


@dataclass(frozen=True)
class PlanGroup:
    """Entries of a :class:`PermutePlan` sharing one (mult_shape, axis_perm):
    a tree-pair mixing that acts as ``coeff [n_dst, n_src]`` on stacked
    sub-blocks with a SINGLE batched transpose — i.e. one small GEMM instead
    of ``nnz(coeff)`` slice/scale/scatter triples."""

    src: tuple        # ((old_block_key, old_row_slc, old_col_slc), ...)
    dst: tuple        # ((new_block_key, new_row_slc, new_col_slc), ...)
    coeff: object     # np.ndarray [n_dst, n_src]
    mult_shape: tuple
    axis_perm: tuple
    new_shape_2d: tuple


@dataclass(frozen=True)
class GroupedPlan:
    groups: tuple
    complex_coeffs: bool


@functools.lru_cache(maxsize=512)
def grouped_plan(plan: PermutePlan) -> GroupedPlan:
    """Compile a plan's entries into per-shape-class coefficient GEMMs.

    The ``axis_perm`` is global to a plan and ``mult_shape``/``new_shape_2d``
    are determined by the source tree pair's uncoupled sectors, so grouping by
    (mult_shape, new_shape_2d) collects exactly the entries whose sub-blocks
    can be stacked; the (src tree pair -> dst tree pair) coefficients then form
    a small dense matrix (cf. reference fusion_tree_backend.py:3181-3370,
    whose TreePairMapping stays an entry-at-a-time instruction stream)."""
    groups: dict = {}
    for e in plan.entries:
        key = (e.mult_shape, e.axis_perm, e.new_shape_2d)
        src_map, dst_map, triples = groups.setdefault(key, ({}, {}, []))
        s = (e.old_block_key, e.old_row_slc, e.old_col_slc)
        d = (e.new_block_key, e.new_row_slc, e.new_col_slc)
        si = src_map.setdefault(s, len(src_map))
        di = dst_map.setdefault(d, len(dst_map))
        triples.append((di, si, e.coeff))
    out = []
    ctype = complex if plan.complex_coeffs else float
    for (mult_shape, axis_perm, new_shape_2d), (src_map, dst_map, triples) \
            in groups.items():
        C = np.zeros((len(dst_map), len(src_map)), dtype=ctype)
        for di, si, c in triples:
            C[di, si] += c
        out.append(PlanGroup(src=tuple(src_map), dst=tuple(dst_map), coeff=C,
                             mult_shape=mult_shape, axis_perm=axis_perm,
                             new_shape_2d=new_shape_2d))
    return GroupedPlan(groups=tuple(out), complex_coeffs=plan.complex_coeffs)


@dataclass(frozen=True)
class BatchedGroup:
    """One shape-class of a plan, compiled to a constant-op-count program:
    ``len(gathers)`` batched gathers + 1 transform (+1 GEMM or coeff-mul) +
    ``len(scatters)`` batched scatter-adds, independent of the entry count.
    The per-entry formulation launches O(entries) slices and scatters; this one
    launches O(blocks touched), which is what keeps a CUDA graph of the SU(2) bond
    update short."""

    mode: str                # 'gemm' (dense coeff GEMM) | 'sparse' (per-entry)
    mult_shape: tuple
    axis_perm: tuple
    old_shape_2d: tuple      # gather window (rows, cols) in the old blocks
    new_shape_2d: tuple      # scatter window in the new blocks
    gathers: tuple           # ((old_block_key, starts[n, 2] ndarray), ...)
    coeff: object            # 'gemm': [n_dst_kept, n_src]; 'sparse': [n_entries]
    scatters: tuple          # ((new_block_key, rows_idx ndarray | None,
    #                           starts[n, 2] ndarray), ...)


@dataclass(frozen=True)
class BatchedProgram:
    groups: tuple
    complex_coeffs: bool


#: classes whose sub-blocks exceed this many elements scale entry by entry instead of
#: through a dense coefficient product (cyten_tpu's default; not re-measured on the
#: card)
GROUPED_MAX_BLOCK = 32768


@functools.lru_cache(maxsize=1024)
def batched_program(plan: PermutePlan, present: tuple) -> BatchedProgram:
    """Compile ``grouped_plan(plan)`` + the set of PRESENT old blocks into a
    fully index-batched program (see :class:`BatchedGroup`).

    ``present`` is the sorted tuple of old block keys the tensor actually has
    (host metadata) — missing blocks are structural zeros, so their columns are
    dropped here once instead of being skipped entry-by-entry at apply time.
    Groups whose sub-block volume exceeds :data:`GROUPED_MAX_BLOCK` use the
    'sparse' mode (per-entry coefficients, FLOPs ~ nnz instead of the dense
    n_dst*n_src GEMM),
    but with the same O(blocks) op count."""
    from math import prod

    present_set = set(present)
    out = []
    for g in grouped_plan(plan).groups:
        avail = [i for i, (obk, _, _) in enumerate(g.src) if obk in present_set]
        if not avail:
            continue
        h = g.src[avail[0]][1].stop - g.src[avail[0]][1].start
        w = g.src[avail[0]][2].stop - g.src[avail[0]][2].start
        mode = 'sparse' if prod(g.mult_shape) > GROUPED_MAX_BLOCK else 'gemm'
        if mode == 'gemm':
            buckets: dict = {}
            stacked = []
            for i in avail:
                obk = g.src[i][0]
                buckets.setdefault(obk, []).append(i)
            for obk, idcs in buckets.items():
                stacked.extend(idcs)
            gathers = tuple(
                (obk, np.array([[g.src[i][1].start, g.src[i][2].start]
                                for i in idcs], np.int64))
                for obk, idcs in buckets.items())
            C = g.coeff[:, stacked]
            nz = np.flatnonzero(np.abs(C).max(axis=1) > 0)
            if len(nz) == 0:
                continue
            C = C[nz]
            dst_buckets: dict = {}
            for row, di in enumerate(nz):
                nbk, nrs, ncs = g.dst[int(di)]
                dst_buckets.setdefault(nbk, []).append(
                    (row, nrs.start, ncs.start))
            scatters = tuple(
                (nbk,
                 None if len(rows) == len(nz) and
                 all(r == k for k, (r, _, _) in enumerate(rows))
                 else np.array([r for r, _, _ in rows], np.intp),
                 np.array([[rs, cs] for _, rs, cs in rows], np.int64))
                for nbk, rows in dst_buckets.items())
            out.append(BatchedGroup(
                mode='gemm', mult_shape=g.mult_shape, axis_perm=g.axis_perm,
                old_shape_2d=(h, w), new_shape_2d=g.new_shape_2d,
                gathers=gathers, coeff=C, scatters=scatters))
        else:
            # entries = nonzeros of the coeff matrix restricted to avail srcs
            avail_set = set(avail)
            entries = [(di, si, g.coeff[di, si])
                       for di in range(g.coeff.shape[0])
                       for si in range(g.coeff.shape[1])
                       if si in avail_set and g.coeff[di, si] != 0]
            if not entries:
                continue
            # order by source block (first-appearance) for bucketed gathers
            buckets = {}
            for k, (di, si, c) in enumerate(entries):
                buckets.setdefault(g.src[si][0], []).append(k)
            entries = [entries[k] for idcs in buckets.values() for k in idcs]
            gathers = []
            pos = 0
            for obk, idcs in buckets.items():
                chunk = entries[pos:pos + len(idcs)]
                gathers.append((obk, np.array(
                    [[g.src[si][1].start, g.src[si][2].start]
                     for _, si, _ in chunk], np.int64)))
                pos += len(idcs)
            gathers = tuple(gathers)
            coeff_vec = np.array([c for _, _, c in entries])
            dst_buckets = {}
            for k, (di, _, _) in enumerate(entries):
                nbk, nrs, ncs = g.dst[int(di)]
                dst_buckets.setdefault(nbk, []).append((k, nrs.start, ncs.start))
            scatters = tuple(
                (nbk,
                 None if len(rows) == len(entries) and
                 all(r == k for k, (r, _, _) in enumerate(rows))
                 else np.array([r for r, _, _ in rows], np.intp),
                 np.array([[rs, cs] for _, rs, cs in rows], np.int64))
                for nbk, rows in dst_buckets.items())
            out.append(BatchedGroup(
                mode='sparse', mult_shape=g.mult_shape, axis_perm=g.axis_perm,
                old_shape_2d=(h, w), new_shape_2d=g.new_shape_2d,
                gathers=gathers, coeff=coeff_vec, scatters=scatters))
    return BatchedProgram(groups=tuple(out),
                          complex_coeffs=plan.complex_coeffs)


class _PairMap:
    """Linear map on (codomain tree, domain tree) pairs, composed move by move."""

    def __init__(self, pairs):
        self.map = {p: {p: 1.0} for p in pairs}

    def apply(self, move_fn):
        for old, cur in self.map.items():
            new: dict = {}
            for pair, coeff in cur.items():
                for pair2, c2 in move_fn(pair).items():
                    tot = coeff * c2
                    if pair2 in new:
                        new[pair2] += tot
                    else:
                        new[pair2] = tot
            self.map[old] = {p: c for p, c in new.items() if abs(c) > CUTOFF}


def _all_pairs(codomain: TensorProduct, domain: TensorProduct):
    """All (Y, X) tree pairs over common coupled sectors."""
    sym = codomain.symmetry
    cod_dual = [l.is_dual for l in codomain.flat_legs]
    dom_dual = [l.is_dual for l in domain.flat_legs]
    pairs = []
    for i, j in iter_common_sorted_arrays(codomain.sector_decomposition,
                                          domain.sector_decomposition):
        c = codomain.sector_decomposition[i]
        Ys = []
        for unc, _ in codomain.iter_uncoupled():
            Ys.extend(fusion_trees(sym, unc, c, cod_dual))
        Xs = []
        for unc, _ in domain.iter_uncoupled():
            Xs.extend(fusion_trees(sym, unc, c, dom_dual))
        for Y in Ys:
            for X in Xs:
                pairs.append((Y, X))
    return pairs


def _moves_factory(sym):
    symmetric = sym.has_symmetric_braid

    def braid_domain(j, over):
        def fn(pair):
            Y, X = pair
            return {(Y, X2): c
                    for X2, c in X.braid(j, overbraid=not over).items()}

        return fn

    def braid_codomain(j, over):
        def fn(pair):
            Y, X = pair
            return {(Y2, X): c
                    for Y2, c in Y.braid(j, overbraid=not over, do_conj=True).items()}

        return fn

    def bend_up(pair):
        Y, X = pair
        return FusionTree.bend_leg(Y, X, bend_downward=True)

    def bend_down(pair):
        Y, X = pair
        return FusionTree.bend_leg(Y, X, bend_downward=False)

    def twist_domain_first(overtwist):
        """Twist factor of the first domain leg (used by composite left bends)."""

        def fn(pair):
            Y, X = pair
            return {(Y, X2): c for X2, c in X.twist([0], overtwist=overtwist).items()}

        return fn

    def twist_codomain_first(overtwist):
        # splitting-tree twist: opposite twist on the fusion-tree representative
        # gives one conj; representing t = dagger(t_fusion) conjugates coefficients
        # again — the two conjs cancel (cf. reference fusion_tree_backend.py:3266-74)
        def fn(pair):
            Y, X = pair
            res = Y.twist([0], overtwist=overtwist)
            return {(Y2, X): c for Y2, c in res.items()}

        return fn

    return (braid_domain, braid_codomain, bend_up, bend_down, twist_domain_first,
            twist_codomain_first)


def permute_legs_plan(codomain: TensorProduct, domain: TensorProduct,
                      codomain_idcs: tuple, domain_idcs: tuple,
                      levels: tuple | None,
                      bend_right: bool | None = None) -> PermutePlan | None:
    """Compute (and cache) the permutation plan. Returns None if levels are
    required (non-symmetric braiding with actual crossings) but not given.

    ``bend_right=True/False`` forces every bend onto the right/left side of the
    tensor (reference _tensors.py:5524-5536); ``None`` leaves the side to the
    planner (shorter planar rotation — crossing-free, the anyon-friendly
    default)."""
    return _cached_plan(codomain, domain, tuple(codomain_idcs), tuple(domain_idcs),
                        levels, bend_right)


@functools.lru_cache(maxsize=512)
def _cached_plan(codomain, domain, codomain_idcs, domain_idcs, levels,
                 bend_right=None):
    sym = codomain.symmetry
    K = codomain.num_factors
    n = K + domain.num_factors

    # --- flat-leg tags -------------------------------------------------------------
    cod_flat = codomain.flat_legs
    dom_flat = domain.flat_legs  # factor order
    Jf = len(cod_flat)
    Mf = len(dom_flat)

    def factor_flat_tags(i):
        """Flat tags of the factor at legs position i, in *legs order*."""
        if i < K:
            return list(codomain.flat_leg_idcs(i))
        k = n - 1 - i
        return [Jf + t for t in reversed(domain.flat_leg_idcs(k))]

    # target tag lists
    target_cod = []
    for i in codomain_idcs:
        tags = factor_flat_tags(i)
        # a factor's flats in legs order == codomain order for codomain factors;
        # for factors moving from the domain, the codomain order is the legs order
        target_cod.extend(tags)
    target_dom = []
    for i in domain_idcs:
        tags = factor_flat_tags(i)
        # domain factor order is the reverse of legs order
        target_dom.extend(reversed(tags))

    # levels per tag
    if levels is not None:
        lv = list(levels)
        tag_level = {}
        for i in range(n):
            for t in factor_flat_tags(i):
                tag_level[t] = lv[i]
    else:
        tag_level = None

    # --- state: current tag arrangement -----------------------------------------------
    cod_tags = list(range(Jf))
    dom_tags = list(range(Jf, Jf + Mf))
    (braid_domain, braid_codomain, bend_up, bend_down, twist_domain_first,
     twist_codomain_first) = _moves_factory(sym)
    symmetric = sym.has_symmetric_braid
    moves = []  # list of move fns

    braids_needed = False

    def chirality(t1, t2):
        """True if t1 goes over t2."""
        nonlocal braids_needed
        braids_needed = True
        if tag_level is None:
            return True
        return tag_level[t1] > tag_level[t2]

    def do_braid_cod(j, over=None):
        if over is None:
            over = chirality(cod_tags[j], cod_tags[j + 1])
        moves.append(braid_codomain(j, over))
        cod_tags[j], cod_tags[j + 1] = cod_tags[j + 1], cod_tags[j]

    def do_braid_dom(j, over=None):
        if over is None:
            over = chirality(dom_tags[j], dom_tags[j + 1])
        moves.append(braid_domain(j, over))
        dom_tags[j], dom_tags[j + 1] = dom_tags[j + 1], dom_tags[j]

    def do_bend_down():
        moves.append(bend_down)
        dom_tags.append(cod_tags.pop())

    def do_bend_up():
        moves.append(bend_up)
        cod_tags.append(dom_tags.pop())

    def do_bend_down_left():
        """cod_0 -> dom_0: twist the leg, slide it in front of everything around the
        right side (cf. reference fusion_tree_backend.py:2864-2877: by coherence
        this equals the left bend)."""
        moves.append(twist_codomain_first(overtwist=True))
        for j in range(0, len(cod_tags) - 1):
            do_braid_cod(j, over=True)  # moving leg (at j) goes in front
        do_bend_down()
        for j in range(len(dom_tags) - 2, -1, -1):
            do_braid_dom(j, over=_LB_DM)  # moving leg at j + 1 in front

    def do_bend_up_left():
        """dom_0 -> cod_0: twist the leg, slide it in front of everything around the
        right side (cf. reference fusion_tree_backend.py:2936-2941)."""
        moves.append(twist_domain_first(overtwist=False))
        for j in range(0, len(dom_tags) - 1):
            do_braid_dom(j, over=not _LB_DM)  # moving leg (at j) in front
        do_bend_up()
        for j in range(len(cod_tags) - 2, -1, -1):
            do_braid_cod(j, over=False)  # moving leg at j + 1 in front

    # --- planar fast path: the permutation is a cyclic rotation -> bends only.
    # Only used when legs actually switch sides: in-side reorderings are *braids*
    # (crossings as drawn), not rotations — for twisted sectors (fermions, anyons)
    # the two differ by twist factors (cf. reference TwistInstruction notes).
    new_order = list(codomain_idcs) + list(domain_idcs)[::-1]
    flat_new_order = []
    for i in new_order:
        flat_new_order.extend(factor_flat_tags(i))
    n_flat = Jf + Mf
    # old circular (legs) order expressed in tags
    circ_old = list(range(Jf)) + list(range(Jf + Mf - 1, Jf - 1, -1))
    rot = None
    sides_change = set(target_cod) != set(range(Jf))
    if sides_change and flat_new_order and n_flat > 0:
        try:
            start = circ_old.index(flat_new_order[0])
        except ValueError:
            start = None
        if start is not None and flat_new_order == [
                circ_old[(start + k) % n_flat] for k in range(n_flat)]:
            rot = start
    if rot is not None and bend_right is not None and not symmetric \
            and not (bend_right is True and rot == 0):
        # an explicit bend side was requested: the planar rotation would wrap
        # legs around whichever edge is shorter, so only take it when that
        # matches (rot == 0 walks only the right-edge cut = pure right bends).
        # A nonzero rotation realized with only `bend_right`-side bends needs
        # braids instead (crossings as drawn) -> route through the general path.
        rot = None
    if rot is not None:
        K_new = len(target_cod)
        # choose the shorter rotation direction; walk the two boundary cuts
        rot_signed = _rotation_direction(rot, n_flat)
        left, right = 0, Jf
        target_left, target_right = rot_signed, rot_signed + K_new
        while (left, right) != (target_left, target_right):
            if right < target_right and dom_tags:
                do_bend_up()
                right += 1
            elif right > target_right and cod_tags:
                do_bend_down()
                right -= 1
            elif left < target_left and cod_tags:
                do_bend_down_left()
                left += 1
            elif left > target_left and dom_tags:
                do_bend_up_left()
                left -= 1
            else:  # pragma: no cover
                raise RuntimeError('planar routing stuck')
    elif bend_right is False and not symmetric:
        # all-LEFT bends: mirror of the right route below — move legs to the
        # plane-left end of their side, then bend around the left edge (the
        # left composites include the twist; see do_bend_*_left).
        to_dom = set(target_dom)
        while any(t in to_dom for t in cod_tags):
            idx = min(i for i, t in enumerate(cod_tags) if t in to_dom)
            for j in range(idx - 1, -1, -1):
                do_braid_cod(j)
            do_bend_down_left()
        to_cod = set(target_cod)
        while any(t in to_cod for t in dom_tags):
            idx = min(i for i, t in enumerate(dom_tags) if t in to_cod)
            for j in range(idx - 1, -1, -1):
                do_braid_dom(j)
            do_bend_up_left()
        want = {t: i for i, t in enumerate(target_cod)}
        for i in range(len(cod_tags)):
            for j in range(len(cod_tags) - 1):
                if want[cod_tags[j]] > want[cod_tags[j + 1]]:
                    do_braid_cod(j)
        want = {t: i for i, t in enumerate(target_dom)}
        for i in range(len(dom_tags)):
            for j in range(len(dom_tags) - 1):
                if want[dom_tags[j]] > want[dom_tags[j + 1]]:
                    do_braid_dom(j)
    else:
        # 1) move codomain legs that belong in the domain: rightmost first
        to_dom = set(target_dom)
        while any(t in to_dom for t in cod_tags):
            idx = max(i for i, t in enumerate(cod_tags) if t in to_dom)
            for j in range(idx, len(cod_tags) - 1):
                do_braid_cod(j)
            do_bend_down()
        # 2) move domain legs that belong in the codomain
        to_cod = set(target_cod)
        while any(t in to_cod for t in dom_tags):
            idx = max(i for i, t in enumerate(dom_tags) if t in to_cod)
            for j in range(idx, len(dom_tags) - 1):
                do_braid_dom(j)
            do_bend_up()
        # 3) sort codomain to target order (bubble sort)
        want = {t: i for i, t in enumerate(target_cod)}
        for i in range(len(cod_tags)):
            for j in range(len(cod_tags) - 1):
                if want[cod_tags[j]] > want[cod_tags[j + 1]]:
                    do_braid_cod(j)
        want = {t: i for i, t in enumerate(target_dom)}
        for i in range(len(dom_tags)):
            for j in range(len(dom_tags) - 1):
                if want[dom_tags[j]] > want[dom_tags[j + 1]]:
                    do_braid_dom(j)
    assert cod_tags == target_cod and dom_tags == target_dom, \
        (cod_tags, target_cod, dom_tags, target_dom)

    if braids_needed and rot is None and not symmetric and levels is None:
        return None
    if ABELIAN_PLANS and _is_abelian_graded(sym) and Jf == K and Mf == n - K:
        # the moves follow from the legs' duality and the permutation alone
        moves_key = (tuple(l.is_dual for l in cod_flat), tuple(l.is_dual for l in dom_flat),
                     codomain_idcs, domain_idcs, levels, bend_right)
        return _abelian_plan(codomain, domain, target_cod, target_dom, moves, moves_key)

    # --- compose the pair map ------------------------------------------------------------
    pairs = _all_pairs(codomain, domain)
    pm = _PairMap(pairs)
    for mv in moves:
        pm.apply(mv)

    # --- build the new (co)domain structure ------------------------------------------------
    all_flat = cod_flat + dom_flat

    def tag_leg_as_cod(t):
        leg = all_flat[t]
        return leg if t < Jf else leg.dual

    def tag_leg_as_dom(t):
        leg = all_flat[t]
        return leg.dual if t < Jf else leg

    new_codomain = TensorProduct([tag_leg_as_cod(t) for t in target_cod],
                                 symmetry=sym)
    new_domain = TensorProduct([tag_leg_as_dom(t) for t in target_dom], symmetry=sym)

    # multiplicity lookup per tag
    def tag_mult(t, sector):
        leg = all_flat[t]
        idx = leg.sector_decomposition_where(np.asarray(sector))
        return int(leg.multiplicities[idx])

    # old axis order of mult axes: [cod tags..., dom tags...]
    old_axes = list(range(Jf)) + list(range(Jf, Jf + Mf))
    new_axes = list(target_cod) + list(target_dom)
    axis_perm = tuple(old_axes.index(t) for t in new_axes)

    # --- emit entries -----------------------------------------------------------------------
    entries = []
    complex_coeffs = False
    slice_cache_old: dict = {}
    slice_cache_new: dict = {}

    def old_key_and_slices(Y, X):
        key = (Y, X)
        res = slice_cache_old.get(key)
        if res is None:
            c = Y.coupled
            i = codomain.sector_decomposition_where(np.asarray(c))
            j = domain.sector_decomposition_where(np.asarray(c))
            res = ((int(i), int(j)), codomain.tree_block_slice(Y),
                   domain.tree_block_slice(X))
            slice_cache_old[key] = res
        return res

    def new_key_and_slices(Y, X):
        key = (Y, X)
        res = slice_cache_new.get(key)
        if res is None:
            c = Y.coupled
            i = new_codomain.sector_decomposition_where(np.asarray(c))
            j = new_domain.sector_decomposition_where(np.asarray(c))
            res = ((int(i), int(j)), new_codomain.tree_block_slice(Y),
                   new_domain.tree_block_slice(X))
            slice_cache_new[key] = res
        return res

    for (Y0, X0), targets in pm.map.items():
        if not targets:
            continue
        old_bk, old_rs, old_cs = old_key_and_slices(Y0, X0)
        # mult shape: per old arrangement: Y0 uncoupled sectors on cod tags,
        # X0 uncoupled on dom tags (factor order)
        row_mults = tuple(tag_mult(t, a)
                          for t, a in zip(range(Jf), Y0.uncoupled))
        col_mults = tuple(tag_mult(t, a)
                          for t, a in zip(range(Jf, Jf + Mf), X0.uncoupled))
        mult_shape = row_mults + col_mults
        sector_of_tag = {t: a for t, a in zip(range(Jf), Y0.uncoupled)}
        sector_of_tag.update({t: a for t, a in zip(range(Jf, Jf + Mf),
                                                   X0.uncoupled)})
        new_rows = prod(tag_mult(t, sector_of_tag[t]) for t in target_cod) \
            if target_cod else 1
        new_cols = prod(tag_mult(t, sector_of_tag[t]) for t in target_dom) \
            if target_dom else 1
        for (Yf, Xf), coeff in targets.items():
            new_bk, new_rs, new_cs = new_key_and_slices(Yf, Xf)
            c = complex(coeff)
            if abs(c.imag) > 1e-300:
                complex_coeffs = True
            entries.append(PlanEntry(
                old_block_key=old_bk, old_row_slc=old_rs, old_col_slc=old_cs,
                new_block_key=new_bk, new_row_slc=new_rs, new_col_slc=new_cs,
                coeff=c if abs(c.imag) > 0 else c.real,
                mult_shape=mult_shape, axis_perm=axis_perm,
                new_shape_2d=(new_rows, new_cols)))
    return PermutePlan(entries=tuple(entries), complex_coeffs=complex_coeffs)


# --- abelian graded symmetries: one signed gather per plan -------------------------------

#: plans of abelian graded symmetries (products of U(1), Z_N and one fermionic factor)
#: as one signed permutation of the blocks' elements (:class:`AbelianPlan`); False
#: sends them through the tree-pair composition above, as every other symmetry
ABELIAN_PLANS = True


def _is_abelian_graded(sym) -> bool:
    """True if every sector of ``sym`` is one-dimensional with one fusion outcome and
    trivial F symbols, and its braid is symmetric with at most one fermionic factor:
    each tree pair then moves to exactly one tree pair, with a sign."""
    from ..symmetries.fermions import _FermionicBase
    from ..symmetries.groups import U1, ZN, NoSymmetry

    factors = sym.factors
    return (sym.has_symmetric_braid
            and all(isinstance(f, (U1, ZN, NoSymmetry, _FermionicBase)) for f in factors)
            and sum(isinstance(f, _FermionicBase) for f in factors) <= 1)


@dataclass(frozen=True, eq=False)
class AbelianPlan:
    """A leg permutation of a tensor of an abelian graded symmetry, tree pair by tree
    pair (a tree pair is one sector for each leg): the old pair's sub-block, shaped
    ``mult_shapes[p]`` (the old legs' multiplicities, codomain then domain), has its
    axes permuted by ``axis_perm`` and lands, times ``signs[p]``, in the new pair's
    window. Starts are ``(row, column)`` in the block of the pair's coupled sector;
    ``old_shapes``/``new_shapes`` give each block's shape by its key."""

    old_keys: np.ndarray    # [n_pairs, 2] (codomain, domain) sector index
    old_starts: np.ndarray  # [n_pairs, 2]
    new_keys: np.ndarray    # [n_pairs, 2]
    new_starts: np.ndarray  # [n_pairs, 2]
    mult_shapes: np.ndarray  # [n_pairs, n_legs]
    signs: np.ndarray       # [n_pairs], +-1
    axis_perm: tuple
    n_codomain: tuple       # flat codomain legs, old and new
    old_shapes: dict
    new_shapes: dict
    complex_coeffs: bool = False
    token: int = field(default_factory=itertools.count().__next__)  # names its constants


def _tree_table(tp: TensorProduct):
    """The tree blocks of a side of an abelian symmetry, in the backend's order:
    ``(idcs, coupled, offsets)``, with ``idcs[n]`` the sector index of each flat leg
    for the n-th uncoupled combination (C order, last leg fastest), ``coupled[n]`` the
    index of its coupled sector in ``tp.sector_decomposition`` and ``offsets[n]`` its
    first row in that sector's block. Cached on ``tp``."""
    res = getattr(tp, '_abelian_tree_table', None)
    if res is not None:
        return res
    sym = tp.symmetry
    legs = tp.flat_legs
    if legs:
        grids = np.meshgrid(*[np.arange(l.num_sectors) for l in legs], indexing='ij')
        idcs = np.stack([g.reshape(-1) for g in grids], axis=1)
        sectors = sym.multiple_fusion_broadcast(
            *[l.sector_decomposition[idcs[:, k]] for k, l in enumerate(legs)])
        sizes = np.prod(np.stack([l.multiplicities[idcs[:, k]]
                                  for k, l in enumerate(legs)], axis=1), axis=1)
    else:
        idcs = np.zeros((1, 0), int)
        sectors = sym.trivial_sector[None, :]
        sizes = np.ones(1, int)
    lookup = {tuple(r): i for i, r in enumerate(tp.sector_decomposition.tolist())}
    uniq, inv = np.unique(sectors, axis=0, return_inverse=True)
    coupled = np.array([lookup[tuple(r)] for r in uniq.tolist()], int)[inv.reshape(-1)]
    order = np.argsort(coupled, kind='stable')
    ends = np.cumsum(sizes[order])
    group_start = np.searchsorted(coupled[order], coupled[order], side='left')
    firsts = np.concatenate([[0], ends])[group_start]
    offsets = np.empty_like(sizes)
    offsets[order] = ends - sizes[order] - firsts
    res = tp._abelian_tree_table = (idcs, coupled, offsets)
    return res


def _sector_map(old_leg, new_leg, switched: bool) -> np.ndarray:
    """Index in ``new_leg.sector_decomposition`` of each sector of ``old_leg``, dualised
    if the leg switched between codomain and domain."""
    sectors = old_leg.sector_decomposition
    if switched:
        sectors = old_leg.symmetry.dual_sectors(sectors)
    lookup = {tuple(r): i for i, r in enumerate(new_leg.sector_decomposition.tolist())}
    return np.array([lookup[tuple(r)] for r in sectors.tolist()], int)


_PARITY_TABLES: dict = {}


def _parity_signs(sym, codomain, domain, moves, moves_key) -> tuple:
    """``(fermionic factor index, table)``: the sign that ``moves`` give a tree pair,
    by the parities of its legs' sectors (bit k of the table's index: leg k, codomain
    then domain, odd). Computed by composing the moves on the tree pairs of
    FermionParity legs with the same duality (once per ``moves_key``): the symbols of
    U(1) and Z_N factors are all 1, so only the fermionic factor's give signs. None if
    there is none."""
    from ..symmetries.fermions import _FermionicBase

    fermionic = [k for k, f in enumerate(sym.factors) if isinstance(f, _FermionicBase)]
    if not fermionic:
        return None
    table = _PARITY_TABLES.get(moves_key)
    if table is None:
        table = _PARITY_TABLES[moves_key] = _parity_table(codomain, domain, moves)
    return fermionic[0], table


def _parity_table(codomain, domain, moves) -> np.ndarray:
    from ..symmetries import ElementarySpace, FermionParity

    parity = FermionParity().as_Symmetry()

    def parity_legs(legs):
        return TensorProduct([ElementarySpace(parity, [[0], [1]], [1, 1],
                                              is_dual=l.is_dual) for l in legs],
                             symmetry=parity)

    pm = _PairMap(_all_pairs(parity_legs(codomain.flat_legs),
                             parity_legs(domain.flat_legs)))
    for mv in moves:
        pm.apply(mv)
    n_legs = codomain.num_flat_legs + domain.num_flat_legs
    table = np.zeros(2 ** n_legs)
    for (Y, X), targets in pm.map.items():
        (coeff,) = targets.values()
        bits = np.concatenate([Y.uncoupled[:, 0], X.uncoupled[:, 0]])
        table[int(np.dot(bits, 2 ** np.arange(n_legs)))] = np.real(coeff)
    return table


def _common_sectors(codomain, domain) -> dict:
    """``{i: j}``: the codomain's sector i is the domain's sector j."""
    lookup = {tuple(r): j for j, r in enumerate(domain.sector_decomposition.tolist())}
    return {i: lookup[tuple(r)] for i, r in enumerate(codomain.sector_decomposition.tolist())
            if tuple(r) in lookup}


def _combination_index(tp, idcs) -> np.ndarray:
    """The position of each row of sector indices (one per flat leg) in the C-order
    enumeration of ``_tree_table``."""
    res = np.zeros(len(idcs), int)
    for k, leg in enumerate(tp.flat_legs):
        res = res * leg.num_sectors + idcs[:, k]
    return res


def _abelian_plan(codomain, domain, target_cod, target_dom, moves, moves_key) -> AbelianPlan:
    sym = codomain.symmetry
    J = codomain.num_flat_legs
    all_flat = codomain.flat_legs + domain.flat_legs
    new_cod_legs = [all_flat[t] if t < J else all_flat[t].dual for t in target_cod]
    new_dom_legs = [all_flat[t].dual if t < J else all_flat[t] for t in target_dom]
    new_codomain = TensorProduct(new_cod_legs, symmetry=sym)
    new_domain = TensorProduct(new_dom_legs, symmetry=sym)

    # every (codomain combination, domain combination) with a common coupled sector
    ci, cc, co = _tree_table(codomain)
    di, dc, do = _tree_table(domain)
    n_dom = len(domain.sector_decomposition)
    common = _common_sectors(codomain, domain)
    j_of_c = np.array([common.get(i, -1) for i in range(len(codomain.sector_decomposition))],
                      int)[cc]
    d_order = np.argsort(dc, kind='stable')
    d_first = np.searchsorted(dc[d_order], np.arange(n_dom))
    cnt = np.where(j_of_c >= 0, np.bincount(dc, minlength=n_dom)[np.maximum(j_of_c, 0)], 0)
    pc = np.repeat(np.arange(len(cc)), cnt)
    within = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pd = d_order[d_first[j_of_c[pc]] + within]
    tags = np.concatenate([ci[pc], di[pd]], axis=1)  # sector index per old leg

    # the new pairs: the same sectors, dualised where a leg switched sides
    new_tags = target_cod + target_dom
    new_legs = new_cod_legs + new_dom_legs
    new_idcs = np.stack(
        [_sector_map(all_flat[t], new_legs[k], (t < J) != (k < len(target_cod)))[tags[:, t]]
         for k, t in enumerate(new_tags)], axis=1)
    Jn = len(target_cod)
    _, ncc, nco = _tree_table(new_codomain)
    _, ndc, ndo = _tree_table(new_domain)
    r_new = _combination_index(new_codomain, new_idcs[:, :Jn])
    c_new = _combination_index(new_domain, new_idcs[:, Jn:])

    signs = np.ones(len(tags))
    parity_signs = _parity_signs(sym, codomain, domain, moves, moves_key)
    if parity_signs is not None:
        f, table = parity_signs
        factor = sym.factors[f]
        col = slice(sym.sector_slices[f], sym.sector_slices[f + 1])
        bits = np.zeros(len(tags), int)
        for t, leg in enumerate(all_flat):
            odd = factor._parity(leg.sector_decomposition[tags[:, t], col])[:, 0]
            bits += np.asarray(odd, int) << t
        signs = table[bits]
        assert np.all(np.abs(signs) == 1)

    def shapes(cod, dom):
        return {(i, j): (int(cod.multiplicities[i]), int(dom.multiplicities[j]))
                for i, j in _common_sectors(cod, dom).items()}

    return AbelianPlan(
        old_keys=np.stack([cc[pc], dc[pd]], axis=1),
        old_starts=np.stack([co[pc], do[pd]], axis=1),
        new_keys=np.stack([ncc[r_new], ndc[c_new]], axis=1),
        new_starts=np.stack([nco[r_new], ndo[c_new]], axis=1),
        mult_shapes=np.stack([leg.multiplicities[tags[:, t]]
                              for t, leg in enumerate(all_flat)], axis=1),
        signs=signs, axis_perm=tuple(new_tags), n_codomain=(J, Jn),
        old_shapes=shapes(codomain, domain), new_shapes=shapes(new_codomain, new_domain))


@dataclass(frozen=True, eq=False)
class AbelianProgram:
    """An :class:`AbelianPlan` on the blocks a tensor has: the new blocks' elements,
    concatenated in ``new_keys`` order, are ``signs * flat[index]`` with ``flat`` the
    old blocks of ``present`` concatenated (each row-major) and a zero at its end."""

    index: np.ndarray
    signs: np.ndarray | None  # None: every sign is +1
    new_keys: tuple
    new_shapes: tuple


@functools.lru_cache(maxsize=1024)
def abelian_program(plan: AbelianPlan, present: tuple) -> AbelianProgram:
    """Compile an :class:`AbelianPlan` for the old blocks ``present`` (sorted keys)."""
    old_base = {}
    pos = 0
    for key in present:
        old_base[key] = pos
        h, w = plan.old_shapes[key]
        pos += h * w
    zero = pos
    live = np.array([tuple(k) in old_base for k in plan.old_keys.tolist()], bool)
    new_keys = sorted({tuple(k) for k in plan.new_keys[live].tolist()})
    new_base = {}
    pos = 0
    for key in new_keys:
        new_base[key] = pos
        h, w = plan.new_shapes[key]
        pos += h * w
    index = np.full(pos, zero, np.int64)
    signs = np.ones(pos)
    J_old, J_new = plan.n_codomain
    rows = np.flatnonzero(live)
    if len(rows):
        shapes, group = np.unique(plan.mult_shapes[rows], axis=0, return_inverse=True)
        group = group.reshape(-1)
        for g, m in enumerate(shapes):
            sel = rows[group == g]
            m = tuple(int(x) for x in m)
            P = prod(m)
            old_local = np.arange(P).reshape(m).transpose(plan.axis_perm).reshape(-1)
            mp = tuple(m[a] for a in plan.axis_perm)
            ok = [tuple(k) for k in plan.old_keys[sel].tolist()]
            nk = [tuple(k) for k in plan.new_keys[sel].tolist()]
            ob = np.array([old_base[k] for k in ok])
            op = np.array([plan.old_shapes[k][1] for k in ok])
            nb = np.array([new_base[k] for k in nk])
            npitch = np.array([plan.new_shapes[k][1] for k in nk])
            w_old = prod(m[J_old:])
            w_new = prod(mp[J_new:])
            o_rows = plan.old_starts[sel, 0][:, None] + (old_local // w_old)[None, :]
            o_cols = plan.old_starts[sel, 1][:, None] + (old_local % w_old)[None, :]
            k = np.arange(P)
            n_rows = plan.new_starts[sel, 0][:, None] + (k // w_new)[None, :]
            n_cols = plan.new_starts[sel, 1][:, None] + (k % w_new)[None, :]
            dst = nb[:, None] + n_rows * npitch[:, None] + n_cols
            index[dst] = ob[:, None] + o_rows * op[:, None] + o_cols
            signs[dst] = plan.signs[sel][:, None]
    return AbelianProgram(index=index, signs=None if np.all(signs == 1) else signs,
                          new_keys=tuple(new_keys),
                          new_shapes=tuple(plan.new_shapes[k] for k in new_keys))
