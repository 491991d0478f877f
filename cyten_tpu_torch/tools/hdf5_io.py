"""HDF5 / pickle persistence through a typed schema.

The counterpart of ``cyten_tpu/tools/hdf5_io.py``, with the same tree layout key for
key: every supported object maps to a dict tree of scalars and numpy arrays with a
``'__type__'`` tag, and loading dispatches on the tag through an explicit registry, so
that no code is run on load. A tree, or an ``.h5`` file, that either package writes
loads in the other to the same blocks.

Blocks become numpy arrays in the tree, copied from their device to the host (bf16
blocks as float32, exactly; numpy has no bf16). On load they go onto the torch block
backend of ``device=`` (default: the CUDA card, which raises without one), whatever
block backend the tree names: ``cyten_tpu``'s ``'numpy'``, ``'jax'`` and ``'torch'``
hold the same numbers. The port writes ``'torch'``.

``h5py`` is imported inside the functions that read or write ``.h5`` files only.
"""

from __future__ import annotations

import contextlib
import gzip
import pickle

import numpy as np

from ..dtypes import Dtype

__all__ = ['Hdf5Exportable', 'Hdf5Ignored', 'Hdf5FormatError', 'Hdf5ExportError',
           'Hdf5ImportError', 'save_to_hdf5', 'load_from_hdf5',
           'valid_hdf5_path_component', 'find_global', 'save', 'load', 'save_hdf5',
           'load_hdf5', 'to_tree', 'from_tree', 'Hdf5Saver', 'Hdf5Loader',
           'register_tree_type', 'save_tree_hdf5', 'load_tree_hdf5']


# --- object <-> dict-tree schema ----------------------------------------------------------

#: optional hooks used by tools.checkpoint to keep dense blocks OUT of the typed
#: structure tree (they are stored beside it; the tree holds ArrayRef nodes)
_BLOCK_LEAF_HOOK = None
_BLOCK_RESOLVE_HOOK = None

#: registry for additional composite types (e.g. SimpleMPS): name -> (cls, to_fn, from_fn)
_TREE_TYPES: dict = {}

#: block backends a tree may name: each loads onto the port's torch backend
_BLOCK_BACKEND_NAMES = ('torch', 'numpy', 'jax')

_ACTIVE_DEVICE: list = []  # stack: the device= of the outermost from_tree call


def register_tree_type(name: str, cls, to_fn, from_fn):
    """Register a composite type for the typed to_tree/from_tree schema.

    ``to_fn(obj) -> dict`` of already-supported values; ``from_fn(dict) -> obj``
    receives the dict with values still in tree form (call :func:`from_tree` on
    them as needed).
    """
    _TREE_TYPES[name] = (cls, to_fn, from_fn)


def _block_to_numpy(block) -> np.ndarray:
    """A host copy of a block (torch or numpy); bf16 as float32, exactly."""
    import torch

    if isinstance(block, torch.Tensor):
        block = block.detach().resolve_conj()
        if block.dtype == torch.bfloat16:
            block = block.float()
        return block.cpu().numpy().copy()
    return np.asarray(block)


def _leaf(block):
    """Convert a dense block for the tree (hookable; see tools.checkpoint)."""
    if _BLOCK_LEAF_HOOK is not None:
        ref = _BLOCK_LEAF_HOOK(block)
        if ref is not None:
            return ref
    return _block_to_numpy(block)


def _unleaf(node):
    """Inverse of :func:`_leaf`: resolve ArrayRef nodes through the restore hook."""
    if isinstance(node, dict) and node.get('__type__') == 'ArrayRef':
        return _BLOCK_RESOLVE_HOOK(int(node['index']))
    return node if hasattr(node, 'shape') else np.asarray(node)


class _SaveContext:
    """Identity memo for :func:`to_tree` (shared-object + cycle support).

    The first encounter of a shareable object allocates an id and every occurrence
    becomes a ``Ref`` node pointing into a ``shared`` table; entries referenced only
    once are inlined again before writing, so acyclic single-owner saves keep the
    plain layout.
    """

    def __init__(self):
        self.memo: dict = {}      # id(obj) -> (ref_id, obj)  (obj pins id())
        self.shared: dict = {}    # ref_id -> tree node
        self.next_id = 0


_ACTIVE_SAVE_CTX: list = []  # stack; lets registered to_fns nest to_tree calls
_ACTIVE_LOAD_CTX: list = []  # stack of _LoadContext for nested from_tree calls


def to_tree(obj):
    """Convert a supported object into a nested dict of plain data (+ type tags).

    Objects referenced more than once (e.g. an MPS whose sites share one
    ``ElementarySpace``) are stored once in a ``Graph`` node's ``shared`` table and
    referenced by ``Ref`` nodes; reference cycles through lists and dicts are
    supported. Trees without sharing are returned in the plain (un-wrapped) layout.
    """
    if _ACTIVE_SAVE_CTX:
        # nested call (a registered to_fn recursing): share the outer memo so
        # cross-references between siblings still deduplicate
        return _to_tree(obj, _ACTIVE_SAVE_CTX[-1])
    ctx = _SaveContext()
    _ACTIVE_SAVE_CTX.append(ctx)
    try:
        root = _to_tree(obj, ctx)
    finally:
        _ACTIVE_SAVE_CTX.pop()
    _inline_single_refs(root, ctx)
    if not ctx.shared:
        return root
    return {'__type__': 'Graph', 'root': root,
            'shared': {str(i): t for i, t in ctx.shared.items()}}


def _collect_refs(node, out):
    if isinstance(node, dict):
        if node.get('__type__') == 'Ref':
            out.append(int(node['id']))
            return
        for v in node.values():
            _collect_refs(v, out)
    elif isinstance(node, list):
        for v in node:
            _collect_refs(v, out)


def _inline_single_refs(root, ctx):
    """Splice shared-table entries used exactly once back into their use site
    (in place), so sharing costs nothing when there is none. An entry that is
    part of a cycle is reachable from itself and therefore counted >= 2."""
    counts: dict = {}
    refs: list = []
    _collect_refs(root, refs)
    for t in ctx.shared.values():
        _collect_refs(t, refs)
    for i in refs:
        counts[i] = counts.get(i, 0) + 1

    def splice(node):
        if isinstance(node, dict):
            if node.get('__type__') == 'Ref':
                i = int(node['id'])
                if counts.get(i) == 1:
                    entry = ctx.shared.pop(i)
                    node.clear()
                    node.update(entry)
                    splice(node)  # the entry may itself contain single refs
                return
            for v in node.values():
                splice(v)
        elif isinstance(node, list):
            for v in node:
                splice(v)

    splice(root)
    for t in list(ctx.shared.values()):
        splice(t)


def _memoized(obj, ctx, build):
    """Return a Ref node for `obj`, building its table entry on first visit.

    The (empty) entry dict is registered BEFORE ``build`` fills it, so cycles
    terminate: re-encountering `obj` while its entry is being built simply
    yields another Ref to the same id."""
    key = id(obj)
    hit = ctx.memo.get(key)
    if hit is not None:
        return {'__type__': 'Ref', 'id': hit[0]}
    n = ctx.next_id
    ctx.next_id += 1
    ctx.memo[key] = (n, obj)
    entry: dict = {}
    ctx.shared[n] = entry
    entry.update(build())
    return {'__type__': 'Ref', 'id': n}


def _to_tree(obj, ctx):
    from ..backends.data import BlockSparseData, DenseData, DiagonalBlockData, \
        MaskBlockData
    from ..symmetries import (
        AbelianLegPipe, ElementarySpace, LegPipe, Symmetry, TensorProduct,
    )
    from ..tensors import ChargedTensor, DiagonalTensor, Mask, SymmetricTensor

    if obj is None or isinstance(obj, (bool, int, float, complex, str)):
        return obj
    if isinstance(obj, (np.integer, np.floating, np.complexfloating)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, Dtype):
        return {'__type__': 'Dtype', 'name': obj.name}
    if isinstance(obj, list):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'list', 'items': [_to_tree(x, ctx) for x in obj]})
    if isinstance(obj, tuple):
        return {'__type__': 'tuple', 'items': [_to_tree(x, ctx) for x in obj]}
    if isinstance(obj, dict):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'dict',
            'keys': [_to_tree(k, ctx) for k in obj.keys()],
            'values': [_to_tree(v, ctx) for v in obj.values()]})
    if isinstance(obj, Symmetry):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'Symmetry', 'config': _to_tree(obj.to_config(), ctx)})
    if isinstance(obj, AbelianLegPipe):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'AbelianLegPipe',
            'legs': [_to_tree(l, ctx) for l in obj.legs],
            'is_dual': obj.is_dual, 'combine_cstyle': obj.combine_cstyle})
    if isinstance(obj, LegPipe):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'LegPipe',
            'legs': [_to_tree(l, ctx) for l in obj.legs],
            'is_dual': obj.is_dual, 'combine_cstyle': obj.combine_cstyle})
    if isinstance(obj, ElementarySpace):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'ElementarySpace',
            'symmetry': _to_tree(obj.symmetry, ctx),
            'defining_sectors': obj.defining_sectors,
            'multiplicities': obj.multiplicities,
            'is_dual': obj.is_dual,
            'basis_perm': obj._basis_perm})
    if isinstance(obj, TensorProduct):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'TensorProduct',
            'symmetry': _to_tree(obj.symmetry, ctx),
            'factors': [_to_tree(f, ctx) for f in obj.factors]})
    if isinstance(obj, (DenseData, BlockSparseData, DiagonalBlockData,
                        MaskBlockData)):
        tree = {'__type__': type(obj).__name__}
        if isinstance(obj, DenseData):
            tree['block'] = _leaf(obj.block)
            tree['dtype'] = _to_tree(obj.dtype, ctx)
        else:
            tree['blocks'] = [_leaf(b) for b in obj.blocks]
            tree['block_inds'] = np.asarray(obj.block_inds)
            if not isinstance(obj, MaskBlockData):
                tree['dtype'] = _to_tree(obj.dtype, ctx)
        return tree
    if isinstance(obj, Mask):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'Mask', 'data': _to_tree(obj.data, ctx),
            'space_in': _to_tree(obj.domain.factors[0], ctx),
            'space_out': _to_tree(obj.codomain.factors[0], ctx),
            'is_projection': obj.is_projection,
            'backend': obj.backend.block_backend.name,
            'labels': _to_tree(obj.labels, ctx)})
    if isinstance(obj, DiagonalTensor):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'DiagonalTensor', 'data': _to_tree(obj.data, ctx),
            'leg': _to_tree(obj.leg, ctx),
            'backend': obj.backend.block_backend.name,
            'labels': _to_tree(obj.labels, ctx)})
    if isinstance(obj, ChargedTensor):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'ChargedTensor',
            'invariant_part': _to_tree(obj.invariant_part, ctx),
            'charged_state': None if obj.charged_state is None
            else _block_to_numpy(obj.charged_state)})
    if isinstance(obj, SymmetricTensor):
        return _memoized(obj, ctx, lambda: {
            '__type__': 'SymmetricTensor', 'data': _to_tree(obj.data, ctx),
            'codomain': _to_tree(obj.codomain, ctx),
            'domain': _to_tree(obj.domain, ctx),
            'backend': obj.backend.block_backend.name,
            'labels': _to_tree(obj.labels, ctx)})
    # registered composite types (SimpleMPS etc.)
    for name, (cls, to_fn, _) in _TREE_TYPES.items():
        if isinstance(obj, cls):
            def build(name=name, to_fn=to_fn):
                tree = {k: _to_tree(v, ctx) for k, v in to_fn(obj).items()}
                tree['__type__'] = name
                return tree
            return _memoized(obj, ctx, build)
    # fallback: objects exposing to_tree/from_tree
    if hasattr(obj, 'to_tree'):
        tree = obj.to_tree()
        tree['__type__'] = type(obj).__name__
        return tree
    raise TypeError(f'cannot serialize {type(obj).__name__}')


class _LoadContext:
    """Resolves ``Ref`` nodes against a ``Graph`` node's shared table.

    Resolution is on-demand and order-independent (the table entry is built the
    first time any Ref to it is resolved); identity is restored: every Ref with the
    same id yields the *same* Python object. Cycles are supported through mutable
    containers (lists/dicts are registered before their items are filled)."""

    def __init__(self, shared: dict):
        self.shared = {int(k): v for k, v in shared.items()}
        self.memo: dict = {}
        self.building: set = set()

    def resolve(self, i: int):
        i = int(i)
        if i in self.memo:
            return self.memo[i]
        if i not in self.shared:
            raise Hdf5ImportError(f'dangling Ref id {i}')
        entry = self.shared[i]
        t = entry.get('__type__') if isinstance(entry, dict) else None
        if t == 'list':
            obj: list = []
            self.memo[i] = obj  # pre-register: cycles through lists work
            obj.extend(from_tree(x) for x in entry['items'])
            return obj
        if t == 'dict':
            obj_d: dict = {}
            self.memo[i] = obj_d
            for k, v in zip(entry['keys'], entry['values']):
                obj_d[from_tree(k)] = from_tree(v)
            return obj_d
        if i in self.building:
            raise Hdf5ImportError(
                f'reference cycle through an immutable node (id {i}, type '
                f'{t!r}): only cycles through lists/dicts are supported')
        self.building.add(i)
        try:
            obj = from_tree(entry)
        finally:
            self.building.discard(i)
        self.memo[i] = obj
        return obj


@contextlib.contextmanager
def _on_device(device):
    """Load the tensors of the enclosed :func:`from_tree` calls onto ``device``
    (None: the enclosing call's, else the default device)."""
    if device is None:
        yield
        return
    _ACTIVE_DEVICE.append(device)
    try:
        yield
    finally:
        _ACTIVE_DEVICE.pop()


def _backend_for(symmetry, name):
    """The port's tensor backend for a tree's block-backend ``name``, on the device
    of the loading call."""
    from ..backends import get_backend

    name = str(name)
    if name not in _BLOCK_BACKEND_NAMES:
        raise Hdf5ImportError(f'unknown block backend {name!r} in the tree')
    return get_backend(symmetry, 'torch',
                       device=_ACTIVE_DEVICE[-1] if _ACTIVE_DEVICE else None)


def from_tree(tree, *, device=None):
    """Inverse of :func:`to_tree` (transparently resolves ``Graph``/``Ref`` nodes,
    restoring shared-object identity).

    Tensors go onto the torch block backend of ``device`` (default: the CUDA card,
    which raises without one), whatever block backend the tree names.
    """
    with _on_device(device):
        return _from_tree(tree)


def _from_tree(tree):
    from ..backends.data import BlockSparseData, DenseData, DiagonalBlockData, \
        MaskBlockData
    from ..symmetries import (
        AbelianLegPipe, ElementarySpace, LegPipe, Symmetry, TensorProduct,
    )
    from ..tensors import ChargedTensor, DiagonalTensor, Mask, SymmetricTensor

    if tree is None or isinstance(tree, (bool, int, float, complex, str,
                                         np.ndarray)):
        return tree
    assert isinstance(tree, dict), f'unexpected node: {tree!r}'
    t = tree.get('__type__')
    if t == 'Graph':
        ctx = _LoadContext(tree['shared'])
        _ACTIVE_LOAD_CTX.append(ctx)
        try:
            return from_tree(tree['root'])
        finally:
            _ACTIVE_LOAD_CTX.pop()
    if t == 'Ref':
        if not _ACTIVE_LOAD_CTX:
            raise Hdf5ImportError('Ref node outside a Graph')
        return _ACTIVE_LOAD_CTX[-1].resolve(tree['id'])
    if t == 'Dtype':
        return Dtype[tree['name']]
    if t == 'list':
        return [from_tree(x) for x in tree['items']]
    if t == 'tuple':
        return tuple(from_tree(x) for x in tree['items'])
    if t == 'dict':
        return {from_tree(k): from_tree(v)
                for k, v in zip(tree['keys'], tree['values'])}
    if t == 'Symmetry':
        return Symmetry.from_config(from_tree(tree['config']))
    if t == 'ElementarySpace':
        return ElementarySpace(from_tree(tree['symmetry']),
                               np.asarray(tree['defining_sectors'], int),
                               np.asarray(tree['multiplicities'], int),
                               is_dual=bool(tree['is_dual']),
                               basis_perm=tree['basis_perm'])
    if t == 'AbelianLegPipe':
        return AbelianLegPipe([from_tree(l) for l in tree['legs']],
                              is_dual=bool(tree['is_dual']),
                              combine_cstyle=bool(tree['combine_cstyle']))
    if t == 'LegPipe':
        return LegPipe([from_tree(l) for l in tree['legs']],
                       is_dual=bool(tree['is_dual']),
                       combine_cstyle=bool(tree['combine_cstyle']))
    if t == 'TensorProduct':
        return TensorProduct([from_tree(f) for f in tree['factors']],
                             symmetry=from_tree(tree['symmetry']))
    if t == 'DenseData':
        dtype = from_tree(tree['dtype'])
        return DenseData(_unleaf(tree['block']), dtype)
    if t in ('BlockSparseData', 'DiagonalBlockData'):
        cls = BlockSparseData if t == 'BlockSparseData' else DiagonalBlockData
        return cls([_unleaf(b) for b in tree['blocks']],
                   np.asarray(tree['block_inds']), from_tree(tree['dtype']),
                   is_sorted=True)
    if t == 'MaskBlockData':
        return MaskBlockData([_unleaf(b) for b in tree['blocks']],
                             np.asarray(tree['block_inds']), is_sorted=True)
    if t == 'SymmetricTensor':
        codomain = from_tree(tree['codomain'])
        domain = from_tree(tree['domain'])
        backend = _backend_for(codomain.symmetry, tree['backend'])
        data = _restore_blocks(from_tree(tree['data']), backend)
        return SymmetricTensor(data, codomain, domain, backend,
                               from_tree(tree['labels']))
    if t == 'DiagonalTensor':
        leg = from_tree(tree['leg'])
        backend = _backend_for(leg.symmetry, tree['backend'])
        data = _restore_blocks(from_tree(tree['data']), backend)
        return DiagonalTensor(data, leg, backend, from_tree(tree['labels']))
    if t == 'Mask':
        space_in = from_tree(tree['space_in'])
        space_out = from_tree(tree['space_out'])
        backend = _backend_for(space_in.symmetry, tree['backend'])
        data = _restore_blocks(from_tree(tree['data']), backend)
        return Mask(data, space_in=space_in, space_out=space_out,
                    is_projection=bool(tree['is_projection']), backend=backend,
                    labels=from_tree(tree['labels']))
    if t == 'ChargedTensor':
        inv = from_tree(tree['invariant_part'])
        state = tree['charged_state']
        return ChargedTensor(inv, None if state is None
                             else _as_block(inv.backend.block_backend, state))
    if t in _TREE_TYPES:
        return _TREE_TYPES[t][2](tree)
    raise TypeError(f'cannot deserialize node of type {t!r}')


def _as_block(bb, block, dtype: Dtype = None):
    """``block`` (numpy, or a host torch tensor) as a block of ``bb``. A numpy bf16
    array (``cyten_tpu``'s jax blocks, through ml_dtypes) is reinterpreted bit for bit."""
    if isinstance(block, np.ndarray) and block.dtype.name == 'bfloat16':
        import torch

        block = torch.from_numpy(np.ascontiguousarray(block).view(np.uint16).copy()
                                 ).view(torch.bfloat16)
    return bb.as_block(block, dtype)


def _restore_blocks(data, backend):
    """Move the loaded blocks onto the backend's block backend (and device)."""
    from ..backends.data import DenseData, MaskBlockData

    bb = backend.block_backend
    if isinstance(data, DenseData):
        return DenseData(_as_block(bb, data.block, data.dtype), data.dtype)
    if isinstance(data, MaskBlockData):
        return MaskBlockData([_as_block(bb, b, Dtype.bool) for b in data.blocks],
                             data.block_inds, is_sorted=True)
    blocks = [_as_block(bb, b, data.dtype) for b in data.blocks]
    return type(data)(blocks, data.block_inds, data.dtype, is_sorted=True)


# --- HDF5 encoding of dict trees -----------------------------------------------------------


class Hdf5Saver:
    """Write dict trees (from :func:`to_tree`) into an h5py group."""

    def __init__(self, h5group):
        self.h5group = h5group

    def save(self, obj, path: str = '/'):
        self._write(self.h5group, path.strip('/') or 'root', to_tree(obj))

    def _write(self, grp, name, node):
        if node is None:
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'none'
        elif isinstance(node, (bool, np.bool_)):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'bool'
            g.attrs['value'] = bool(node)
        elif isinstance(node, (int, float, np.integer, np.floating)):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'scalar'
            g.attrs['value'] = node
        elif isinstance(node, complex):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'complex'
            g.attrs['real'] = node.real
            g.attrs['imag'] = node.imag
        elif isinstance(node, str):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'str'
            g.attrs['value'] = node
        elif isinstance(node, np.ndarray):
            ds = grp.create_dataset(name, data=node)
            ds.attrs['__kind__'] = 'array'
        elif isinstance(node, dict):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'node'
            for k, v in node.items():
                if isinstance(v, list):
                    sub = g.create_group(k)
                    sub.attrs['__kind__'] = 'seq'
                    for j, item in enumerate(v):
                        self._write(sub, str(j), item)
                else:
                    self._write(g, k, v)
        elif isinstance(node, list):
            g = grp.create_group(name)
            g.attrs['__kind__'] = 'seq'
            for j, item in enumerate(node):
                self._write(g, str(j), item)
        else:
            raise TypeError(f'cannot write {type(node)}')


class Hdf5Loader:
    """Read dict trees written by :class:`Hdf5Saver` and rebuild objects."""

    def __init__(self, h5group):
        self.h5group = h5group

    def load(self, path: str = '/'):
        name = path.strip('/') or 'root'
        return from_tree(self._read(self.h5group[name]))

    def _read(self, node):
        import h5py

        if isinstance(node, h5py.Dataset):
            return np.asarray(node)
        kind = node.attrs.get('__kind__')
        if kind == 'none':
            return None
        if kind == 'bool':
            return bool(node.attrs['value'])
        if kind == 'scalar':
            v = node.attrs['value']
            return v.item() if hasattr(v, 'item') else v
        if kind == 'complex':
            return complex(node.attrs['real'], node.attrs['imag'])
        if kind == 'str':
            return str(node.attrs['value'])
        if kind == 'seq':
            return [self._read(node[str(j)]) for j in range(len(node))]
        # generic node
        res = {}
        for k in node:
            res[k] = self._read(node[k])
        for k, v in node.attrs.items():
            if k != '__kind__' and k not in res:
                res[k] = v
        return res


def save_hdf5(obj, filename: str, path: str = '/'):
    import h5py

    with h5py.File(filename, 'w') as f:
        Hdf5Saver(f).save(obj, path)


def load_hdf5(filename: str, path: str = '/', *, device=None):
    """The object :func:`save_hdf5` wrote, its tensors on ``device`` (default: the
    CUDA card)."""
    import h5py

    with h5py.File(filename, 'r') as f, _on_device(device):
        return Hdf5Loader(f).load(path)


def save_tree_hdf5(tree, filename: str, path: str = '/'):
    """Write an already-converted dict tree (see :func:`to_tree`) to HDF5."""
    import h5py

    with h5py.File(filename, 'w') as f:
        Hdf5Saver(f)._write(f, path.strip('/') or 'root', tree)


def load_tree_hdf5(filename: str, path: str = '/'):
    """Read the raw dict tree back (inverse of :func:`save_tree_hdf5`)."""
    import h5py

    with h5py.File(filename, 'r') as f:
        return Hdf5Loader(f)._read(f[path.strip('/') or 'root'])


# --- the original cyten's hdf5 wire format -------------------------------------------------
# The port's own files use the '__kind__' typed schema above; these constants name the
# format of the library cyten_tpu was modelled on, which cyten_tpu's
# tools.reference_import reads and tools.reference_export writes (not ported).

REPR_IGNORED = 'ignore'
REPR_HDF5EXPORTABLE = 'instance'
REPR_REDUCE = 'reduce'
REPR_ARRAY = 'array'
REPR_MASKED_ARRAY = 'masked_array'
REPR_INT = 'int'
REPR_INT_AS_STR = 'int_as_str'
REPR_FLOAT = 'float'
REPR_STR = 'str'
REPR_BYTES = 'bytes'
REPR_COMPLEX = 'complex'
REPR_INT64 = 'np.int64'
REPR_FLOAT64 = 'np.float64'
REPR_COMPLEX128 = 'np.complex128'
REPR_INT32 = 'np.int32'
REPR_FLOAT32 = 'np.float32'
REPR_COMPLEX64 = 'np.complex64'
REPR_BOOL = 'bool'
REPR_NONE = 'None'
REPR_RANGE = 'range'
REPR_LIST = 'list'
REPR_TUPLE = 'tuple'
REPR_SET = 'set'
REPR_DICT_GENERAL = 'dict'
REPR_DICT_SIMPLE = 'simple_dict'
REPR_DTYPE = 'dtype'
REPR_FUNCTION = 'function'
REPR_CLASS = 'class'
REPR_GLOBAL = 'global'

#: (python type, type repr) pairs that format stores directly as h5 datasets
TYPES_FOR_HDF5_DATASETS = (
    (np.ndarray, REPR_ARRAY), (int, REPR_INT), (float, REPR_FLOAT),
    (str, REPR_STR), (bytes, REPR_BYTES), (complex, REPR_COMPLEX),
    (np.int64, REPR_INT64), (np.float64, REPR_FLOAT64),
    (np.complex128, REPR_COMPLEX128), (np.int32, REPR_INT32),
    (np.float32, REPR_FLOAT32), (np.complex64, REPR_COMPLEX64),
    (np.bool_, REPR_BOOL), (bool, REPR_BOOL),
)


class Hdf5Ignored:
    """Placeholder for a dataset/group ignored during both loading and saving.

    Instances are skipped by savers; loaders return an instance for any saved node
    whose type attribute is :data:`REPR_IGNORED`.
    """

    def __init__(self, name: str = '(unknown)'):
        self.name = name

    def __repr__(self):
        return f'Hdf5Ignored({self.name!r})'


ATTR_TYPE = 'type'      #: attribute holding one of the ``REPR_*`` strings
ATTR_CLASS = 'class'    #: attribute holding the class name of an instance
ATTR_MODULE = 'module'  #: attribute holding the module of ``ATTR_CLASS``
ATTR_LEN = 'len'        #: attribute holding the length of iterables
ATTR_FORMAT = 'format'  #: attribute indicating the ``ATTR_TYPE`` format


class Hdf5FormatError(Exception):
    """Common base for errors regarding the HDF5 format."""


class Hdf5ExportError(Hdf5FormatError):
    """Raised when an object cannot be written."""


class Hdf5ImportError(Hdf5FormatError):
    """Raised when a file cannot be read back."""


def valid_hdf5_path_component(name: str) -> bool:
    """Whether ``name`` is a valid path component in HDF5."""
    return name != '.' and name != '..' and '/' not in name


def find_global(module: str, qualified_name: str):
    """Resolve a global object by module and (dotted) qualified name."""
    import importlib

    obj = importlib.import_module(module)
    for part in qualified_name.split('.'):
        obj = getattr(obj, part)
    return obj


def save_to_hdf5(h5group, obj, path: str = '/'):
    """Write ``obj`` into an already-open h5py group, in the typed schema."""
    try:
        Hdf5Saver(h5group).save(obj, path)
    except TypeError as e:
        raise Hdf5ExportError(str(e)) from e


def load_from_hdf5(h5group, path: str = None, *, device=None):
    """Read from an already-open h5py group, tensors onto ``device``.

    The typed schema (``'__kind__'`` attributes) loads directly. A group in the
    original cyten's own format (``'type'`` attributes), which ``cyten_tpu`` reads
    through its ``tools/reference_import.py``, raises :class:`Hdf5ImportError`: that
    module is not ported.
    """
    path = '/' if path is None else path
    name = path.strip('/') or 'root'
    # the saver writes a subgroup named `name` with a '__kind__' attribute; files of
    # the original format mark the group at `path` itself with a 'type' attribute
    if name in h5group and '__kind__' in h5group[name].attrs:
        try:
            with _on_device(device):
                return Hdf5Loader(h5group).load(path)
        except KeyError as e:
            raise Hdf5ImportError(str(e)) from e
    probe = h5group[path] if path.strip('/') and path in h5group else h5group
    if 'type' in probe.attrs:
        raise Hdf5ImportError(
            f"{path!r} holds the original cyten format ('type' attributes); reading "
            'it needs tools/reference_import.py, which cyten_tpu_torch does not port')
    raise Hdf5ImportError(f'no recognizable object at {path!r}: neither the '
                          "'__kind__' schema nor the original 'type' format")


def save(obj, filename: str):
    """Save to .h5/.hdf5 (typed schema) or .pkl/.pklz (the pickled tree)."""
    if filename.endswith(('.h5', '.hdf5')):
        save_hdf5(obj, filename)
    elif filename.endswith('.pklz'):
        with gzip.open(filename, 'wb') as f:
            pickle.dump(to_tree(obj), f)
    elif filename.endswith('.pkl'):
        with open(filename, 'wb') as f:
            pickle.dump(to_tree(obj), f)
    else:
        raise ValueError(f'unknown file extension: {filename}')


def load(filename: str, *, device=None):
    """Inverse of :func:`save`, tensors onto ``device`` (default: the CUDA card).
    A ``.pkl``/``.pklz`` file is unpickled: load only files you trust."""
    if filename.endswith(('.h5', '.hdf5')):
        return load_hdf5(filename, device=device)
    if filename.endswith('.pklz'):
        with gzip.open(filename, 'rb') as f:
            return from_tree(pickle.load(f), device=device)
    if filename.endswith('.pkl'):
        with open(filename, 'rb') as f:
            return from_tree(pickle.load(f), device=device)
    raise ValueError(f'unknown file extension: {filename}')


class Hdf5Exportable:
    """Mixin providing per-class HDF5 hooks ``save_hdf5``/``from_hdf5``, which
    delegate to the typed schema (:func:`to_tree`/:func:`from_tree`)."""

    def save_hdf5(self, hdf5_saver, h5gr, subpath: str = 'obj'):
        hdf5_saver._write(h5gr, subpath.strip('/') or 'obj', to_tree(self))

    @classmethod
    def from_hdf5(cls, hdf5_loader, h5gr, subpath: str = 'obj'):
        obj = from_tree(hdf5_loader._read(h5gr[subpath.strip('/') or 'obj']))
        if not isinstance(obj, cls):
            raise TypeError(f'loaded {type(obj).__name__}, expected {cls.__name__}')
        return obj


def _install_hdf5_hooks():
    """Attach ``save_hdf5``/``from_hdf5`` to all persistable classes.

    Called once at package-init time (after all modules are loaded, avoiding
    circular imports).
    """
    from ..backends.data import BlockSparseData, DenseData, DiagonalBlockData, \
        MaskBlockData
    from ..symmetries import ElementarySpace, LegPipe, TensorProduct
    from ..symmetries.core import Symmetry
    from ..tensors import Tensor

    for cls in (Symmetry, ElementarySpace, LegPipe, TensorProduct, Tensor,
                DenseData, BlockSparseData, DiagonalBlockData, MaskBlockData):
        if 'save_hdf5' not in cls.__dict__:
            cls.save_hdf5 = Hdf5Exportable.save_hdf5
        if 'from_hdf5' not in cls.__dict__:
            cls.from_hdf5 = classmethod(Hdf5Exportable.from_hdf5.__func__)
