"""Checkpoint / resume for tensor-network states, with ``torch.save`` alone.

The counterpart of ``cyten_tpu/tools/checkpoint.py``, which writes its structure with
``h5py`` and its blocks with orbax; here both go through ``torch.save`` and are read
with ``torch.load(weights_only=True)``, so that loading unpickles nothing but tensors
and plain containers (a file holding any other global raises).

Layout of a checkpoint directory (one per step under :class:`CheckpointManager`,
``step_%08d``):

- ``structure.pt``: the typed-schema tree of the object (``tools.hdf5_io``), with every
  dense block replaced by an ``ArrayRef`` node; its numpy arrays as tensors, its
  complex numbers as ``{'__ckpt__': 'complex', ...}`` nodes.
- ``arrays.pt``: the blocks, a list of host tensors in ``ArrayRef`` order, each with a
  compact storage of its own (a block that is a view into a larger buffer, as the
  outputs of a replayed static step are, is saved as its elements alone).

A directory is written under a temporary name and renamed when complete, so a reader
never sees half of one.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil

import numpy as np

__all__ = ['save_checkpoint', 'load_checkpoint', 'wait_for_saves',
           'CheckpointManager']

_STEP = re.compile(r'step_(\d{8})')

#: the writer of async saves: one thread, so saves and deletions land in order
_WRITER = None
_PENDING: list = []  # futures of queued writes and deletions


def _writer():
    global _WRITER
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='checkpoint')
    return _WRITER


def _encode(node):
    """The structure tree in types ``torch.load(weights_only=True)`` accepts."""
    import torch

    if isinstance(node, dict):
        return {k: _encode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_encode(v) for v in node]
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node, copy=True))
    if isinstance(node, np.generic):
        node = node.item()
    if isinstance(node, complex):
        return {'__ckpt__': 'complex', 're': node.real, 'im': node.imag}
    return node


def _decode(node):
    """Inverse of :func:`_encode`."""
    import torch

    if isinstance(node, dict):
        if node.get('__ckpt__') == 'complex':
            return complex(node['re'], node['im'])
        return {k: _decode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v) for v in node]
    if isinstance(node, torch.Tensor):
        return node.numpy()
    return node


def _snapshot(blocks: list) -> list:
    """Host copies of ``blocks``, each a compact storage of its own. A block on the
    card is copied into fresh pinned memory on its stream (queued, not waited for:
    the caller synchronizes before reading); one on the CPU is cloned."""
    import torch

    res = []
    for b in blocks:
        b = b.detach()
        if b.is_cuda:
            host = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
            host.copy_(b, non_blocking=True)
        else:
            host = b.clone(memory_format=torch.contiguous_format)
        res.append(host)
    return res


def _write(path: str, tree, arrays: list, ready=None):
    """Write one checkpoint directory under a temporary name, then rename it to
    ``path`` (replacing an older one). ``ready``: a CUDA event the host copies of
    ``arrays`` wait for."""
    import torch

    if ready is not None:
        ready.synchronize()
    tmp = f'{path}.tmp-{os.getpid()}'
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, 'structure.pt'))
    torch.save(arrays, os.path.join(tmp, 'arrays.pt'))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(path: str, obj, async_save: bool = False):
    """Save an object tree (tensors / MPS / dicts / lists) to ``path``.

    The structure (legs, backends, labels) is the typed-schema tree; the blocks are
    copied to the host at once (into pinned memory for blocks on the card; the copy
    of a block is taken before this returns, so the caller may go on changing its
    tensors). With ``async_save=True`` the files are written on a background thread
    once the copies have landed: call :func:`wait_for_saves` before relying on the
    files, e.g. before the process exits.
    """
    import torch

    from . import hdf5_io

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blocks = []

    def hook(block):
        blocks.append(block)
        return {'__type__': 'ArrayRef', 'index': len(blocks) - 1}

    old = hdf5_io._BLOCK_LEAF_HOOK
    hdf5_io._BLOCK_LEAF_HOOK = hook
    try:
        tree = _encode(hdf5_io.to_tree(obj))
    finally:
        hdf5_io._BLOCK_LEAF_HOOK = old
    arrays = _snapshot(blocks)
    ready = None
    if any(b.is_cuda for b in blocks):
        ready = torch.cuda.Event()
        ready.record()
    if async_save:
        _PENDING.append(_writer().submit(_write, path, tree, arrays, ready))
    else:
        _write(path, tree, arrays, ready)


def wait_for_saves():
    """Block until all in-flight ``async_save`` checkpoints are fully written (and
    raise the first error of a write)."""
    while _PENDING:
        _PENDING.pop(0).result()


def load_checkpoint(path: str, *, device=None):
    """Inverse of :func:`save_checkpoint`: blocks read on the host, then moved onto
    the torch block backend of ``device`` (default: the CUDA card)."""
    import torch

    from . import hdf5_io

    path = os.path.abspath(path)
    tree = _decode(torch.load(os.path.join(path, 'structure.pt'), weights_only=True))
    arrays = torch.load(os.path.join(path, 'arrays.pt'), weights_only=True)

    old = hdf5_io._BLOCK_RESOLVE_HOOK
    hdf5_io._BLOCK_RESOLVE_HOOK = lambda i: arrays[i]
    try:
        return hdf5_io.from_tree(tree, device=device)
    finally:
        hdf5_io._BLOCK_RESOLVE_HOOK = old


class CheckpointManager:
    """Rolling checkpoints for iterative algorithms (DMRG sweeps etc.): one
    directory ``step_%08d`` per saved step, at most ``max_to_keep`` of them."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._steps: list[int] = self._on_disk()

    def _on_disk(self) -> list[int]:
        """The complete steps in the directory, ascending (a directory still under
        its temporary name is not one)."""
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP.fullmatch(name)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step:08d}')

    def save(self, step: int, obj):
        path = self._path(step)
        save_checkpoint(path, obj, async_save=self.async_save)
        if step in self._steps:
            self._steps.remove(step)
        self._steps.append(step)
        while len(self._steps) > self.max_to_keep:
            old = self._path(self._steps.pop(0))
            if self.async_save:  # after the writes queued before it
                _PENDING.append(_writer().submit(shutil.rmtree, old, True))
            else:
                shutil.rmtree(old, ignore_errors=True)
        return path

    def latest_step(self) -> int | None:
        """The newest complete step on disk, or queued by this manager's
        ``async_save`` (:meth:`restore` waits for it)."""
        steps = self._on_disk() + self._steps
        return max(steps) if steps else None

    def restore(self, step: int = None, *, device=None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError('no checkpoints found')
        if self.async_save:
            wait_for_saves()
        return load_checkpoint(self._path(step), device=device)
