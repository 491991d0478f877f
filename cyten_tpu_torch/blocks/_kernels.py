"""Build and bind the hand-written CUDA kernels of ``cyten_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into ``build/cyten_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout, at first use, and loaded with :mod:`ctypes`. The hash of the source
is part of the file name, so an edited source is rebuilt. Nothing is compiled when
the package is imported.

Every wrapper launches through :func:`call`: the ``ctypes`` function is resolved once
(:func:`function`), the entry point makes the tensor's device current only when it
is not (one ``cudaGetDevice`` otherwise), and the stream handle is PyTorch's current
stream of that device. The libraries are loaded as ``ctypes.PyDLL``: an entry point
only checks its arguments and enqueues a launch, so it keeps the interpreter lock
rather than paying to release and take it again around a call of a few
microseconds.

Every wrapper counts its launches through :func:`count`. Inside a CUDA graph
captured by :class:`Graph` a wrapper launches nothing: the launch is recorded, and
each :meth:`Graph.replay` adds the launches the graph holds to the wrappers' counts.
"""

from __future__ import annotations

import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ['build', 'library', 'function', 'call', 'count', 'Graph', 'BUILD_DIR',
           'SOURCE_DIR']

SOURCE_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'cyten_tpu_torch'
NVCC_FLAGS = ['-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

# C signatures, by library name: {symbol: (argtypes, restype)}
_SIGNATURES = {
    'grouped_gemm': {
        'cyten_grouped_gemm': ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
                               ctypes.c_int),
        'cyten_grouped_gemm_info': ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    },
    'probe': {
        'cyten_scale2': ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_void_p], ctypes.c_int),
    },
    'tridiag': {
        'cyten_tridiag_ground_state': ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                                       ctypes.c_int),
        'cyten_tridiag_evolve': ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_double, ctypes.c_double, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                                 ctypes.c_int),
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict = {}  # (library, symbol) -> ctypes function


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((SOURCE_DIR / f'{name}.cu').read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet.

    One ``nvcc`` per source, all started together. Returns the wall seconds of
    each build that ran; raises ``RuntimeError`` with the compiler's output if one
    fails.
    """
    names = list(_SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(SOURCE_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {name}.cu:\n{log}')
        if verbose:
            print(f'[build {name}.cu: {seconds[name]:.1f} s]\n{log.strip()}')
        os.replace(tmp, out)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.PyDLL(str(_lib_path(name)))
        for symbol, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str):
    """The ``ctypes`` function ``symbol`` of library ``name``, resolved once."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = _functions[name, symbol] = getattr(library(name), symbol)
    return fn


def _raw_stream_getter():
    """A function of a device index returning the raw handle of its current stream:
    ``torch._C._cuda_getCurrentRawStream``, the getter Triton's launcher uses, where
    this PyTorch has it (it returns the handle without building a ``Stream``
    object: several microseconds less per launch); else
    ``torch.cuda.current_stream(index).cuda_stream``."""
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    return raw if raw is not None else (lambda i: torch.cuda.current_stream(i).cuda_stream)


_current_stream = _raw_stream_getter()


def call(fn, args: tuple, index: int, label: str) -> None:
    """``fn(*args, index, stream)``: the entry point launches on ``stream``, the
    current stream of CUDA device ``index``, with that device current (it switches
    only if another one is). Raises ``RuntimeError`` if the launch returns a CUDA
    error."""
    err = fn(*args, index, _current_stream(index))
    if err != 0:
        raise RuntimeError(f'{label} launch failed: cudaError {err}')


_capture = None  # the Graph being captured, if any


def count(wrapper, keep=None) -> None:
    """Counts one launch of ``wrapper``'s kernel in ``wrapper.launches``, or, while a
    :class:`Graph` is captured, records it in that graph, which then also keeps
    ``keep`` (host buffers the launch reads) alive for as long as it lives. Raises if
    the current stream is captured by anything but a :class:`Graph`: such a graph
    would neither count its launches nor keep its buffers."""
    if _capture is not None:
        _capture.launches[wrapper] = _capture.launches.get(wrapper, 0) + 1
        if keep is not None:
            _capture.keep.append(keep)
    elif torch.cuda.is_current_stream_capturing():
        raise RuntimeError('a kernel of cyten_tpu_torch was captured outside '
                           'blocks._kernels.Graph')
    else:
        wrapper.launches += 1


def tally(obj, attr: str) -> None:
    """Adds one to the counter ``obj.<attr>``, or, while a :class:`Graph` is captured,
    records it in that graph, whose replays then add it: for host-side work that each
    replay repeats on the device, such as an operand copied before a launch."""
    if _capture is not None:
        _capture.tallies[obj, attr] = _capture.tallies.get((obj, attr), 0) + 1
    else:
        setattr(obj, attr, getattr(obj, attr) + 1)


def keep_alive(obj) -> None:
    """While a :class:`Graph` is captured, makes it keep ``obj`` (a device buffer the
    captured work reads) alive for as long as it lives; else nothing."""
    if _capture is not None:
        _capture.keep.append(obj)


class Graph:
    """A ``torch.cuda.CUDAGraph`` that knows the kernel launches it holds.

    ``with g.capture(): ...`` captures the work queued in the block (on a side
    stream, with ``capture_error_mode='global'``, so a host sync inside fails);
    :meth:`replay` runs it and adds its launches to each wrapper's count, and its
    :func:`tally` counts to theirs. ``pool`` is a ``torch.cuda.graph_pool_handle()``
    shared with other graphs, or None for a private one.
    """

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.launches: dict = {}  # wrapper -> launches per replay
        self.tallies: dict = {}   # (object, counter) -> additions per replay (tally)
        self.keep: list = []      # buffers the graph's copies and kernels read

    @contextmanager
    def capture(self):
        global _capture
        if _capture is not None:
            raise RuntimeError('a Graph is being captured already')
        # no garbage collection inside the capture: it could destroy another graph
        # that has become garbage, which is illegal while a stream is captured
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool, capture_error_mode='global'):
                _capture = self
                try:
                    yield self
                finally:
                    _capture = None
        finally:
            if gc_was_enabled:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        for (obj, attr), n in self.tallies.items():
            setattr(obj, attr, getattr(obj, attr) + n)
