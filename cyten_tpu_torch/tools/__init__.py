"""Host-side utilities: the typed persistence schema (``hdf5_io``), checkpoints
(``checkpoint``), scipy's sparse eigensolvers (``math``), FLOP counts, the interop
specs and the integer and sorting helpers."""

from . import checkpoint, flops, hdf5_io, math, misc
from .hdf5_io import (
    Hdf5ExportError, Hdf5FormatError, Hdf5ImportError, find_global, load,
    load_from_hdf5, load_hdf5, save, save_hdf5, save_to_hdf5,
    valid_hdf5_path_component,
)
from .math import speigs, speigsh
