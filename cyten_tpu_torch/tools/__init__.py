"""Host-side utilities."""

from . import misc
