"""Host-side plan construction for block-sparse contractions (pure python).

The counterpart of ``cyten_tpu/_native.py``'s pure-python ``compose_plan``. Loading
the C++ ``_core`` extension is left to a later slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ['compose_plan']


def compose_plan(a_contr: np.ndarray, a_keep: np.ndarray, b_contr: np.ndarray,
                 b_keep: np.ndarray):
    """GEMM-pair enumeration for block-sparse compose.

    Parameters are merged int64 keys per block (contracted columns / kept columns).
    Returns ``(ia, ib, out_id, n_out)``: for each pair, the a-block index, b-block
    index and the output-block id (numbered by first appearance).
    """
    groups: dict[int, list[int]] = {}
    for i, k in enumerate(np.asarray(a_contr, dtype=np.int64)):
        groups.setdefault(int(k), []).append(i)
    a_keep = np.asarray(a_keep, dtype=np.int64)
    b_keep = np.asarray(b_keep, dtype=np.int64)
    ia, ib, out_id = [], [], []
    out_ids: dict[tuple, int] = {}
    for j, k in enumerate(np.asarray(b_contr, dtype=np.int64)):
        for i in groups.get(int(k), ()):
            key = (int(a_keep[i]), int(b_keep[j]))
            oid = out_ids.setdefault(key, len(out_ids))
            ia.append(i)
            ib.append(j)
            out_id.append(oid)
    return (np.array(ia, np.int64), np.array(ib, np.int64),
            np.array(out_id, np.int64), len(out_ids))
