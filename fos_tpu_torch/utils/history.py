"""Keyed iteration history.

Python-side replacement for ValueHistories.MVHistory (reference
src/types.jl:51 and the ``savedata`` sites, HSDEStatus.jl:125-139): the
chunked engine appends one row per convergence check; ``debug >= 2``
additionally stores full iterates.
"""

from __future__ import annotations

import numpy as np


class History:
    def __init__(self):
        self._iters = {}
        self._values = {}

    def push(self, key: str, i: int, value):
        self._iters.setdefault(key, []).append(int(i))
        self._values.setdefault(key, []).append(value)

    def keys(self):
        return list(self._values.keys())

    def get(self, key: str):
        vals = self._values[key]
        try:
            vals = np.asarray(vals)
        except Exception:
            pass
        return np.asarray(self._iters[key]), vals

    def last(self, key: str):
        return self._values[key][-1]

    def __contains__(self, key):
        return key in self._values

    def __len__(self):
        return max((len(v) for v in self._values.values()), default=0)
