# SPDX-License-Identifier: CECILL-2.1
"""Lazy array leaves (the port's own copy of ``barc4dip_tpu/utils/lazy.py``):
a map is computed and pulled to the host only when someone reads it.

The stats dicts carry per-frame autocorrelation maps (reference
metrics/speckles.py:474-476, :590-593) that most consumers never read; at
2048^2 each is 16 MB. These wrappers keep the contract (the map keys exist
and behave like arrays) while non-consumers pay nothing: materialization
happens on first element access / ``np.asarray`` and is cached.

Semantics: indexing a :class:`LazyMapStack` with an integer materializes one
frame; any other NumPy interaction (``np.asarray``, ufuncs, arithmetic,
reductions) materializes the full array once and reuses it afterwards.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["LazyMap", "LazyMapStack"]


class _LazyArrayBase:
    """Array-duck base: shape/dtype metadata now, values on demand."""

    _shape: tuple
    _dtype: np.dtype

    @property
    def shape(self) -> tuple:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def size(self) -> int:
        return int(np.prod(self._shape)) if self._shape else 1

    def __len__(self) -> int:
        if not self._shape:
            raise TypeError("len() of unsized object")
        return int(self._shape[0])

    # -- materialization ---------------------------------------------------
    def materialize(self) -> np.ndarray:
        raise NotImplementedError

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        if dtype is not None and arr.dtype != np.dtype(dtype):
            arr = arr.astype(dtype)
        if copy:
            arr = arr.copy()
        return arr

    def astype(self, dtype) -> np.ndarray:
        return self.materialize().astype(dtype)

    # -- arithmetic / comparisons materialize ------------------------------
    def _bin(self, other, op):
        return op(self.materialize(), other)

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._bin(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._bin(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._bin(o, lambda a, b: b / a)

    def __floordiv__(self, o):
        return self._bin(o, lambda a, b: a // b)

    def __rfloordiv__(self, o):
        return self._bin(o, lambda a, b: b // a)

    def __pow__(self, o):
        return self._bin(o, lambda a, b: a**b)

    def __rpow__(self, o):
        return self._bin(o, lambda a, b: b**a)

    def __mod__(self, o):
        return self._bin(o, lambda a, b: a % b)

    def __matmul__(self, o):
        return self._bin(o, lambda a, b: a @ b)

    def __rmatmul__(self, o):
        return self._bin(o, lambda a, b: b @ a)

    def __and__(self, o):
        return self._bin(o, lambda a, b: a & b)

    def __rand__(self, o):
        return self._bin(o, lambda a, b: b & a)

    def __or__(self, o):
        return self._bin(o, lambda a, b: a | b)

    def __ror__(self, o):
        return self._bin(o, lambda a, b: b | a)

    def __xor__(self, o):
        return self._bin(o, lambda a, b: a ^ b)

    def __neg__(self):
        return -self.materialize()

    def __pos__(self):
        return +self.materialize()

    def __abs__(self):
        return abs(self.materialize())

    def __invert__(self):
        return ~self.materialize()

    def __float__(self):
        return float(self.materialize())

    # elementwise comparisons, ndarray-style
    def __eq__(self, o):  # noqa: E721
        return self.materialize() == o

    def __ne__(self, o):
        return self.materialize() != o

    def __lt__(self, o):
        return self.materialize() < o

    def __le__(self, o):
        return self.materialize() <= o

    def __gt__(self, o):
        return self.materialize() > o

    def __ge__(self, o):
        return self.materialize() >= o

    __hash__ = None  # type: ignore[assignment]

    # -- common reductions --------------------------------------------------
    def min(self, *a, **k):
        return self.materialize().min(*a, **k)

    def max(self, *a, **k):
        return self.materialize().max(*a, **k)

    def mean(self, *a, **k):
        return self.materialize().mean(*a, **k)

    def sum(self, *a, **k):
        return self.materialize().sum(*a, **k)

    def std(self, *a, **k):
        return self.materialize().std(*a, **k)

    def copy(self) -> np.ndarray:
        return self.materialize().copy()

    def __repr__(self) -> str:
        state = "materialized" if self._is_ready() else "deferred"
        return (
            f"<{type(self).__name__} shape={self._shape} dtype={self._dtype} "
            f"({state})>"
        )

    def _is_ready(self) -> bool:
        return False


class LazyMap(_LazyArrayBase):
    """A single deferred 2D map backed by a zero-argument fetch thunk
    (typically: pull the device-resident half map and mirror it)."""

    def __init__(self, shape: tuple, dtype, fetch: Callable[[], np.ndarray]):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        self._fetch = fetch
        self._value: np.ndarray | None = None

    def materialize(self) -> np.ndarray:
        if self._value is None:
            arr = np.asarray(self._fetch())
            if arr.shape != self._shape:
                raise RuntimeError(
                    f"lazy map fetch returned {arr.shape}, expected {self._shape}"
                )
            self._value = arr
            self._fetch = None  # release the device reference / closure
        return self._value

    def __getitem__(self, key):
        return self.materialize()[key]

    def _is_ready(self) -> bool:
        return self._value is not None


class LazyMapStack(_LazyArrayBase):
    """A deferred (T, N0, N1) stack of per-frame maps.

    ``fetch_frame(t)`` produces one (N0, N1) map — e.g. re-derive the frame's
    autocorrelation on device from the source stack and pull only that map.
    Integer indexing materializes single frames (cached); everything else
    materializes the whole stack.
    """

    def __init__(
        self,
        n_frames: int,
        map_shape: tuple,
        dtype,
        fetch_frame: Callable[[int], np.ndarray],
    ):
        self._shape = (int(n_frames),) + tuple(int(s) for s in map_shape)
        self._dtype = np.dtype(dtype)
        self._fetch_frame = fetch_frame
        self._frames: dict[int, np.ndarray] = {}
        self._full: np.ndarray | None = None

    def _frame(self, t: int) -> np.ndarray:
        t = int(t)
        if t < 0:
            t += self._shape[0]
        if not 0 <= t < self._shape[0]:
            raise IndexError(
                f"frame index {t} out of range for {self._shape[0]} frames"
            )
        if self._full is not None:
            return self._full[t]
        if t not in self._frames:
            arr = np.asarray(self._fetch_frame(t))
            if arr.shape != self._shape[1:]:
                raise RuntimeError(
                    f"lazy frame fetch returned {arr.shape}, "
                    f"expected {self._shape[1:]}"
                )
            self._frames[t] = arr
        return self._frames[t]

    def materialize(self) -> np.ndarray:
        if self._full is None:
            self._full = np.stack(
                [self._frame(t) for t in range(self._shape[0])]
            )
            self._frames.clear()
        return self._full

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self._frame(key)
        if isinstance(key, tuple) and key and isinstance(key[0], (int, np.integer)):
            frame = self._frame(key[0])
            return frame[key[1:]] if len(key) > 1 else frame
        return self.materialize()[key]

    def __iter__(self):
        return (self._frame(t) for t in range(self._shape[0]))

    def _is_ready(self) -> bool:
        return self._full is not None
