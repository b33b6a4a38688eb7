# SPDX-License-Identifier: CECILL-2.1
"""Chunk-level checkpoint/resume for long stack runs (the port's own copy
of ``barc4dip_tpu/utils/checkpoint.py``).

Every completed chunk of a stack pipeline can be persisted as a flat .npz
keyed by tree path, tagged with a configuration hash; re-running the same
call skips completed chunks and resumes at the first missing one. The
port's stack pipeline saves under its own tag, so it never resumes chunks
the JAX package wrote.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

__all__ = ["config_hash", "ChunkStore"]


def config_hash(config: dict) -> str:
    """Stable short hash of a JSON-serialisable configuration dict."""
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


_SEP = "||"  # metric keys may contain "/" (e.g. "grain/lx"), "||" is safe


#: key for a bare-array chunk (no dict structure): without a sentinel the
#: round trip would come back as {'': array} instead of the array itself
_LEAF_KEY = "__leaf__"


def _flatten(tree, prefix="") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    else:
        key = prefix[: -len(_SEP)] if prefix else _LEAF_KEY
        out[key] = np.asarray(tree)
    return out


#: npz entry recording whether the chunk was a bare array or a dict — an
#: explicit marker, so a real dict {'__leaf__': arr} round-trips as a dict
#: instead of collapsing to the bare array
_KIND_KEY = "__chunkstore_kind__"


def _unflatten(flat: dict[str, np.ndarray], kind: str):
    if kind == "leaf":
        return flat[_LEAF_KEY]
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


class ChunkStore:
    """Persist per-chunk pytrees under ``dir/tag_<hash>_chunk<start>.npz``."""

    def __init__(self, directory: str | Path, tag: str, config: dict):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.prefix = f"{tag}_{config_hash(config)}"

    def _path(self, chunk_start: int) -> Path:
        return self.dir / f"{self.prefix}_chunk{chunk_start:08d}.npz"

    def has(self, chunk_start: int) -> bool:
        return self._path(chunk_start).exists()

    def save(self, chunk_start: int, tree) -> None:
        flat = _flatten(tree)
        if _KIND_KEY in flat:
            raise ValueError(
                f"tree key {_KIND_KEY!r} is reserved by ChunkStore"
            )
        flat[_KIND_KEY] = np.array(
            "leaf" if not isinstance(tree, dict) else "dict"
        )
        tmp = self._path(chunk_start).with_suffix(".tmp.npz")
        np.savez_compressed(tmp, **flat)
        tmp.rename(self._path(chunk_start))

    def load(self, chunk_start: int):
        with np.load(self._path(chunk_start)) as data:
            flat = {k: data[k] for k in data.files}
        if _KIND_KEY in flat:
            kind = str(flat.pop(_KIND_KEY))
        else:  # chunk written before the marker existed: old heuristic
            kind = "leaf" if set(flat) == {_LEAF_KEY} else "dict"
        return _unflatten(flat, kind)
