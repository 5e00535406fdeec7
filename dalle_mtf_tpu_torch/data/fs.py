"""Filesystem layer (the local-path half of ``dalle_mtf_tpu/data/fs.py``).

Remote URLs (gs://, s3://, memory:// through fsspec) are not ported yet and
raise; local paths and globs behave as in the JAX package.
"""

from __future__ import annotations

import glob as globlib


def is_remote(path) -> bool:
    """True for URL-style paths (gs://, s3://, memory://...)."""
    if not isinstance(path, str):
        return False
    head, sep, _ = path.partition("://")
    return bool(sep) and head.isalpha() and len(head) > 1


def _refuse_remote(path) -> None:
    if is_remote(path):
        raise NotImplementedError(f"remote paths are not ported yet: {path}")


def open_file(path: str, mode: str = "rb"):
    """Open a local path."""
    _refuse_remote(path)
    return open(path, mode)


def list_files(pattern: str) -> list[str]:
    """Sorted local paths matching a glob pattern."""
    _refuse_remote(pattern)
    return sorted(globlib.glob(pattern, recursive=True))
