"""Filesystem layer (port of ``dalle_mtf_tpu/data/fs.py``): local paths and
remote URLs (gs://, s3://, memory://, file://) through fsspec.

``open_file`` returns a buffered file object for any URL, with the
sequential-read hints of a record scan; ``list_files`` globs local patterns
and URLs alike. The native reader (``data/native.py``) stays the local fast
path; remote shards stream through the Python record reader over an fsspec
file. The memory:// filesystem makes the remote path testable offline: the
code path is gs://'s but for fsspec's backend.

``exists``, ``listdir``, ``remove`` and ``remove_tree`` are the few calls a
model directory needs (the trainer's checkpoints and their retention, the
metrics writer, ``--new``), on a local path or a URL.
"""

from __future__ import annotations

import glob as globlib
import os
import shutil


def is_remote(path) -> bool:
    """True for URL-style paths that need fsspec (gs://, s3://, memory://,
    file://); plain paths and Windows drive letters are local. (The JAX
    package's test takes letters alone, so s3:// counts as a local path
    there.)"""
    if not isinstance(path, str):
        return False
    head, sep, _ = path.partition("://")
    return bool(sep) and len(head) > 1 and head.isalnum() and head[0].isalpha()


def _fs(path: str):
    """(fsspec filesystem, path without its protocol) of a URL."""
    import fsspec  # noqa: PLC0415

    fs, _, (p,) = fsspec.get_fs_token_paths(path)
    return fs, p


def _remote_read_hints() -> tuple[str, int]:
    """(cache_type, block_size) for sequential remote scans, from
    DALLE_TPU_GCS_CACHE (default "readahead") and DALLE_TPU_GCS_BLOCK_MB
    (default 16): the multi-MB windows tf.data's GCS reader used (reference
    input_fns.py:85-104)."""
    cache = os.environ.get("DALLE_TPU_GCS_CACHE", "readahead")
    block_mb = int(os.environ.get("DALLE_TPU_GCS_BLOCK_MB", "16"))
    return cache, max(1, block_mb) << 20


def open_file(path: str, mode: str = "rb", *,
              cache_type: str | None = None, block_size: int | None = None):
    """Open a local path or a URL. A remote read is buffered in large
    blocks fetched ahead of the cursor (``cache_type`` and ``block_size``
    override the environment's hints); a backend that takes no such
    arguments opens with its defaults."""
    if not is_remote(path):
        return open(path, mode)
    import fsspec  # noqa: PLC0415

    if "r" in mode:
        env_cache, env_block = _remote_read_hints()
        try:
            return fsspec.open(path, mode, cache_type=cache_type or env_cache,
                               block_size=block_size or env_block).open()
        except TypeError:
            pass
    return fsspec.open(path, mode).open()


def list_files(pattern: str) -> list[str]:
    """Sorted paths matching a glob pattern, local or remote (URLs keep
    their protocol)."""
    if is_remote(pattern):
        import fsspec  # noqa: PLC0415

        fs, _, paths = fsspec.get_fs_token_paths(pattern)
        return sorted(fs.unstrip_protocol(p) for p in paths)
    return sorted(globlib.glob(pattern, recursive=True))


def makedirs(path: str) -> None:
    if is_remote(path):
        fs, p = _fs(path)
        fs.makedirs(p, exist_ok=True)
        return
    os.makedirs(path, exist_ok=True)


def join(path: str, *names: str) -> str:
    """``path``/``names``: ``os.path.join`` locally, a '/' join on a URL."""
    if is_remote(path):
        return "/".join([path.rstrip("/"), *names])
    return os.path.join(path, *names)


def exists(path: str) -> bool:
    if is_remote(path):
        fs, p = _fs(path)
        return fs.exists(p)
    return os.path.exists(path)


def listdir(path: str) -> list[str]:
    """The names in directory ``path`` ([] where it does not exist)."""
    if is_remote(path):
        fs, p = _fs(path)
        if not fs.isdir(p):
            return []
        return [os.path.basename(f.rstrip("/")) for f in fs.ls(p, detail=False)]
    return os.listdir(path) if os.path.isdir(path) else []


def move(src: str, dst: str) -> None:
    """Rename file ``src`` to ``dst`` (on one filesystem), replacing it."""
    if is_remote(src):
        fs, p = _fs(src)
        fs.mv(p, _fs(dst)[1])
        return
    os.replace(src, dst)


def remove(path: str) -> None:
    """Delete the file ``path``."""
    if is_remote(path):
        fs, p = _fs(path)
        fs.rm(p)
        return
    os.unlink(path)


def remove_tree(path: str) -> None:
    """Delete directory ``path`` and all under it, if it exists."""
    if is_remote(path):
        fs, p = _fs(path)
        if fs.exists(p):
            fs.rm(p, recursive=True)
        return
    if os.path.isdir(path):
        shutil.rmtree(path)
