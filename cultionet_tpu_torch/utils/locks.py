"""File locking for concurrent raster writes (port of
cultionet_tpu/utils/locks.py): an fcntl advisory lock usable across
processes on one host."""

import contextlib
import fcntl
import os
import typing as T
from pathlib import Path


@contextlib.contextmanager
def file_lock(path: T.Union[str, Path]):
    """Exclusive advisory lock on ``<path>.lock`` (blocks until acquired)."""
    lock_path = Path(str(path) + ".lock")
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
