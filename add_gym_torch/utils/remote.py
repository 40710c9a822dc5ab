"""Checkpoint transfer for ``gs://``, ``s3://`` and ``file://`` URIs.

Counterpart of ``add_gym_tpu/utils/remote.py``.  Checkpoints are
directories, so transfers are recursive.  ``file://`` makes the round trip
testable without cloud credentials; ``gs://`` and ``s3://`` call whichever
of ``gcloud storage`` / ``gsutil`` / ``aws`` is installed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile


def is_remote(uri: str | None) -> bool:
    return bool(uri) and uri.startswith(("gs://", "s3://", "file://"))


def _run(cmd):
    subprocess.run(cmd, check=True)


def _gs_copy(src: str, dst: str):
    """Recursive copy through whichever GCS command-line tool exists."""
    if shutil.which("gcloud"):
        _run(["gcloud", "storage", "cp", "-r", src, dst])
    elif shutil.which("gsutil"):
        _run(["gsutil", "-m", "cp", "-r", src, dst])
    else:
        raise RuntimeError("no gcloud/gsutil on PATH for gs:// transfer")


def _s3_copy(src: str, dst: str):
    if not shutil.which("aws"):
        raise RuntimeError("no aws CLI on PATH for s3:// transfer")
    _run(["aws", "s3", "cp", "--recursive", src, dst])


def fetch_dir(uri: str, cache_dir: str | None = None) -> str:
    """A checkpoint URI as a local directory path.

    Local paths pass through; remote URIs are copied into ``cache_dir``
    (default ``agt_checkpoints`` under the temporary directory) and the
    local copy's path is returned.
    """
    if not is_remote(uri):
        return os.path.abspath(uri)
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(), "agt_checkpoints")
    name = uri.rstrip("/").rsplit("/", 1)[-1]
    dest = os.path.join(cache_dir, name)
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.makedirs(cache_dir, exist_ok=True)
    if uri.startswith("file://"):
        shutil.copytree(uri[len("file://"):], dest)
    elif uri.startswith("gs://"):
        _gs_copy(uri, dest)
    else:
        _s3_copy(uri, dest)
    print(f"Fetched checkpoint {uri} -> {dest}")
    return dest


def push_dir(local_dir: str, uri: str) -> None:
    """Upload a local directory to a ``gs://``, ``s3://`` or ``file://`` URI."""
    local_dir = os.path.abspath(local_dir)
    if uri.startswith("file://"):
        dest = uri[len("file://"):]
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(local_dir, dest)
    elif uri.startswith("gs://"):
        _gs_copy(local_dir, uri)
    elif uri.startswith("s3://"):
        _s3_copy(local_dir, uri)
    else:
        raise ValueError(f"unsupported destination URI: {uri}")
    print(f"Pushed {local_dir} -> {uri}")
