"""Download and extraction helpers; counterpart of comic_tpu/utils/io.py
(reference common/utils.py:33-160: streaming download, tar/zip
extraction). A network fetch happens only when the caller passes
``allow_download=True``; everything else works on local files."""

from __future__ import annotations

import os
import shutil
import tarfile
import urllib.request
import zipfile
from typing import Optional


def maybe_download(url: str, dest_path: str, *,
                   allow_download: bool = False) -> Optional[str]:
    """Fetch ``url`` to ``dest_path`` unless it already exists. Returns the
    path, or None when downloading is off and the file is absent."""
    if os.path.exists(dest_path):
        return dest_path
    if not allow_download:
        return None
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    tmp = dest_path + ".part"
    with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f)
    os.replace(tmp, dest_path)
    return dest_path


def extract_archive(path: str, out_dir: Optional[str] = None) -> str:
    """Extract a .tar[.gz|.bz2] or .zip archive; returns the output
    directory."""
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            z.extractall(out_dir)
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            # filter='data' rejects path-traversal, absolute and symlink
            # members, and pins the behaviour across Python versions
            t.extractall(out_dir, filter="data")
    else:
        raise ValueError(f"Unknown archive format: {path}")
    return out_dir
