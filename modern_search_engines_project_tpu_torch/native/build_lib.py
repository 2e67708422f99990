"""Build one of the package's C++ libraries with g++ at first use.

The library goes to ``<checkout>/build/native/<hash of source and
flags>/``, so an edited source gets a new library; concurrent builds
each write a private file and rename it into place.  A failed build raises
with g++'s output: no caller falls back to a Python route silently.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"


def library_path(root: Path, src: Path, lib_name: str,
                 flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return root / h.hexdigest()[:16] / lib_name


def build(root: Path, src: Path, lib_name: str, flags: Sequence[str],
          what: str) -> Path:
    """Compile ``src`` unless its library exists; raises ``RuntimeError``
    with g++'s output, headed by ``what``, when the build fails."""
    so = library_path(root, src, lib_name, flags)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{os.getpid()}.{threading.get_ident()}.{lib_name}")
    cmd = ["g++", *flags, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ at all
        raise RuntimeError(f"{what}: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what}: g++ failed ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so
