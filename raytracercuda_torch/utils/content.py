"""Locate and stage the reference's Content meshes (counterpart of
`raytracercuda_tpu/utils/content.py`).

The benchmark meshes (suzanne.obj, f16.obj with BMP textures, bunny.zip)
ship with the reference repository, not with this one.  They are looked
for under ``$RAYTRACER_CONTENT``, then under ``content/`` at the root of
this repository; zipped meshes are extracted into ``.content_cache/``
there (git-ignored).
"""

from __future__ import annotations

import os
import zipfile

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")

CONTENT_DIRS = [
    os.environ.get("RAYTRACER_CONTENT", ""),
    os.path.join(_ROOT, "content"),
]

_CACHE = os.path.join(_ROOT, ".content_cache")


def content_dir() -> str | None:
    for d in CONTENT_DIRS:
        if d and os.path.isdir(d):
            return d
    return None


def find(name: str) -> str | None:
    """Path to a content file; extracts ``<stem>.zip`` into the cache when
    only the zip exists (bunny ships zipped)."""
    d = content_dir()
    if d is None:
        return None
    direct = os.path.join(d, name)
    if os.path.exists(direct):
        return direct
    cached = os.path.join(_CACHE, name)
    if os.path.exists(cached):
        return cached
    stem = os.path.splitext(name)[0]
    z = os.path.join(d, stem + ".zip")
    if os.path.exists(z):
        os.makedirs(_CACHE, exist_ok=True)
        with zipfile.ZipFile(z) as zf:
            zf.extractall(_CACHE)
        if os.path.exists(cached):
            return cached
        # Some zips nest the file; search.
        for root, _, files in os.walk(_CACHE):
            if name in files:
                return os.path.join(root, name)
    return None
