"""Decoded-image cache: one-time PNG/JPG decode to raw .npy, mmap reads after.

Counterpart of `structure_knowledge_distillation_tpu/data/cache.py`, with the
same cache-file names, so the two packages share a cache directory. A 2-MP
Cityscapes frame costs tens of milliseconds of PNG decode on one host core;
the reference hid that behind 4 DataLoader worker processes (reference
train_and_eval.py:13-15). With a cache, each file is decoded ONCE into a raw
uint8 .npy and every later epoch reads it back as a zero-copy memory map.

Cache layout: <cache_dir>/<sha1(abspath)[:16]>_<basename>.npy, written
atomically (tmp + rename) so concurrent processes can share a cache dir.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
from typing import Callable, Optional

import numpy as np

__all__ = ["cached_decode", "warm_cache"]


def _cache_path(cache_dir: str, path: str) -> str:
    digest = hashlib.sha1(osp.abspath(path).encode()).hexdigest()[:16]
    stem = osp.splitext(osp.basename(path))[0]
    return osp.join(cache_dir, f"{digest}_{stem}.npy")


def cached_decode(path: str, reader: Callable[[str], np.ndarray],
                  cache_dir: Optional[str]) -> np.ndarray:
    """reader(path) with a write-once .npy cache; mmap'd reads thereafter."""
    if not cache_dir:
        return reader(path)
    cpath = _cache_path(cache_dir, path)
    if osp.exists(cpath):
        return np.load(cpath, mmap_mode="r")
    arr = reader(path)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{cpath[:-len('.npy')]}.tmp{os.getpid()}.npy"  # np.save appends .npy
    np.save(tmp, arr)
    os.replace(tmp, cpath)
    return arr


def warm_cache(dataset) -> int:
    """Pre-decode every unique record of a cache-enabled dataset; returns the
    number of records read."""
    seen = set()
    for i, rec in enumerate(dataset.records):
        if rec.img not in seen:
            seen.add(rec.img)
            dataset[i]
    return len(seen)
