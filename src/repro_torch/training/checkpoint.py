"""Atomic checkpointing with an optional async writer
(``repro/training/checkpoint.py``'s layout, so each package reads the
other's params checkpoints).

Layout: ``<dir>/step_<N>/manifest.json`` + ``arrays/<i>.npy`` (one per leaf,
in the tree's flatten order, named by its path as
``jax.tree_util.tree_flatten_with_path`` names it: ``['params']/['embed']``,
``['opt']/.m/...``).  Write protocol: write into ``<dir>/.tmp_step_<N>``,
then ``os.rename``, so a crash mid-save never corrupts the latest
checkpoint.  The async mode copies the leaves to the host first, then hands
them to a writer thread, so training resumes while the files are written.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core import tree as _tree

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "CheckpointManager"]


def save_checkpoint(directory: str, step: int, tree, extra: Optional[dict] = None,
                    async_write: bool = False) -> Optional[threading.Thread]:
    os.makedirs(directory, exist_ok=True)
    named = _tree.leaves_with_names(tree)
    names = [n for n, _ in named]
    host_leaves = [x.detach().cpu().numpy() for _, x in named]  # copy to the host now

    def _write():
        tmp = os.path.join(directory, f".tmp_step_{step:08d}")
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "arrays"))
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (name, arr) in enumerate(zip(names, host_leaves)):
            np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
            manifest["leaves"].append(
                {"i": i, "name": name, "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.exists(os.path.join(directory, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, template,
                    sharding_fn: Optional[Callable[[str, np.ndarray], Any]] = None):
    """Restore a tree shaped like ``template``.  Each leaf takes its
    template leaf's dtype and device; ``sharding_fn(name, arr) -> tensor |
    None`` lets the caller place a leaf itself (the reference's
    ``sharding_fn`` hook).  Returns ``(tree, extra)``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named = _tree.leaves_with_names(template)
    if len(named) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"template {len(named)}")
    by_name = {l["name"]: l for l in manifest["leaves"]}
    out = []
    for name, tmpl in named:
        rec = by_name[name]
        arr = np.load(os.path.join(path, "arrays", f"{rec['i']}.npy"))
        placed = sharding_fn(name, arr) if sharding_fn else None
        if placed is None:  # np.array keeps a 0-d leaf 0-d (ascontiguousarray would not)
            placed = torch.from_numpy(np.array(arr, order="C")).to(device=tmpl.device,
                                                                    dtype=tmpl.dtype)
        out.append(placed)
    return _tree.unflatten(template, out), manifest["extra"]


class CheckpointManager:
    """keep_n retention + resume + async writes."""

    def __init__(self, directory: str, keep_n: int = 3, async_write: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        self._pending = save_checkpoint(
            self.directory, step, tree, extra, async_write=self.async_write)
        if not self.async_write:
            self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory) if d.startswith("step_"))
        for s in steps[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, template, sharding_fn=None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = load_checkpoint(self.directory, step, template, sharding_fn)
        return step, tree, extra
