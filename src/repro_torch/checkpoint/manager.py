"""Fault-tolerant checkpointing, in the reference's on-disk layout.

Counterpart of the reference's ``checkpoint/manager.py``; a checkpoint
written by either package restores into the other:

* ``step_%08d/proc<k>.npz`` with ``meta<k>.json``, each leaf under the
  ``"/"``-joined keys of its tree path (``params/blocks/mamba/in_proj``);
* atomic: written to ``step_<N>.tmp<k>`` and renamed once complete, so a
  killed writer never corrupts the latest restore point;
* asynchronous: :meth:`CheckpointManager.save_async` takes its snapshot to
  host memory before it returns and writes on a background thread, one
  outstanding save at a time;
* self-pruning: keeps the newest ``keep`` checkpoints.

A tree is nested dicts whose leaves are torch tensors (copied to the host)
or numpy arrays.  One process writes ``proc0`` unless told otherwise.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``{"a/b/c": array}`` with every leaf copied to the host."""
    flat = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        flat["/".join(path)] = np.array(leaf)
    return flat


def _shape(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: Optional[int] = None):
        self.dir = directory
        self.keep = keep
        self.proc = 0 if process_index is None else process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ io
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               meta: Dict[str, Any]):
        final = self._step_dir(step)
        tmp = final + f".tmp{self.proc}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"proc{self.proc}.npz"), **flat)
        with open(os.path.join(tmp, f"meta{self.proc}.json"), "w") as f:
            json.dump(meta, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        try:
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(final, ignore_errors=True)  # concurrent writer
            os.rename(tmp, final)
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------- public
    def save(self, step: int, tree, meta: Optional[Dict[str, Any]] = None):
        self.wait()  # never share a tmp dir with an in-flight async save
        self._write(step, _flatten(tree), dict(step=step, **(meta or {})))

    def save_async(self, step: int, tree, meta: Optional[Dict] = None):
        self.wait()  # one outstanding save at a time
        flat = _flatten(tree)  # snapshot on the host before returning
        m = dict(step=step, **(meta or {}))
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, m), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template):
        """The checkpoint of ``step`` as numpy arrays in the structure of
        ``template``: nested dicts whose leaves are arrays, tensors or
        shapes (tuples); each stored shape must match."""
        path = os.path.join(self._step_dir(step), f"proc{self.proc}.npz")
        with np.load(path) as data:
            def fill(node, prefix):
                if isinstance(node, dict):
                    return {k: fill(v, prefix + (str(k),))
                            for k, v in node.items()}
                key = "/".join(prefix)
                arr = data[key]
                if arr.shape != _shape(node):
                    raise ValueError(f"{key}: stored {arr.shape}, template "
                                     f"{_shape(node)}")
                return arr
            return fill(template, ())

    def meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step),
                               f"meta{self.proc}.json")) as f:
            return json.load(f)
