"""Checkpoints with async save: a copy of ``repro/train/checkpoint.py``
for one process and one device.

* **Layout**: a directory a step, ``step_<8 digits>/``, with one
  ``shard_0.npz`` holding every leaf and a ``manifest.json`` (step, time,
  each leaf's shape and dtype, the process index and count, ``extra``, a
  content checksum).  Leaves are keyed by their path in the tree
  (``params/layers/3/attn/wq``, ``opt/m/embed``, ``opt/step``).  A bf16
  leaf is stored as its 16-bit integer view under the dtype name
  ``bfloat16``, as the reference stores ml_dtypes' bfloat16.
* **Async save**: the tree is copied to host memory at once, then
  written on a background thread (``save(blocking=False)``; ``wait``
  joins it and raises what it raised).  ``keep`` newest steps stay.
* **Restore** into the structure, shapes and dtypes of a template, onto
  the template's device, which the caller names (``device=None`` means
  ``cuda``, and raises without a card).  The checksum is verified.
  Elastic resharding onto a mesh (the reference's ``shardings=``) raises
  ``NotImplementedError``: the port has no mesh yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from .._device import resolve_device

SEP = "/"


def flatten_with_paths(tree, prefix: str = "") -> "dict[str, Any]":
    """{path: leaf} of a tree of dicts, lists and NamedTuples (a None
    subtree has no leaves), in the tree's order."""
    flat = {}

    def visit(path, node):
        if node is None:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                visit(f"{path}{SEP}{k}" if path else str(k), v)
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k in node._fields:
                visit(f"{path}{SEP}{k}" if path else k, getattr(node, k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(f"{path}{SEP}{i}" if path else str(i), v)
        else:
            flat[path] = node

    visit(prefix, tree)
    return flat


def unflatten_like(template, flat: "dict[str, Any]", prefix: str = ""):
    """A tree of ``template``'s structure with the leaves of ``flat``."""
    def build(path, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(f"{path}{SEP}{k}" if path else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(f"{path}{SEP}{k}" if path else k,
                                      getattr(node, k))
                                for k in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(f"{path}{SEP}{i}" if path else str(i), v)
                              for i, v in enumerate(node))
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        return flat[path]

    return build(prefix, template)


def _to_host(t: torch.Tensor) -> "tuple[np.ndarray, str]":
    """(numpy array, dtype name): bf16 as its int16 view (numpy has no
    bfloat16)."""
    t = t.detach()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), name
    return t.cpu().numpy(), name


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))
    if dtype_name == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def _checksum(arrays: "dict[str, np.ndarray]") -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:1 << 20])
    return h.hexdigest()[:16]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree, blocking: bool = True,
             extra: dict | None = None) -> str:
        """Snapshot ``tree`` (a TrainState or any tree of tensors) at
        ``step``: copied to host memory now, written now or (``blocking``
        False) on a background thread."""
        host, dtypes = {}, {}
        for k, v in flatten_with_paths(tree).items():
            host[k], dtypes[k] = _to_host(v)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            "process_index": 0,
            "process_count": 1,
            "extra": extra or {},
            "checksum": _checksum(host),
        }
        path = os.path.join(self.dir, f"step_{step:08d}")
        if blocking:
            self._write(path, host, manifest)
        else:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write_safe, args=(path, host, manifest),
                daemon=True)
            self._thread.start()
        return path

    def _write_safe(self, path, host, manifest):
        try:
            self._write(path, host, manifest)
        except Exception as e:  # surfaced on next wait()
            self._error = e

    def _write(self, path, host, manifest):
        os.makedirs(path, exist_ok=True)
        shard = os.path.join(path, f"shard_{manifest['process_index']}.npz")
        tmp = shard + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **host)
        os.replace(tmp, shard)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".tmp", mpath)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def list_steps(self) -> "list[int]":
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, shardings=None,
                verify: bool = True, device=None):
        """Restore into the structure of ``template`` (its shapes and
        dtypes) on ``device`` (``None`` = ``cuda``; every template leaf
        must lie there).  Returns (tree, step)."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto a mesh (elastic resharding) needs the "
                "port's mesh, not ported yet (ROADMAP.md queue 1)")
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        host: "dict[str, np.ndarray]" = {}
        for name in os.listdir(path):
            if name.startswith("shard_") and name.endswith(".npz"):
                with np.load(os.path.join(path, name)) as z:
                    for k in z.files:
                        host[k] = z[k]
        if verify and _checksum(host) != manifest["checksum"]:
            raise IOError(f"checkpoint {path} failed checksum")

        def restore_leaf(key, tleaf):
            if key not in host:
                raise KeyError(f"checkpoint missing leaf {key}")
            if tleaf.device != dev:
                raise ValueError(f"{key}: the template lies on "
                                 f"{tleaf.device}, restoring onto {dev}")
            t = _from_host(host[key], manifest["leaves"][key]["dtype"])
            if tuple(t.shape) != tuple(tleaf.shape):
                raise ValueError(
                    f"{key}: saved {tuple(t.shape)} != expected "
                    f"{tuple(tleaf.shape)}")
            return t.to(device=dev, dtype=tleaf.dtype)

        flat_t = flatten_with_paths(template)
        flat_new = {k: restore_leaf(k, v) for k, v in flat_t.items()}
        return unflatten_like(template, flat_new), manifest["step"]
