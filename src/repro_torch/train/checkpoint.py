"""Checkpointing: atomic, retention-managed, resumable, async-capable.

Format (the reference's): one ``step_<N>/`` directory per checkpoint
containing ``arrays.npz`` (the flattened state, path-keyed) and
``manifest.json`` (step, key order, the original dtype of every key, user
metadata).  Writes go to ``.tmp-`` staging and are renamed into place, so
a killed process never leaves a half-written "latest" checkpoint —
restart picks up the previous complete one.

The port's train state is a tree of dicts, lists, the ``AdamWState``
dataclass, tensors and Python ints (``step``, ``base_seed``,
``opt.count``).  Keys join the path with ``/`` (``opt/m/layers/3/...``,
``opt/count``, ``params/layers/3/...``; an ``OptimSpec``'s layout state
``opt/leaves/unit/<j>/mlp/wi/v_row``, the reference's keys); ints are stored
as 0-d int64 and come back as ints.  numpy has no bfloat16, so such leaves are stored as a
byte view (uint8, last dimension doubled; a 0-d leaf as 2 bytes) with
``"bfloat16"`` recorded in the manifest's ``dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
           "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _items(node):
    """(path component, child) pairs of one container of the tree."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if dataclasses.is_dataclass(node):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    raise TypeError(f"not a train-state node: {type(node).__name__}")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, int)) and not isinstance(x, bool)


def _leaves(tree, prefix: str = ""):
    """(key, leaf) of every tensor and int of ``tree``."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _items(tree):
        out.extend(_leaves(child, f"{prefix}/{name}" if prefix else name))
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if _is_leaf(tree):
        return fn(prefix, tree)
    kids = {name: _rebuild(child, fn, f"{prefix}/{name}" if prefix
                           else name)
            for name, child in _items(tree)}
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(kids[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **kids)


def _host_copy(tree):
    """``tree`` with every tensor copied to host memory (a copy even of a
    CPU tensor: the optimizer updates the live state in place)."""
    return _rebuild(tree, lambda _, x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Returns (arrays, dtypes).  Non-native dtypes (bfloat16, float8...)
    are stored as byte views; ``dtypes`` records the original name."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, int):
            flat[key], dtypes[key] = np.asarray(leaf, np.int64), "int64"
            continue
        t = leaf.detach().to("cpu").contiguous()
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if dtypes[key] in _NATIVE:
            flat[key] = t.numpy()
        else:
            flat[key] = t.reshape(t.shape or (1,)).view(torch.uint8).numpy()
    return flat, dtypes


def save(ckpt_dir: str, step: int, tree, metadata: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the newest ``keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()), "dtypes": dtypes,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The manifest of one checkpoint (latest when ``step`` is None)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Versioned run-state record (host-side run state riding the manifest)
# ---------------------------------------------------------------------------
#
# Array state (params, opt, znorm cache, budget_stats) lives in
# arrays.npz; everything host-side a run needs to resume bit-faithfully
# — the scheduled step's controller band positions and budget
# trajectory, plus whatever the caller adds — rides the manifest's
# ``metadata`` under one versioned key, so an old reader confronted with
# a future record fails loudly instead of resuming with silently reset
# controllers.  The record is the reference's, field for field.

RUN_STATE_KEY = "run_state"
# v2: adds the optimizer-state layout record (``optim_layouts``) and the
# rank band positions inside ``schedule_state``; v1 records are still
# readable: every added field has a safe empty default.
RUN_STATE_VERSION = 2
_READABLE_RUN_STATE_VERSIONS = (1, 2)


def pack_run_state(schedule_state: Optional[Dict] = None,
                   **extra) -> Dict:
    """Metadata dict for ``save``: a versioned run-state record.

    ``schedule_state``: the JSON form of a ``ScheduleState``
    (``launch.train_steps.ScheduleState.to_json()``); ``extra`` keys are
    stored alongside it (must be JSON-serializable)."""
    rec = {"version": RUN_STATE_VERSION, **extra}
    if schedule_state is not None:
        rec["schedule_state"] = schedule_state
    return {RUN_STATE_KEY: rec}


def unpack_run_state(manifest: Dict) -> Optional[Dict]:
    """The run-state record of a manifest (``read_manifest`` result), or
    ``None`` when the checkpoint carries none.  Raises on a version this
    reader does not understand."""
    rec = manifest.get("metadata", {}).get(RUN_STATE_KEY)
    if rec is None:
        return None
    v = rec.get("version")
    if v not in _READABLE_RUN_STATE_VERSIONS:
        raise ValueError(
            f"checkpoint run-state record version {v!r} is not one of "
            f"{_READABLE_RUN_STATE_VERSIONS}; refusing to resume from "
            f"an incompatible writer")
    return rec


def restore(ckpt_dir: str, template, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore INTO ``template`` (shapes must match): every tensor leaf of
    the template is overwritten in place (keeping its device and dtype)
    and every int replaced, so a full-size state is never held twice on
    the card.  Returns (the restored tree, step); its containers are new,
    its tensors the template's own."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(key, leaf):
            arr = data[key]
            if isinstance(leaf, int):
                return int(arr)
            saved = dtypes.get(key, arr.dtype.name)
            t = torch.from_numpy(np.array(arr))
            if saved not in _NATIVE:
                t = t.view(getattr(torch, saved))   # last dim shrinks back
                if leaf.dim() == 0 and tuple(t.shape) == (1,):
                    t = t.reshape(())
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint/{key}: shape {tuple(t.shape)} != template "
                    f"{tuple(leaf.shape)}")
            with torch.no_grad():
                leaf.copy_(t)
            return leaf
        return _rebuild(template, load), step


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next training steps.

    ``save`` copies every tensor to host memory synchronously — a COPY,
    because the next step updates the parameters, moments and cache in
    place — and flushes to disk on a worker thread; ``wait`` joins before
    exit.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree, metadata=None):
        self.wait()
        self._thread = threading.Thread(
            target=save, args=(self.ckpt_dir, step, _host_copy(tree),
                               metadata, self.keep), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
