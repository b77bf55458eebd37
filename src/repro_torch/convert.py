"""Parameters across the two packages, as numpy.

The reference (``repro.models.registry.init_params``) yields, for a
decoder arch, ``{"embed", "unit": (block_0, ..., block_{P-1}),
"final_norm"[, "shared"][, "head"]}``, one entry of ``unit`` a position
of the pattern, every leaf of it with a leading ``n_repeats`` axis (an
MoE block's ``moe/router`` (R, d, E) and ``moe/{wi,wg,wo}`` (R, E, d, f)
give the port's per-layer (d, E) and (E, d, f)); its layer ``i`` is
repeat ``i // P`` of ``unit[i % P]``.  Zamba2's shared attention block is
``shared``, unstacked, and its positions in ``unit`` are ``{}``
placeholders.  The port keeps a list of per-layer dicts (``models/lm.py``,
``{}`` at a shared position) and the same ``shared``.  A VLM adds
``vis_proj``, learned positions ``pos_embed``, both unstacked.  An
encoder-decoder (``models/encdec.py``) is ``{"embed", "pos_enc",
"pos_dec", "encoder", "decoder", "enc_norm", "final_norm"}`` in both
packages, ``encoder`` and ``decoder`` stacked on a leading layer axis in
the reference and lists of per-layer dicts in the port.  The functions
below map one onto the other so both packages can be run on the same
values; none imports the reference — the caller hands over numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference's side).  The
optimizer-layout state of ``repro_torch.optim`` keeps the reference's
stacked slots, so ``opt_state_from_jax`` / ``opt_state_to_numpy`` only
change the array type.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.optim.layouts import reference_path


# a decoder arch's optional leaves outside the stacked units; the
# encoder-decoder's stacked layer lists
_UNSTACKED = ("shared", "head", "vis_proj", "pos_embed")
_STACKED = ("encoder", "decoder")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _depth(tree) -> int:
    """The leading (layer) extent of a stacked tree's leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def params_from_jax(cfg: ArchConfig, numpy_tree: Dict[str, Any],
                    device="cuda") -> Dict[str, Any]:
    """The reference's unboxed parameter tree (numpy leaves) -> the port's
    parameters in ``cfg.param_dtype`` on ``device``."""
    device = resolve_device(device)

    def to_t(a):
        return torch.from_numpy(np.array(a)).to(device=device,
                                                dtype=cfg.pdtype)

    if cfg.is_encdec:
        return {name: ([_map(lambda a, i=i: to_t(np.asarray(a)[i]), tree)
                        for i in range(_depth(tree))]
                       if name in _STACKED else _map(to_t, tree))
                for name, tree in numpy_tree.items()}
    units, n_pat = numpy_tree["unit"], len(cfg.pattern)
    params = {
        "embed": to_t(numpy_tree["embed"]),
        "layers": [_map(lambda a, r=i // n_pat: to_t(np.asarray(a)[r]),
                        units[i % n_pat])
                   for i in range(cfg.n_layers)],
        "final_norm": _map(to_t, numpy_tree["final_norm"]),
    }
    for name in _UNSTACKED:
        if name in numpy_tree:
            params[name] = _map(to_t, numpy_tree[name])
    return params


def cache_from_jax(numpy_state: Dict[str, Any], device="cuda"
                   ) -> Dict[str, Any]:
    """The reference train state's ``znorm`` cache and ``budget_stats``
    (numpy leaves, ``{tag: (n_repeats, N)}`` and ``{tag: (N_STATS,)}``) ->
    the same entries of the port's state, f32 on ``device``.  Entries the
    reference state does not hold are left out, so
    ``state.update(cache_from_jax(...))`` starts both packages' whole loop
    from the same state (``ScheduleState`` crosses as its
    JSON)."""
    device = resolve_device(device)
    out = {}
    for name in ("znorm", "budget_stats"):
        if name in numpy_state:
            out[name] = {t: torch.from_numpy(np.array(a, dtype=np.float32)
                                             ).to(device)
                         for t, a in numpy_state[name].items()}
    return out


def params_to_numpy(cfg: ArchConfig, params: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """The port's parameters -> the reference's layout (f32 numpy leaves,
    the layers of each pattern position stacked along a leading
    ``n_repeats`` axis; ``{}`` placeholders stay ``{}``)."""

    def to_n(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    def stack(*leaves):
        return np.stack([to_n(x) for x in leaves])

    def zip_map(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_map([t[k] for t in trees]) for k in first}
        return stack(*trees)

    if cfg.is_encdec:
        return {name: (zip_map(tree) if name in _STACKED
                       else _map(to_n, tree))
                for name, tree in params.items()}
    n_pat = len(cfg.pattern)
    out = {
        "embed": to_n(params["embed"]),
        "unit": tuple(zip_map(params["layers"][j::n_pat])
                      for j in range(n_pat)),
        "final_norm": _map(to_n, params["final_norm"]),
    }
    for name in _UNSTACKED:
        if name in params:
            out[name] = _map(to_n, params[name])
    return out


def opt_state_from_jax(numpy_state: Dict[str, Any], device="cuda"
                       ) -> Dict[str, Any]:
    """The reference's optimizer-layout state (numpy leaves,
    ``{"count", "leaves": {path: {slot: array}}}``) -> the port's
    (``repro_torch.optim``, which keeps the reference's stacked slots),
    f32 on ``device``."""
    device = resolve_device(device)
    return {"count": int(numpy_state["count"]),
            "leaves": {path: {name: torch.from_numpy(
                np.array(a, dtype=np.float32)).to(device)
                for name, a in slots.items()}
                for path, slots in numpy_state["leaves"].items()}}


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer-layout state -> the reference's (f32 numpy
    slots, ``count`` an int32)."""
    return {"count": np.asarray(state["count"], np.int32),
            "leaves": {path: {name: t.detach().to(
                device="cpu", dtype=torch.float32).numpy()
                for name, t in slots.items()}
                for path, slots in state["leaves"].items()}}


def reference_leaf(cfg: ArchConfig, path: str):
    """The reference's leaf that holds the port's leaf ``path`` (a
    ``named_leaves`` path), as a "/"-joined path (``unit/0/attn/wq``), and
    the port leaf's index along that leaf's leading layer axis (None for a
    leaf the reference does not stack) — the map ``params_from_jax`` and
    ``params_to_numpy`` walk."""
    parts = path.split("/")
    index = None
    if parts[0] == "layers":
        index = int(parts[1]) // len(cfg.pattern)
    elif parts[0] in _STACKED:
        index = int(parts[1])
    return reference_path(path, len(cfg.pattern)), index
