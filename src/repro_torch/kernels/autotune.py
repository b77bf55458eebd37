"""Tile autotuner of the port's sampled-dW kernels, measured on the card.

Counterpart of ``repro/kernels/autotune.py``.  The reference tunes the
(bm, bn, bk) grid of its Pallas kernel; the port's kernels take one
output tile per launch, chosen among the few their C entry points know
(``candidate_blocks``).  This module is the one place that decides that
tile for ``fused_sampled_dw`` and ``sampled_matmul``, and the route a
shape takes (``dw_route``):

* :func:`shape_key` — the tuning key ``(d_in, d_out, B, k, dtype)``
  rendered as the reference renders it.
* :class:`TuningTable` — a persisted JSON table mapping, per kernel, keys
  to the winning tile of the route the shape takes; loaded once per path
  (a corrupt file, a wrong ``version`` or a tile that is not a candidate
  of its route degrades to an empty table with one warning, never an
  error; a missing file is an empty table).
* :func:`resolve_blocks` / :func:`tile_for` — the tile a wrapper hands its
  C entry point, always a concrete one: a pinned tile, else the table's
  entry, else the shape rule (:func:`default_blocks`).  Worked out once
  per table path and shape.
* :func:`autotune` — time every candidate of one shape on the card and
  return the fastest (deterministic: candidates in a fixed order, ties to
  the first).
* ``python -m repro_torch.kernels.autotune --out <path>`` — refresh a
  table over the default sweep on the card.

The reference's ``KernelConfig.autotune`` switch and its ``candidates=`` /
``max_candidates=`` narrowing are absent: a route has one or two tiles,
so the tuner times all of them, and a caller steers the tile by a pin
(``KernelConfig.dw_tile``, a wrapper's ``tile=``) or by the table it
names (``KernelConfig.table_path``).

Table format (``version`` guards future migrations; every ``us`` was
taken on ``card``, as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` names it)::

    {"version": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
     "kernels": {"fused_sampled_dw": {"di2048-do2048-b4-k307-bfloat16":
         {"route": "wgmma", "tile": 128, "us": 21.4,
          "candidates_us": {"128": 21.4, "64": 34.9}}},
                 "sampled_matmul": {...}}}

The key holds no expert count, so the expert axis of ``fused_sampled_dw``
(E > 1) keeps the shape rule, and it holds the exact ``k``: a budget that
gives another ``k`` misses the table.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

TABLE_VERSION = 1
PACKAGED_TABLE = os.path.join(os.path.dirname(__file__),
                              "tuning_table.json")
KERNELS = ("fused_sampled_dw", "sampled_matmul")
# the SM count the shape rule plans for where there is no card (an H100's)
H100_SMS = 132

# Shapes the refresh sweeps: (d_in, d_out, B, k, dtype).  Each is tuned
# for both kernels.
DEFAULT_SWEEP: Tuple[Tuple[int, int, int, int, str], ...] = (
    # the reference's sweep (repro/kernels/autotune.py)
    (256, 256, 8, 77, "float32"),
    (256, 256, 8, 77, "bfloat16"),
    (64, 64, 2, 24, "float32"),
    (512, 512, 4, 154, "float32"),
    # the train path: qwen2.5-3b's sampled linears at B=4, S=1024,
    # budget 0.3
    (2048, 2048, 4, 307, "bfloat16"),
    (2048, 256, 4, 307, "bfloat16"),
    (2048, 11008, 4, 307, "bfloat16"),
    (11008, 2048, 4, 307, "bfloat16"),
    # where the shape rule's fused_sampled_dw tile lost to the other one:
    # qwen2.5-3b's shards at model = 2, xlstm-125m (and at model = 2),
    # whisper-base
    (2048, 1024, 2, 307, "bfloat16"),
    (1024, 2048, 2, 307, "bfloat16"),
    (1536, 768, 4, 307, "bfloat16"),
    (768, 1536, 2, 154, "bfloat16"),
    (512, 2048, 8, 307, "bfloat16"),
    (2048, 512, 8, 307, "bfloat16"),
    (768, 768, 4, 307, "bfloat16"),
)

# kernel -> route -> the tiles its C entry point takes, largest first.
# fused_sampled_dw: the square output tile (the f32 FMA kernel has one);
# sampled_matmul's wgmma route: 256 (256 x 128 tiles in clusters of two
# along d_out) or 64 (64 x 64, no cluster).  Each route takes each of its
# tiles at every shape it takes (the wmma / fma routes of sampled_matmul
# pad the operands to the tile), so no candidate depends on the shape.
_CANDIDATES = {
    "fused_sampled_dw": {"fma": (64,), "wmma": (128, 64),
                         "wgmma": (128, 64)},
    "sampled_matmul": {"fma": (64,), "wmma": (128, 64), "wgmma": (256, 64)},
}
_KEY = re.compile(r"di(\d+)-do(\d+)-b(\d+)-k(\d+)-(\w+)$")

# GPU clock cycles the card spins before each timed group (about 10 ms on
# an H100): long enough for the host to enqueue the whole group behind it.
HOST_LEAD_CYCLES = 20_000_000


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def shape_key(d_in: int, d_out: int, b: int, k: int, dtype) -> str:
    """Stable tuning-table key for one problem shape, equal to the
    reference's: ``dtype`` may be a ``torch.dtype``, a numpy dtype or a
    plain name — all normalise to the canonical name (``torch.bfloat16``
    -> ``"bfloat16"``)."""
    return f"di{d_in}-do{d_out}-b{b}-k{k}-{_dtype_name(dtype)}"


def largest_divisor(dim: int, want: int) -> int:
    """Largest divisor of ``dim`` that is <= ``want`` (>= 1 always)."""
    want = max(1, min(want, dim))
    for d in range(want, 0, -1):
        if dim % d == 0:
            return d
    return 1


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` of a dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, _dtype_name(dtype))


def dw_route(d_in: int, d_out: int, dtype: torch.dtype,
             aligned: bool = True) -> str:
    """The one kernel route a shape takes in both sampled-dW kernels:
    ``fma`` for float32, ``wgmma`` for bfloat16/float16 when d_in and d_out
    are multiples of 8 and hsub and dz start on a 16-byte boundary
    (``aligned``; TMA's strides and base and the 16-byte dZ' chunks need
    it), ``wmma`` for the other bfloat16/float16 shapes."""
    if dtype == torch.float32:
        return "fma"
    if d_in % 8 == 0 and d_out % 8 == 0 and aligned:
        return "wgmma"
    return "wmma"


def candidate_blocks(kernel: str, route: str) -> Tuple[int, ...]:
    """The tiles ``kernel``'s C entry point takes on ``route``, largest
    first (so ties resolve to the largest tile — fewest blocks)."""
    try:
        return _CANDIDATES[kernel][route]
    except KeyError:
        raise ValueError(f"no tiles for kernel {kernel!r} on route "
                         f"{route!r}; kernels {KERNELS}") from None


def default_blocks(kernel: str, route: str, d_in: int, d_out: int,
                   e: int = 1, sms: int = H100_SMS) -> int:
    """The shape rule: the tile a kernel takes where nothing pins it and
    the table has no entry.  ``fma``: 64.  ``sampled_matmul``'s ``wgmma``:
    256 (256 x 128 in clusters of two) when that gives at least half of
    the ``sms`` SMs a block, else 64.  Otherwise 128 when ``e`` experts'
    128 x 128 tiles still give every SM one, else 64 (the rule
    ``csrc/fused_sampled_dw.cu::pick_tile`` applies to tile 0, which no
    wrapper passes)."""
    if route == "fma":
        return 64
    if kernel == "sampled_matmul" and route == "wgmma":
        blocks = 2 * -(-d_in // 256) * -(-d_out // 256)
        return 256 if 2 * blocks >= sms else 64
    return 128 if e * -(-d_in // 128) * -(-d_out // 128) >= sms else 64


class Entry(NamedTuple):
    """One tuned shape: the route it was timed on, the winning tile, its
    time and every candidate's (microseconds on the table's card)."""
    route: str
    tile: int
    us: Optional[float] = None
    candidates_us: Tuple[Tuple[int, float], ...] = ()


def _check_entry(kernel: str, key: str, route: str, tile: int) -> None:
    if not _KEY.match(key):
        raise ValueError(f"malformed tuning-table key {key!r}")
    if tile not in candidate_blocks(kernel, route):
        raise ValueError(f"tile {tile!r} of {kernel} {key} is not a "
                         f"candidate of its {route} route "
                         f"{candidate_blocks(kernel, route)}")


@dataclasses.dataclass
class TuningTable:
    """In-memory view of one persisted tuning table: kernel -> key ->
    :class:`Entry`, and the card its times were taken on."""

    entries: Dict[str, Dict[str, Entry]] = dataclasses.field(
        default_factory=dict)
    card: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Parse a table; a missing file gives an empty table, a corrupt
        or mis-versioned one (or a tile its route does not take) an EMPTY
        table (the shape rule takes over) with one warning."""
        try:
            with open(path) as f:
                raw = json.load(f)
            if raw.get("version") != TABLE_VERSION:
                raise ValueError(f"tuning-table version "
                                 f"{raw.get('version')!r} != "
                                 f"{TABLE_VERSION}")
            table = cls(card=raw.get("card"))
            for kernel, recs in raw["kernels"].items():
                for key, rec in recs.items():
                    us = rec.get("us")
                    table.put(kernel, key, rec["route"], rec["tile"],
                              us if isinstance(us, (int, float)) else None,
                              {int(t): float(v) for t, v in
                               rec.get("candidates_us", {}).items()})
            return table
        except FileNotFoundError:
            return cls()
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:       # corrupt: degrade, don't die
            warnings.warn(f"ignoring corrupt kernel tuning table "
                          f"{path!r}: {exc}", RuntimeWarning)
            return cls()

    def lookup(self, kernel: str, key: str,
               route: Optional[str] = None) -> Optional[int]:
        """The tile tuned for ``key``, or ``None``; with ``route``, only an
        entry timed on that route."""
        hit = self.entries.get(kernel, {}).get(key)
        if hit is None or (route is not None and hit.route != route):
            return None
        return hit.tile

    def put(self, kernel: str, key: str, route: str, tile: int,
            us: Optional[float] = None,
            candidates_us: Optional[Dict[int, float]] = None) -> None:
        if not isinstance(tile, int) or isinstance(tile, bool):
            raise ValueError(f"tile of {kernel} {key} must be an int, got "
                             f"{tile!r}")
        _check_entry(kernel, key, route, tile)
        self.entries.setdefault(kernel, {})[key] = Entry(
            route, tile, None if us is None else float(us),
            tuple(sorted((candidates_us or {}).items(),
                         key=lambda c: -c[0])))

    def save(self, path: str) -> str:
        def record(e: Entry) -> dict:
            rec = {"route": e.route, "tile": e.tile}
            if e.us is not None:
                rec["us"] = e.us
            if e.candidates_us:
                rec["candidates_us"] = {str(t): us
                                        for t, us in e.candidates_us}
            return rec

        payload = {"version": TABLE_VERSION, "card": self.card,
                   "kernels": {kernel: {key: record(e)
                                        for key, e in recs.items()}
                               for kernel, recs in self.entries.items()}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        return path


@functools.lru_cache(maxsize=None)
def load_table(path: Optional[str] = None) -> TuningTable:
    """Cached table load, keyed on the path; ``None`` = the packaged
    table.  A file rewritten in place is read again after
    :func:`cache_clear`."""
    return TuningTable.load(path or PACKAGED_TABLE)


@functools.lru_cache(maxsize=None)
def _tabled_or_rule(path: Optional[str], kernel: str, d_in: int, d_out: int,
                    b: int, k: int, dtype, aligned: bool, e: int,
                    sms: int) -> Tuple[int, str]:
    """(tile, ``"table"`` or ``"rule"``: where it came from)."""
    route = dw_route(d_in, d_out, torch_dtype(dtype), aligned)
    if e == 1:
        hit = load_table(path).lookup(
            kernel, shape_key(d_in, d_out, b, k, dtype), route)
        if hit is not None:
            return hit, "table"
    return default_blocks(kernel, route, d_in, d_out, e, sms), "rule"


def cache_clear() -> None:
    """Forget every loaded table and every tile worked out from one."""
    load_table.cache_clear()
    _tabled_or_rule.cache_clear()


def resolve_blocks(cfg, kernel: str, d_in: int, d_out: int, b: int, k: int,
                   dtype, *, aligned: bool = True, e: int = 1,
                   sms: int = H100_SMS, tile: Optional[int] = None) -> int:
    """The tile to hand ``kernel``, always a concrete one: a pin first
    (``tile``, else for ``fused_sampled_dw`` ``cfg.dw_tile``); then the
    entry of ``cfg.table_path``'s table (``None``: the packaged one) tuned
    on the route these operands take (``aligned``: hsub and dz start on
    16-byte boundaries), unless ``e`` > 1 experts share the launch; else
    the shape rule (:func:`default_blocks` for ``sms`` SMs).  ``cfg=None``
    is the default ``KernelConfig``.  Worked out once per table path and
    shape; ``resolve_blocks.tile_sources`` counts the calls by where the
    tile came from (``"pinned"``, ``"table"``, ``"rule"``)."""
    if tile is None and kernel == "fused_sampled_dw" and cfg is not None:
        tile = cfg.dw_tile
    if tile is not None:
        resolve_blocks.tile_sources["pinned"] += 1
        return tile
    tile, source = _tabled_or_rule(
        None if cfg is None else cfg.table_path, kernel, d_in, d_out, b, k,
        dtype, aligned, e, sms)
    resolve_blocks.tile_sources[source] += 1
    return tile


resolve_blocks.tile_sources = dict.fromkeys(("pinned", "table", "rule"), 0)


@functools.lru_cache(maxsize=None)
def _card_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_for(cfg, kernel: str, hsub: torch.Tensor, dz: torch.Tensor,
             tile: Optional[int] = None) -> int:
    """:func:`resolve_blocks` on the operands themselves: hsub ([E,] B, k,
    d_in) or (k, d_in) (B = 1), dz likewise; the route their alignment
    gives, and the SM count of the card they lie on (an H100's on the
    CPU)."""
    e = hsub.shape[0] if hsub.ndim == 4 else 1
    b = hsub.shape[-3] if hsub.ndim >= 3 else 1
    k, d_in = hsub.shape[-2:]
    sms = _card_sms(hsub.device) if hsub.is_cuda else H100_SMS
    return resolve_blocks(cfg, kernel, d_in, dz.shape[-1], b, k, hsub.dtype,
                          aligned=_build.aligned16(hsub, dz), e=e, sms=sms,
                          tile=tile)


def time_ms(fn, warmup: int = 3, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of (CUDA-event time of ``inner`` back-to-back
    calls) / inner, after ``warmup`` calls.  Each group is enqueued behind
    a spin of the card (``torch.cuda._sleep``), so the events time the
    device's work and not the host's dispatch, which is slower than a
    small kernel.  Inputs stay L2-warm between calls, as they are for the
    real caller (dz and h come straight out of the preceding matmul)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (its
    first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sweep_inputs(d_in: int, d_out: int, b: int, k: int, dtype, device,
                 seed: int = 0):
    """The reference's tuning inputs on ``device``: hsub (B, k, d_in), dz
    (B, 4k, d_out) normal in ``dtype``, idx in [0, 4k) int32, scale
    uniform f32 — from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = torch_dtype(dtype)
    hsub = torch.randn((b, k, d_in), generator=gen, device=device).to(dt)
    dz = torch.randn((b, 4 * k, d_out), generator=gen, device=device).to(dt)
    idx = torch.randint(0, 4 * k, (b, k), generator=gen, device=device,
                        dtype=torch.int32)
    scale = torch.rand((b, k), generator=gen, device=device)
    return hsub, dz, idx, scale


def run_candidate(kernel: str, tile: int, hsub, dz, idx, scale):
    """One launch of ``kernel`` with its tile pinned to ``tile``."""
    from repro_torch.kernels import ops
    return getattr(ops, kernel)(hsub, dz, idx, scale, tile=tile)


def _default_measure(device="cuda") -> Callable:
    """Microseconds of one candidate on the card (``time_ms``: CUDA
    events, median of groups, L2-warm) on :func:`sweep_inputs`.  Raises
    without a card: nothing is timed on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the tuner times kernels on a card, not on {dev}")

    def measure(kernel: str, tile: int, d_in: int, d_out: int, b: int,
                k: int, dtype) -> float:
        args = sweep_inputs(d_in, d_out, b, k, dtype, dev)
        return 1e3 * time_ms(lambda: run_candidate(kernel, tile, *args))

    return measure


def measure_candidates(kernel: str, d_in: int, d_out: int, b: int, k: int,
                       dtype, *, measure: Optional[Callable] = None,
                       device="cuda") -> List[Tuple[int, float]]:
    """(tile, us) of every candidate of the route aligned operands of this
    shape take, in candidate order.  ``measure(kernel, tile, d_in, d_out,
    b, k, dtype) -> us`` is injectable so tests can pin timings."""
    route = dw_route(d_in, d_out, torch_dtype(dtype))
    fn = measure if measure is not None else _default_measure(device)
    return [(tile, float(fn(kernel, tile, d_in, d_out, b, k, dtype)))
            for tile in candidate_blocks(kernel, route)]


def fastest(times: Sequence[Tuple[int, float]]) -> Tuple[int, float]:
    """The (tile, us) of least time; ties go to the earliest."""
    best, best_us = times[0][0], math.inf
    for tile, us in times:
        if us < best_us:
            best, best_us = tile, us
    return best, best_us


def autotune(kernel: str, d_in: int, d_out: int, b: int, k: int, dtype, *,
             measure: Optional[Callable] = None,
             device="cuda") -> Tuple[int, float]:
    """Time the candidate tiles of one shape; return (tile, us).

    Deterministic by construction: the candidate order is fixed
    (:func:`candidate_blocks`), ties break toward the earliest candidate,
    and ``measure`` is injectable."""
    return fastest(measure_candidates(kernel, d_in, d_out, b, k, dtype,
                                      measure=measure, device=device))


def refresh_table(shapes: Sequence[Tuple[int, int, int, int, str]],
                  out_path: str, *, measure: Optional[Callable] = None,
                  base: Optional[TuningTable] = None, device="cuda",
                  card: Optional[str] = None) -> TuningTable:
    """Autotune both kernels at every shape, merge over ``base``, persist
    to JSON.  ``card`` names the card the times come from; with the
    default measure it is read from ``nvidia-smi``."""
    if measure is None:
        measure = _default_measure(device)
        card = card or card_line()
    table = base if base is not None else TuningTable()
    table.card = card
    for (d_in, d_out, b, k, dtype) in shapes:
        route = dw_route(d_in, d_out, torch_dtype(dtype))
        for kernel in KERNELS:
            times = measure_candidates(kernel, d_in, d_out, b, k, dtype,
                                       measure=measure)
            tile, us = fastest(times)
            table.put(kernel, shape_key(d_in, d_out, b, k, dtype), route,
                      tile, us, dict(times))
    table.save(out_path)
    return table


def _parse_shapes(spec: str) -> List[Tuple[int, int, int, int, str]]:
    out = []
    for part in spec.split(";"):
        di, do, b, k, dt = part.split(",")
        out.append((int(di), int(do), int(b), int(k), dt.strip()))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="refresh the sampled-dW kernels' tile table on the "
                    "card")
    ap.add_argument("--out", default=PACKAGED_TABLE,
                    help="output tuning-table JSON path")
    ap.add_argument("--shapes", default=None,
                    help="semicolon-separated 'd_in,d_out,B,k,dtype' "
                         "rows (default: the built-in sweep)")
    ap.add_argument("--merge", action="store_true",
                    help="merge over the existing table at --out "
                         "instead of replacing it")
    args = ap.parse_args(argv)
    shapes = (_parse_shapes(args.shapes) if args.shapes
              else list(DEFAULT_SWEEP))
    base = TuningTable.load(args.out) if args.merge else None
    table = refresh_table(shapes, args.out, base=base)
    n = 0
    for kernel, recs in sorted(table.entries.items()):
        for key, e in sorted(recs.items()):
            n += 1
            times = " ".join(f"{t}={us:.2f}us" for t, us in e.candidates_us)
            print(f"{kernel} {key}: {e.route} tile={e.tile}"
                  + (f" ({times})" if times else ""))
    print(f"card: {table.card}")
    print(f"wrote {n} entries -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
