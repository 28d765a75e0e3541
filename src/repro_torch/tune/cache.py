"""Persistent tile-plan cache: tuned (bm, bk, bn) per (op, shape, density
bucket, mode, device kind).

Counterpart of ``repro.tune.cache``, with the same file schema
(``CACHE_FORMAT``, ``CACHE_VERSION``), density buckets, ``lookup``
semantics, alignment gate, memo and atomic write.  It differs in four
ways:

* **Its own file.**  The default is ``PLAN_CACHE_fused_macro_torch.json``
  at the repo root, under its own environment names
  (``REPRO_TORCH_PLAN_CACHE_PATH``, ``REPRO_TORCH_PLAN_CACHE``).  The
  reference's ``PLAN_CACHE_fused_macro.json`` is never read or written.
* **The device key.**  ``device_kind(device)`` names the device the launch
  runs on: ``torch.cuda.get_device_name(device).lower()`` for a CUDA
  device, ``"cpu"`` for the plain version.  ``lookup`` takes that device;
  a CPU lookup never initialises CUDA.
* **No committed cache.**  With no file every lookup is a silent miss and
  ``kernels.fused_macro.plan_tiles`` returns the heuristic's plan.
* **Fallback scope.**  ``lookup`` degrades to None (the heuristic) with a
  one-shot ``RuntimeWarning`` on any cache problem: missing file, corrupt
  JSON, a wrong format or version, a stale entry whose blocks fail the
  alignment rules.  That catch wraps the lookup alone; a kernel or build
  failure never passes through it.  A cached plan only picks which of the
  bitwise-equivalent launch geometries runs.

Key semantics: an entry matches when op, shape string, mode and device
kind are equal and the density bucket matches.  With ``density=None`` (the
serving paths) the ``"any"`` bucket comes first; failing that the group's
entry with the highest ``speedup_vs_heuristic`` wins, ties broken by
bucket name.  The memo of a parsed file is invalidated on a change of its
(mtime, size), so a retune takes effect without a restart.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import NamedTuple

import torch

CACHE_FORMAT = "neudw-plan-cache"
CACHE_VERSION = 1
DEFAULT_BASENAME = "PLAN_CACHE_fused_macro_torch.json"

ENV_PATH = "REPRO_TORCH_PLAN_CACHE_PATH"   # override the cache file location
ENV_DISABLE = "REPRO_TORCH_PLAN_CACHE"     # "0"/"off"/"" disables lookups

# Half-open [lo, hi) ranges over the measured |event| rate; the names are
# key material (a change invalidates every entry: bump CACHE_VERSION).
DENSITY_EDGES = (0.02, 0.075, 0.15, 0.35, 0.75)
DENSITY_BUCKETS = ("d00-02", "d02-07", "d07-15", "d15-35", "d35-75",
                   "d75-100")
ANY_BUCKET = "any"

REQUIRED_ENTRY_FIELDS = ("op", "shape", "mode", "density_bucket",
                         "device_kind", "plan")


class PlanBlocks(NamedTuple):
    """The tuned block sizes an entry carries: what ``plan_tiles`` needs."""

    bm: int
    bk: int
    bn: int


def density_bucket(density: float) -> str:
    """Map a measured event density in [0, 1] to its stable bucket name."""
    d = float(density)
    if not 0.0 <= d <= 1.0:
        raise ValueError(f"density {d} not in [0, 1]")
    for edge, name in zip(DENSITY_EDGES, DENSITY_BUCKETS):
        if d < edge:
            return name
    return DENSITY_BUCKETS[-1]


def shape_key(m: int, k_dim: int, nc: int, n: int, t: int) -> str:
    """Canonical shape string: batch x K x NC x N x T (logical, unpadded)."""
    return f"{m}x{k_dim}x{nc}x{n}x{t}"


def device_kind(device=None) -> str:
    """Cache-key device identity of the device a launch runs on.

    ``"cpu"`` for the plain version (CUDA untouched); for a CUDA device
    its name, lower-cased (e.g. ``"nvidia h100 80gb hbm3"``).  ``None``
    is the port's default device, ``cuda``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return torch.cuda.get_device_name(dev).lower()


def default_path() -> str:
    """The cache file: the environment's override, else the repo root."""
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))  # src/../
    return os.path.join(root, DEFAULT_BASENAME)


def disabled() -> bool:
    return os.environ.get(ENV_DISABLE, "1").lower() in ("0", "off", "")


# --- load / memoize --------------------------------------------------------

# path -> (stamp, index | None): the index maps the 5-tuple key to the raw
# entry; None records a failed load, so it is neither parsed nor warned
# about again until the file changes.
_MEMO: dict = {}
_WARNED: set = set()


def clear_memo() -> None:
    """Drop the in-process cache state (tests; after in-place rewrites)."""
    _MEMO.clear()
    _WARNED.clear()


def _warn_once(path: str, reason: str) -> None:
    if (path, reason) not in _WARNED:
        _WARNED.add((path, reason))
        warnings.warn(
            f"tile-plan cache {path!r}: {reason}; falling back to the "
            f"heuristic planner (regenerate with tools/tune_plans_torch.py)",
            RuntimeWarning, stacklevel=3)


def _entry_key(e: dict) -> tuple:
    return (e["op"], e["shape"], e["mode"], e["device_kind"],
            e["density_bucket"])


def _valid_blocks(plan: dict, nc: int | None = None) -> bool:
    """The alignment rules a cached plan must satisfy (the stale-entry
    gate): row tiles a multiple of 8, K tiles of 128 (so every plan meets
    the kernels' ``bm % 4`` and ``bk % 32``), column tiles of 128 or wide
    enough that ``plan_tiles`` collapses the layer to one tile."""
    try:
        bm, bk, bn = int(plan["bm"]), int(plan["bk"]), int(plan["bn"])
    except (KeyError, TypeError, ValueError):
        return False
    if not (bm > 0 and bm % 8 == 0 and bk > 0 and bk % 128 == 0 and bn > 0):
        return False
    return bn % 128 == 0 or nc is None or bn >= nc


def _index(doc: object, path: str):
    if not isinstance(doc, dict) or doc.get("format") != CACHE_FORMAT:
        _warn_once(path, "not a plan-cache file")
        return None
    if doc.get("version") != CACHE_VERSION:
        _warn_once(path, f"version {doc.get('version')!r} != "
                         f"{CACHE_VERSION} (stale format)")
        return None
    entries = doc.get("entries")
    if not isinstance(entries, list):
        _warn_once(path, "entries: want a list")
        return None
    idx = {}
    for e in entries:
        if not isinstance(e, dict) or \
                any(f not in e for f in REQUIRED_ENTRY_FIELDS):
            _warn_once(path, "entry missing required fields (skipped)")
            continue
        idx[_entry_key(e)] = e
    return idx


def _load(path: str):
    """Memoized parse of the cache file; None on any failure (warned once)."""
    try:
        st = os.stat(path)
        stamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        return None                      # no file: a silent miss
    memo = _MEMO.get(path)
    if memo is not None and memo[0] == stamp:
        return memo[1]
    try:
        with open(path) as f:
            doc = json.load(f)
        idx = _index(doc, path)
    except (OSError, ValueError) as e:
        _warn_once(path, f"unreadable ({e.__class__.__name__})")
        idx = None
    _MEMO[path] = (stamp, idx)
    return idx


# --- lookup ----------------------------------------------------------------

def lookup(m: int, k_dim: int, nc: int, n: int, t: int, *,
           mode: str = "kwn", density: float | None = None,
           op: str = "fused_macro_seq", device=None,
           path: str | None = None) -> PlanBlocks | None:
    """Tuned blocks for a launch on ``device``, or None (the heuristic).
    Never raises."""
    try:
        if disabled():
            return None
        path = path or default_path()
        idx = _load(path)
        if not idx:
            return None
        group = (op, shape_key(m, k_dim, nc, n, t), mode,
                 device_kind(device))
        entry = None
        if density is not None:
            entry = idx.get(group + (density_bucket(density),)) \
                or idx.get(group + (ANY_BUCKET,))
        else:
            entry = idx.get(group + (ANY_BUCKET,))
            if entry is None:
                in_group = [e for k, e in sorted(idx.items())
                            if k[:4] == group]
                if in_group:
                    entry = max(
                        in_group,
                        key=lambda e: (float(e.get("speedup_vs_heuristic",
                                                   0.0)),
                                       e["density_bucket"]))
        if entry is None:
            return None
        if not _valid_blocks(entry["plan"], nc=nc):
            _warn_once(path, f"stale plan for {group} (alignment rules)")
            return None
        p = entry["plan"]
        return PlanBlocks(int(p["bm"]), int(p["bk"]), int(p["bn"]))
    except Exception as e:   # noqa: BLE001 — a cache problem is a miss
        _warn_once(path or "<unresolved>",
                   f"lookup failed ({e.__class__.__name__}: {e})")
        return None


# --- write -----------------------------------------------------------------

def save_entries(entries: list[dict], path: str | None = None,
                 merge: bool = True) -> str:
    """Persist tuner results, merged by key into any existing file
    (``merge=False`` starts the file afresh); returns the path written.

    Each entry must carry ``REQUIRED_ENTRY_FIELDS`` and pass the alignment
    gate.  The write is atomic: the document goes to a temp file in the
    same directory, is fsynced and ``os.replace``d over the target, so a
    reader sees the old file or the new one, never a torn one.  The memo
    of the path is dropped.
    """
    path = path or default_path()
    for e in entries:
        missing = [f for f in REQUIRED_ENTRY_FIELDS if f not in e]
        if missing:
            raise ValueError(f"entry missing fields {missing}: {e}")
        nc = int(str(e["shape"]).split("x")[2])
        if not _valid_blocks(e["plan"], nc=nc):
            raise ValueError(f"entry plan violates alignment rules: {e}")
    merged: dict = {}
    if merge:
        existing = _load(path)
        if existing:
            merged.update(existing)
    for e in entries:
        merged[_entry_key(e)] = e
    doc = {"format": CACHE_FORMAT, "version": CACHE_VERSION,
           "entries": [merged[k] for k in sorted(merged)]}
    # same-directory temp file: os.replace must not cross filesystems
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp",
        dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _MEMO.pop(path, None)
    return path
