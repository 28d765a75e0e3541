"""Fault-tolerant checkpoints, in the reference's layout.

Counterpart of ``repro.train.checkpoint``:
  * ATOMIC: the trees are written into a temporary directory, each file
    is fsync'ed, then the directory is renamed to ``step_N`` (and its
    parent fsync'ed): a crash mid-save never leaves a partial
    checkpoint that ``all_steps`` would list;
  * SELF-CONTAINED: parameters and optimizer state go in one checkpoint;
    the data pipeline is stateless by step, so the step is its state;
  * ``keep_n`` garbage collection, which also sweeps the ``.tmp_*``
    directories of crashed saves.

The layout is the reference's: ``step_N/{name}.npz`` for each named tree
and ``meta.json`` with the step, the leaves keyed as
``jax.tree_util.keystr`` spells their paths (``['layers']['b0']...`` for
a dict, ``[0]`` for a list, ``.mu[...]`` for a ``NamedTuple`` field), so
a checkpoint written by the JAX package restores here and one written
here restores there.  A bf16 leaf is stored as the 2-byte void records
``numpy`` writes for the reference's bf16 arrays, and read back from
them (the reference's own restore cannot cast those records, so its
bf16 checkpoints restore only here).  ``restore`` places each leaf on
its template's device in its template's dtype, and raises ``KeyError``
for a missing leaf and ``ValueError`` for a shape mismatch.  With
``shardings`` (``nn.module.shardings`` of the current mesh) it keeps each
leaf's block of this rank, the blocks ``lm.forward(mesh=)`` and the
train step take: a checkpoint saved under one mesh restores under
another (the reference's elastic path).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.nn import module

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _paths(tree: Tree, prefix: str = ""):
    """(keystr, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, lists and ``NamedTuple`` fields in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _paths(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored leaf as a tensor in ``like``'s dtype on its device; 2-byte
    void records are bf16 bits."""
    a = np.asarray(a, order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree: Tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _unflatten_into(template: Tree, flat: dict[str, np.ndarray],
                    prefix: str = "") -> Tree:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten_into(v, flat, f"{prefix}.{name}")
            for name, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix}: {arr.shape} vs "
                         f"{tuple(template.shape)}")
    return _to_tensor(arr, template)


def _blocks(tree: Tree, sh: Tree) -> Tree:
    """Each leaf of ``tree`` cut to this rank's block of its sharding in
    the parallel tree ``sh`` (a copy, so the full leaf is freed)."""
    if isinstance(tree, dict):
        return {k: _blocks(v, sh[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_blocks(v, s) for v, s in zip(tree, sh)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return module.block(tree, sh.spec, sh.mesh).clone()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, state: dict[str, Tree],
         meta: dict | None = None, keep_n: int = 3) -> str:
    """state: name -> tree (e.g. {"params": ..., "opt": ...})."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    try:
        for name, tree in state.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        for fn in os.listdir(tmp):
            with open(os.path.join(tmp, fn), "rb") as f:
                os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_n)
    return final


def _gc(ckpt_dir: str, keep_n: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_n]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    for fn in os.listdir(ckpt_dir):     # orphans of crashed saves
        if fn.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, fn), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """The steps of the complete checkpoints (those with ``meta.json``),
    ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = _STEP_RE.match(fn)
        if m and os.path.exists(os.path.join(ckpt_dir, fn, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, templates: dict[str, Tree],
            shardings: dict[str, Tree] | None = None
            ) -> tuple[dict[str, Tree], dict]:
    """The named trees of ``step_N``, in the templates' structure, each
    leaf on its template's device in its template's dtype; and the
    meta.  The templates hold full leaves; where ``shardings`` (same
    names) gives a tree of ``nn.module.NamedSharding`` for a name, each
    of its leaves is cut to this rank's block of the sharding's mesh."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    out = {}
    for name, tmpl in templates.items():
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten_into(tmpl, flat)
        if shardings and shardings.get(name) is not None:
            tree = _blocks(tree, shardings[name])
        out[name] = tree
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return out, meta


def restore_latest(ckpt_dir: str, templates: dict[str, Tree],
                   shardings: dict[str, Tree] | None = None):
    """``restore`` of the newest complete checkpoint, or None."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, templates, shardings)
