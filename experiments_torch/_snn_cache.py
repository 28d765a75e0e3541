"""Shared SNN training cache for the accuracy experiments (Figs. 5b / 6c /
8, Table I, the latency and K-sweep scripts): each (dataset, mode,
train_nlq) model is trained once with ``snn.train`` on the device and
kept on disk as numpy arrays, so the suite does not retrain per figure.

The cache lives in ``experiments_torch/.cache/`` (``$REPRO_TORCH_
EXPERIMENTS_CACHE`` elsewhere), each file tagged with the device type:
models trained on the card and on the CPU are never mixed.

``eval_model`` evaluates what the reference's ``eval_model`` evaluates:
``snn.evaluate`` through the composed chain (``fused=False``, the
reference's ``forward_silicon`` default), where NLD's branch weights stay
float.  Clean KWN results equal the JAX scripts' bit for bit on the same
batches; noisy results differ by the noise stream (the port's generator
against ``jax.random``) and agree statistically.  It also runs the kernel
path (``fused="seq"``, the port's default: #1 for KWN, #2 for NLD, their
plain versions on the CPU) on the same batches and counter seeds, and
returns its accuracy and telemetry as extra keys, ``kernel_acc`` and
``kernel_<key>``.  Batches come from a
``torch.Generator``, so accuracies agree with the JAX package's
statistically, not bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import dendrite as dendrite_lib
from repro_torch.data import events as ev_lib
from repro_torch.models import snn

CACHE_DIR = os.environ.get(
    "REPRO_TORCH_EXPERIMENTS_CACHE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache"))

TRAIN_STEPS = int(os.environ.get("REPRO_SNN_TRAIN_STEPS", "350"))
EVAL_BATCHES = int(os.environ.get("REPRO_SNN_EVAL_BATCHES", "6"))
DEVICE = None           # None: the card; run.py --device cpu sets "cpu"

_KWN_K = {"nmnist": 3, "dvs_gesture": 12, "quiroga": 6}
_ACT = {"nmnist": "quadratic", "dvs_gesture": "relu", "quiroga": "sigmoid4"}


def device() -> torch.device:
    return device_lib.resolve(DEVICE)


def snn_config(dataset: str, mode: str, train_nlq: bool = True
               ) -> snn.SNNConfig:
    d = ev_lib.DATASETS[dataset]
    return snn.SNNConfig(
        n_in=d.n_in, n_steps=d.n_steps, n_classes=d.n_classes,
        mode=mode, k=_KWN_K[dataset], activation=_ACT[dataset],
        train_nlq=train_nlq)


def _save(path: str, p: dict) -> None:
    arrays = {}
    for name, w in p.items():
        if isinstance(w, dendrite_lib.DendriteParams):
            for field, a in zip(w._fields, w):
                arrays[f"{name}.{field}"] = a.cpu().numpy()
        else:
            arrays[name] = w.cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load(path: str, dev) -> dict:
    with np.load(path) as f:
        arrays = {k: torch.from_numpy(f[k]).to(dev) for k in f.files}
    p = {k: v for k, v in arrays.items() if "." not in k}
    fields = {k.split(".", 1)[1]: v for k, v in arrays.items() if "." in k}
    if fields:
        p["dend"] = dendrite_lib.DendriteParams(**fields)
    return p


def trained_model(dataset: str, mode: str, train_nlq: bool = True,
                  seed: int = 0):
    dev = device()
    os.makedirs(CACHE_DIR, exist_ok=True)
    tag = (f"{dataset}_{mode}_nlq{int(train_nlq)}_s{seed}_t{TRAIN_STEPS}"
           f"_{dev.type}")
    path = os.path.join(CACHE_DIR, tag + ".npz")
    cfg = snn_config(dataset, mode, train_nlq)
    ds = ev_lib.EventDataset(ev_lib.DATASETS[dataset], device=dev)
    if os.path.exists(path):
        return _load(path, dev), cfg, ds
    # per-cell training budget: the quadratic NLD cell degrades past ~350
    # steps (ramp-knee gradient spikes), the relu NLD (dvs) keeps improving.
    steps = TRAIN_STEPS
    if mode == "nld" and dataset == "dvs_gesture":
        steps = TRAIN_STEPS * 2
    p, _ = snn.train(cfg, ds, n_steps=steps, batch=64, seed=seed, lr=0.1,
                     device=dev)
    _save(path, p)
    return p, cfg, ds


def eval_model(p, cfg, ds, seed: int = 1, **kw):
    """(accuracy, telemetry) of the composed chain over ``EVAL_BATCHES``
    batches, the kernel path's accuracy and telemetry beside them."""
    def evaluate(fused):
        gen = torch.Generator(device=ds.device).manual_seed(seed)
        return snn.evaluate(p, cfg, ds, gen, n_batches=EVAL_BATCHES,
                            device=ds.device, fused=fused, **kw)

    acc, tele = evaluate(False)
    k_acc, k_tele = evaluate("seq")
    return acc, {**tele, "kernel_acc": k_acc,
                 **{f"kernel_{k}": v for k, v in k_tele.items()}}
