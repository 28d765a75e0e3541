"""Beyond-paper ablation: the macro's mechanisms applied to LM training.

Three questions the paper's ideas raise at LM scale, answered on a reduced
smolLM / MoE config:
  1. KWN-FFN: Eq. (1) winner sparsity on FFN hidden units: how much loss
     do we give up at k = 12.5% / 25% of units vs dense?
  2. CIM mode: ternary twin-cell weights + NLQ activations on every
     projection (C1+C2): trainable? loss gap vs fp?
  3. SNL router rescue: the sensitive-neuron probabilistic rescue (C5)
     applied to MoE routing: does load balance (aux loss) improve?

Trains with the port's microbatched train step and AdamW on the device
(no kernel: autograd takes the plain attention); ``STEPS`` defaults to
the reference's 40 (``$REPRO_LM_ABLATION_STEPS``).  Weights and the
rescue's Gumbel sample come from ``torch.Generator``s (seeds 0 and 7),
so the numbers agree with the JAX script's statistically.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from experiments_torch import _snn_cache as C
from repro_torch.configs import ARCHS
from repro_torch.configs.base import reduced
from repro_torch.data.synthetic_lm import DataConfig, SyntheticLM
from repro_torch.models import lm
from repro_torch.nn import module, moe
from repro_torch.train import optim, train_loop

STEPS = int(os.environ.get("REPRO_LM_ABLATION_STEPS", "40"))


def _train(cfg, seed=0, steps=None):
    steps = STEPS if steps is None else steps
    dev = C.device()
    ocfg = optim.AdamWConfig(lr=5e-3, warmup_steps=4, total_steps=steps)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator(dev).manual_seed(seed),
                                device=dev)
    opt = optim.adamw_init(params, ocfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 64, 8, seed=seed))
    step = train_loop.build_train_step(cfg, n_micro=2, opt_cfg=ocfg)
    losses = []
    for i in range(steps):
        batch = {k: v.to(dev) for k, v in data.batch_at(i, n_micro=2).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
    return [float(x) for x in torch.stack(losses).cpu()]


def run() -> dict:
    base = reduced(ARCHS["smollm-135m"])
    out = {}

    dense = _train(base)
    out["ffn_dense_final_loss"] = round(dense[-1], 4)
    for k, tag in ((16, "kwn_ffn_k16(12.5%)"), (32, "kwn_ffn_k32(25%)")):
        losses = _train(dataclasses.replace(base, kwn_ffn_k=k))
        out[f"{tag}_final_loss"] = round(losses[-1], 4)
        out[f"{tag}_gap_vs_dense"] = round(losses[-1] - dense[-1], 4)

    cim = _train(dataclasses.replace(base, cim_linear=True))
    out["cim_mode_final_loss"] = round(cim[-1], 4)
    out["cim_mode_gap_vs_dense"] = round(cim[-1] - dense[-1], 4)
    out["cim_mode_trains"] = bool(cim[-1] < cim[0])

    # SNL-style router rescue on a small MoE layer (direct measurement)
    dev = C.device()
    gen = torch.Generator(dev).manual_seed(0)
    d, e, kk, t = 32, 8, 2, 512

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    p = {"router": normal(d, e) * 0.5, "w_in": normal(e, d, 64),
         "w_gate": normal(e, d, 64), "w_out": normal(e, 64, d)}
    x = normal(1, t, d)
    exp1 = torch.empty((1, t, e), device=dev).exponential_(
        generator=torch.Generator(dev).manual_seed(7))
    gumbel = -torch.log(exp1)           # a standard Gumbel sample
    _, aux0 = moe.moe_ref(p, x, k=kk)
    _, aux1 = moe.moe_ref(p, x, k=kk, snl_rescue=0.05, gumbel=gumbel)
    out["router_aux_balance_no_snl"] = round(float(aux0), 4)
    out["router_aux_balance_snl"] = round(float(aux1), 4)
    out["snl_improves_balance"] = bool(aux1 < aux0)
    return out
