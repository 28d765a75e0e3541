"""Analytical per-device FLOPs / HBM-bytes / wire-bytes model.

Counterpart of ``repro.roofline.flops_model``, its arithmetic term for
term.  The model reproduces what the reference's implementation executes
(its known wastes included: causal masking computed over full S, MoE
capacity padding, remat recompute) on the production mesh
(``MeshShape``: 16 x 16, or 2 x 16 x 16 with ``mesh_for(True)``), per
device per step, with breakdown dicts for attributing each change to a
term.  It keeps the reference's terms where the port executes
otherwise: the port's dense layers run whole on every rank, which
``launch.dryrun`` counts beside this model.

The constants are the port's (``roofline.analysis``): an H100 SXM's
989e12 bf16 FLOP/s and 3.35e12 B/s, and ``ICI_BW`` NVLink 4's 450e9 B/s
each way.  Assumptions the model inherits with them:

* every wire byte crosses NVLink at 450 GB/s; a ``model`` axis of 16
  spans two 8-GPU NVLink domains, so wherever a collective crosses nodes
  (over InfiniBand, a ninth of that rate or less) the collective term is
  optimistic;
* the decode MoE term divides the experts by 16 (``n_experts / 16``),
  the ``model`` axis of the single-pod mesh, whatever the mesh and the
  config's expert rule: a quirk of the reference kept as written.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import lm
from repro_torch.roofline.analysis import HBM_BW, ICI_BW, PEAK_FLOPS

BF16 = 2
F32 = 4


@dataclasses.dataclass
class MeshShape:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def dp(self) -> int:
        return self.pod * self.data

    @property
    def n_dev(self) -> int:
        return self.pod * self.data * self.model


def _attn_kv_per_query(cfg: lm.LMConfig, kind: str, block: str, s: int) -> tuple[float, float]:
    """(impl_kv_len, useful_kv_len) the implementation touches per query."""
    if kind == "decode":
        if block == "attn_local":
            w = min(cfg.window or s, s)
            return w, w
        return s, s
    if block == "attn_local" and cfg.window and cfg.window < s:
        return 2.0 * cfg.window, cfg.window  # diag + prev block vs true window
    if cfg.encoder_only:
        return s, s
    return float(s), s / 2.0               # full-S blockwise vs causal optimal


def _block_fwd_flops_per_token(cfg: lm.LMConfig, block: str, kind: str,
                               s: int) -> tuple[float, float]:
    """(impl_flops, useful_flops) of one block, forward, per token."""
    d, hd = cfg.d_model, cfg.hd
    h, g = cfg.n_heads, cfg.n_kv
    impl = useful = 0.0
    if block in ("attn", "attn_local"):
        proj = 2 * d * (h * hd) * 2 + 2 * d * (g * hd) * 2  # q,o + k,v
        kv_i, kv_u = _attn_kv_per_query(cfg, kind, block, s)
        attn_i = 2 * (h * hd) * kv_i * 2                    # qk^T + pv
        attn_u = 2 * (h * hd) * kv_u * 2
        impl += proj + attn_i
        useful += proj + attn_u
    elif block == "mlstm":
        proj = 2 * d * d * 5                                # q,k,v,ogate,out
        w = min(256, s)
        intra_i = 2 * d * w * 2                             # chunk attention
        intra_u = 2 * d * (w / 2) * 2
        state = 2 * d * hd * 2                              # kv^T outer + qC
        impl += proj + intra_i + state
        useful += proj + intra_u + state
    elif block == "slstm":
        proj = 2 * d * 4 * d + 2 * d * d                    # wx + wo
        rec = 2 * h * hd * 4 * hd                           # block-diag R
        impl += proj + rec
        useful += proj + rec
    elif block == "rglru":
        dr = cfg.d_rnn or d
        proj = 2 * d * dr * 3                               # in, gate-branch, out
        gates = 2 * dr * dr * 2                             # w_a, w_x
        scan = 10 * dr                                      # assoc-scan elementwise
        impl += proj + gates + scan
        useful += proj + gates + scan

    # FFN / MoE
    if cfg.d_ff > 0 and block not in ("mlstm", "slstm"):
        n_mat = 3 if cfg.gated_ffn else 2
        dense = 2 * d * cfg.d_ff * n_mat
        if cfg.moe:
            router = 2 * d * cfg.n_experts
            if kind == "decode":
                # dense-EP fallback: every local expert runs on every token
                per_dev_experts = cfg.n_experts / 16  # model axis
                moe_i = dense * per_dev_experts
                moe_u = dense * cfg.moe_top_k
            else:
                cf = 1.25
                moe_i = dense * cfg.moe_top_k * cf
                moe_u = dense * cfg.moe_top_k
            shared = dense * cfg.n_shared_experts
            resid = dense if cfg.moe_dense_residual else 0.0
            impl += router + moe_i + shared + resid
            useful += router + moe_u + shared + resid
        else:
            impl += dense
            useful += dense
    return impl, useful


def _per_layer_blocks(cfg: lm.LMConfig):
    blocks = list(cfg.pattern) * cfg.n_groups + list(cfg.tail_pattern)
    assert len(blocks) == cfg.n_layers
    return blocks


def fwd_flops_per_token(cfg: lm.LMConfig, kind: str, s: int,
                        with_full_head: bool) -> tuple[float, float]:
    impl = useful = 0.0
    for b in _per_layer_blocks(cfg):
        i, u = _block_fwd_flops_per_token(cfg, b, kind, s)
        impl += i
        useful += u
    if with_full_head:
        head = 2 * cfg.d_model * cfg.padded_vocab
        impl += head
        useful += 2 * cfg.d_model * cfg.vocab_size
    return impl, useful


def analyze(cfg: lm.LMConfig, shape_name: str, mesh: MeshShape,
            n_micro: int = 1, grad_bytes: int = F32,
            moment_bytes: int = F32,
            remat_factor: float | None = None) -> dict[str, Any]:
    sh = lm.SHAPES[shape_name]
    kind = sh["kind"]
    b_glob, s = sh["batch"], sh["seq"]
    n_dev = mesh.n_dev
    d = cfg.d_model
    nl = cfg.n_layers

    overrides = cfg.sharding_overrides or {}
    fsdp = overrides.get("embed") is not None     # dense weights over DP too
    moe_2d = cfg.moe and overrides.get("experts", "model") != "model"
    p_total = cfg.param_count()
    expert_p = _expert_params(cfg) if cfg.moe else 0.0
    dense_p = p_total - expert_p
    # local parameter bytes: TP always; FSDP/2D-EP divide by DP as well
    if moe_2d:
        p_local = expert_p / n_dev + dense_p / (n_dev if fsdp else mesh.model)
    else:
        p_local = p_total / (n_dev if fsdp else mesh.model)

    # remat knobs (§Perf): "group"+nothing = full recompute (4x fwd-unit);
    # "attn_only" recomputes just attention; "dots" saves matmul outputs.
    if remat_factor is None:
        if not cfg.remat:
            remat_factor = 3.0
        elif cfg.remat_mode == "attn_only":
            attn_i = sum(_block_fwd_flops_per_token(
                dataclasses.replace(cfg, d_ff=0), b, kind, s)[0]
                for b in _per_layer_blocks(cfg))
            total_i = fwd_flops_per_token(cfg, kind, s, True)[0]
            remat_factor = 3.0 + attn_i / max(total_i, 1.0)
        elif cfg.remat_policy == "dots":
            remat_factor = 3.05
        else:
            remat_factor = 4.0
    if not cfg.remat:
        wire_passes = 2.0
    elif cfg.remat_mode == "attn_only" or cfg.remat_policy == "dots":
        wire_passes = 2.0       # saved outputs -> collectives not recomputed
    else:
        wire_passes = 3.0

    if kind == "train":
        tokens = b_glob * s
        fwd_i, fwd_u = fwd_flops_per_token(cfg, kind, s, with_full_head=True)
        rf = remat_factor
        flops = tokens * fwd_i * rf / n_dev
        useful = tokens * fwd_u * 3.0 / n_dev          # fwd+bwd, no recompute
        model_f = 6 * cfg.active_param_count() * tokens / n_dev

        tokens_mb_dev = tokens / n_micro / mesh.dp     # per device-row
        passes = 3.0                                   # fwd + recompute + bwd
        act_bytes = 10 * nl * tokens_mb_dev * d * BF16 * passes * n_micro
        weight_bytes = 3 * p_local * BF16 * n_micro    # re-read each microbatch
        grad_acc_bytes = 2 * p_local * grad_bytes * n_micro
        opt_bytes = p_local * (BF16 * 2 + grad_bytes + moment_bytes * 4)
        logits_bytes = 3 * (tokens / n_micro / n_dev) * cfg.padded_vocab \
            * F32 * n_micro
        hbm = act_bytes + weight_bytes + grad_acc_bytes + opt_bytes \
            + logits_bytes

        # wire: TP activation collectives per layer per microbatch (+ MoE)
        tok_row = tokens / n_micro / mesh.dp           # per device-row
        tok_dev = tok_row / mesh.model                 # per device (seq-sharded)
        seq_sharded = overrides.get("seq") == "model"
        per_layer = (2.0 if seq_sharded else 4.0) * tok_row * d * BF16
        wire = per_layer * nl * n_micro * wire_passes
        if cfg.moe:
            cf = cfg.moe_capacity_factor
            wb = 1 if cfg.moe_wire_dtype == "int8" else BF16
            # a2a over the expert rows: send + receive each token's activation
            a2a = 2 * tok_dev * cfg.moe_top_k * cf * d * wb
            # 2D path adds the TP gather (wire dtype) + psum-scatter (bf16)
            tp_gs = (tok_dev * cfg.moe_top_k * cf * d * (wb + BF16)
                     if moe_2d else 0.0)
            # bwd runs the transposed collectives at bf16 (gradients)
            a2a_bwd = 2 * tok_dev * cfg.moe_top_k * cf * d * BF16
            tp_gs_bwd = (2 * tok_dev * cfg.moe_top_k * cf * d * BF16
                         if moe_2d else 0.0)
            fwd_passes = wire_passes - 1.0             # fwd (+ recompute)
            if cfg.remat_policy == "save_moe_recv" and cfg.remat:
                # x-side a2a + TP gather pinned: not re-run in the recompute
                # (the y-side path and all transposes still run)
                x_side = a2a / 2 + (tp_gs / 2 if moe_2d else 0.0)
                wire += ((a2a + tp_gs) * fwd_passes - x_side * (fwd_passes - 1)
                         + (a2a_bwd + tp_gs_bwd)) * nl * n_micro
            else:
                wire += ((a2a + tp_gs) * fwd_passes
                         + (a2a_bwd + tp_gs_bwd)) * nl * n_micro
        fsdp_dense = (dense_p if moe_2d else p_total) if fsdp else 0.0
        if fsdp:
            # FSDP on the dense weights: all-gather per pass per microbatch
            # (receive ~ the full row share) + one grad reduce-scatter.
            row_share = fsdp_dense / mesh.model * BF16
            wire += (wire_passes) * row_share * n_micro
            wire += fsdp_dense / mesh.model * grad_bytes   # grad RS over dp
        else:
            wire += 2 * p_local * grad_bytes           # DP grad all-reduce
        # 2D-EP expert grads/moments are fully local (no DP reduction).
    elif kind == "prefill":
        tokens = b_glob * s
        fwd_i, fwd_u = fwd_flops_per_token(cfg, kind, s, with_full_head=False)
        head = 2 * d * cfg.padded_vocab * b_glob       # last position only
        flops = (tokens * fwd_i + head) / n_dev
        useful = (tokens * fwd_u + head) / n_dev
        model_f = 2 * cfg.active_param_count() * tokens / n_dev
        tok_dev = tokens / mesh.dp
        seq_sharded = overrides.get("seq") == "model"
        act_bytes = 8 * nl * tok_dev * d * BF16
        cache_bytes = nl * tok_dev * cfg.n_kv * cfg.hd * 2 * BF16
        hbm = p_local * BF16 + act_bytes + cache_bytes
        per_layer = (2.0 if seq_sharded else 4.0) * tok_dev * d * BF16
        wire = per_layer * nl
        if cfg.moe:
            tok_disp = tokens / n_dev          # dispatch slice per device
            cf = 1.25
            wire += (2 + (2 if moe_2d else 0)) * tok_disp * cfg.moe_top_k \
                * cf * d * BF16 * nl
        if fsdp:
            wire += ((dense_p if moe_2d else p_total) / mesh.model) * BF16
    else:  # decode
        tokens = b_glob
        fwd_i, fwd_u = fwd_flops_per_token(cfg, kind, s, with_full_head=True)
        flops = tokens * fwd_i / n_dev
        useful = tokens * fwd_u / n_dev
        model_f = 2 * cfg.active_param_count() * tokens / n_dev
        # memory: every param + the whole cache is read once per token
        kv_scale = {None: 1.0, "int8": 0.5 + 2.0 / cfg.hd,
                    "int4": 0.25 + 2.0 / cfg.hd}[cfg.kv_quant]
        cache_total = _cache_bytes_total(cfg, b_glob, s) * kv_scale
        hbm = p_local * BF16 + cache_total / n_dev * 2.5  # r/w + one-hot upd
        b_dev = b_glob / mesh.dp
        wire = (4.0 * b_dev * d * BF16) * nl              # TP per layer
        wire += nl * b_dev * cfg.n_heads * cfg.hd * F32 * 2  # split-KV LSE
        if cfg.moe:
            wire += 2 * 2 * b_dev * d * BF16 * nl         # dense-EP psum

    return {
        "flops_per_device": flops,
        "useful_flops_per_device": useful,
        "model_flops_per_device": model_f,
        "bytes_per_device": hbm,
        "wire_bytes_per_device": wire,
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm / HBM_BW,
        "collective_s": wire / ICI_BW,
        "dominant": max((flops / PEAK_FLOPS, "compute"),
                        (hbm / HBM_BW, "memory"),
                        (wire / ICI_BW, "collective"))[1],
        "bound_s": max(flops / PEAK_FLOPS, hbm / HBM_BW, wire / ICI_BW),
        "model_over_hlo": model_f / flops if flops else 0.0,
        "roofline_frac": (model_f / PEAK_FLOPS)
        / max(flops / PEAK_FLOPS, hbm / HBM_BW, wire / ICI_BW),
    }


def _expert_params(cfg: lm.LMConfig) -> float:
    """Total MoE expert-bank parameters (w_in + w_gate + w_out, all layers)."""
    per_layer = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    return float(per_layer * cfg.n_layers)


def _cache_bytes_total(cfg: lm.LMConfig, b: int, s: int) -> float:
    total = 0.0
    for blk in _per_layer_blocks(cfg):
        if blk == "attn":
            total += b * s * cfg.n_kv * cfg.hd * 2 * BF16
        elif blk == "attn_local":
            w = min(cfg.window or s, s)
            total += b * w * cfg.n_kv * cfg.hd * 2 * BF16
        elif blk == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            total += b * cfg.n_heads * (hd * hd + hd) * F32
        elif blk == "slstm":
            total += b * cfg.d_model * 4 * F32
        elif blk == "rglru":
            total += b * (cfg.d_rnn or cfg.d_model) * 4 * F32
    return total


def mesh_for(multi_pod: bool) -> MeshShape:
    return MeshShape(pod=2 if multi_pod else 1)
