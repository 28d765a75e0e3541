"""kimi-k2-1t-a32b — trillion-param MoE (Kimi K2) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048, MoE 384 experts top-8
(+1 shared expert), vocab 163840.  The top-8 router is the paper's KWN circuit
at datacenter scale (DESIGN.md SS4)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_ff=2048,
    vocab_size=163840,
    activation="silu",
    moe=True,
    n_experts=384,
    moe_top_k=8,
    n_shared_experts=1,
    rope_theta=50000.0,
    sharding_overrides={
        "seq": "model",                    # Megatron sequence parallelism
        "experts": ("pod", "data"),        # 2D EP: experts over DP rows
        "expert_ffn": "model",             # TP inside each expert
        "embed": ("pod", "data"),          # FSDP for dense (attn/embed) weights
    },
)
