"""arctic-480b — Snowflake Arctic: 128-expert top-2 MoE with a parallel
dense residual FFN [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128e top-2, vocab 32000."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=4864,
    vocab_size=32000,
    activation="silu",
    moe=True,
    n_experts=128,
    moe_top_k=2,
    moe_dense_residual=True,
    sharding_overrides={
        "seq": "model",                    # Megatron sequence parallelism
        "experts": ("pod", "data"),        # 2D EP: experts over DP rows
        "expert_ffn": "model",             # TP inside each expert
        "embed": ("pod", "data"),          # FSDP for dense (attn/embed) weights
    },
)
