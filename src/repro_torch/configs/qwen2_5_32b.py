"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=27648,
    vocab_size=152064,
    activation="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    sharding_overrides={
        "seq": "model",                    # Megatron sequence parallelism
        "embed": ("pod", "data"),          # FSDP: weights sharded over DP too
    },
)
