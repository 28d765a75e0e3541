"""internvl2-26b — InternViT + InternLM2 VLM [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 (padded to 92672 for
16-way sharding, Megatron-style).  The InternViT-6B frontend is a STUB per
the assignment: input_specs() provides precomputed 3200-d patch embeddings;
a learned projector maps them into the LM."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=16384,
    vocab_size=92553,
    activation="silu",
    frontend="vision_patches",
    frontend_dim=3200,
    n_patches=256,
    sharding_overrides={
        "seq": "model",                    # Megatron sequence parallelism
        "embed": ("pod", "data"),          # FSDP: weights sharded over DP too
    },
)
