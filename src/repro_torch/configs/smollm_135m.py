"""smollm-135m — llama-architecture small model
[hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.  Tiny: data-parallel
dominant sharding (heads unsharded; see sharding_overrides)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv=3,
    d_ff=1536,
    vocab_size=49152,
    activation="silu",
    tie_embeddings=True,
    sharding_overrides={"heads": None, "kv_heads": None},
)
