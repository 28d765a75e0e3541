"""nemotron-4-340b — dense GQA with squared-ReLU FFN [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  The squared-ReLU
activation is the quadratic nonlinearity the paper's NL-IMA implements
natively (DESIGN.md SS4: f(x)=0.5x^2, Fig. 7b)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    gated_ffn=False,
    sharding_overrides={
        "seq": "model",                    # Megatron sequence parallelism
        "embed": ("pod", "data"),          # FSDP: weights sharded over DP too
    },
)
