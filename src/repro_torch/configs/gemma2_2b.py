"""gemma2-2b — local/global alternating attention, logit softcaps,
pre+post norms, tied embeddings [arXiv:2408.00118].

26L d_model=2304 8H (GQA kv=4, head_dim 256) d_ff=9216 vocab=256000.
long_500k is SKIPPED: the global layers are full attention (DESIGN.md)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    activation="gelu",
    pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    scale_embed=True,
)
