"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 2:1
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000,
window 2048.  Sub-quadratic (LRU recurrence + bounded window) -> runs
long_500k.  Pattern (rglru, rglru, attn_local) x12 + 2 tail rglru blocks."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="gelu",
    pattern=("rglru", "rglru", "attn_local"),
    window=2048,
    d_rnn=4096,
    scale_embed=True,
    tie_embeddings=True,
    supports_long_context=True,
)
