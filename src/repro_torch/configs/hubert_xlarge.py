"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (MHA kv=16) d_ff=5120, 504 k-means target classes.
Modality frontend is a STUB per the assignment: the conv waveform stem is
replaced by precomputed 512-d frame embeddings + a learned projector.
Encoder-only: no decode shapes (DESIGN.md shape-skip table)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    gated_ffn=False,
    encoder_only=True,
    frontend="audio_frames",
    frontend_dim=512,
)
