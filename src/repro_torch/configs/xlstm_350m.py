"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24 blocks d_model=1024 4H, no FFN (d_ff=0; xLSTM blocks carry their own
projections), vocab 50304, pattern mLSTM:sLSTM = 3:1.  Fully recurrent ->
runs long_500k.  mLSTM trains chunkwise (nn/recurrent.py)."""

from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    supports_long_context=True,
)
