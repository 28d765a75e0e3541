"""Architecture registry: --arch <id> -> LMConfig.

Counterpart of ``repro.configs``, data only: each architecture has its own
module with the published config, field for field the reference's.
``get_config(id)`` resolves by the public id (dashes/dots as assigned).
``models.lm`` runs every one of them.
"""

from repro_torch.configs import (arctic_480b, gemma2_2b, hubert_xlarge,
                                 internvl2_26b, kimi_k2_1t_a32b,
                                 nemotron_4_340b, qwen2_5_32b,
                                 recurrentgemma_9b, smollm_135m, xlstm_350m)
from repro_torch.configs.base import reduced

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (kimi_k2_1t_a32b, arctic_480b, nemotron_4_340b, gemma2_2b,
              qwen2_5_32b, smollm_135m, hubert_xlarge, xlstm_350m,
              recurrentgemma_9b, internvl2_26b)
}


def get_config(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


# (arch, shape) cells that are skipped, with reasons (DESIGN.md SS4).
SHAPE_SKIPS = {
    ("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
    ("hubert-xlarge", "long_500k"): "encoder-only: no decode step",
    ("kimi-k2-1t-a32b", "long_500k"): "full attention: 500k is quadratic",
    ("arctic-480b", "long_500k"): "full attention: 500k is quadratic",
    ("nemotron-4-340b", "long_500k"): "full attention: 500k is quadratic",
    ("qwen2.5-32b", "long_500k"): "full attention: 500k is quadratic",
    ("smollm-135m", "long_500k"): "full attention: 500k is quadratic",
    ("internvl2-26b", "long_500k"): "full attention: 500k is quadratic",
    ("gemma2-2b", "long_500k"):
        "alternating local/GLOBAL: global layers are full attention",
}


def cells(shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k")):
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for a in ARCHS:
        for s in shapes:
            if (a, s) not in SHAPE_SKIPS:
                out.append((a, s))
    return out
