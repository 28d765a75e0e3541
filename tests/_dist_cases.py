"""The shapes and cases shared by ``_dist_reference_jax.py`` (the JAX
package on 8 simulated devices) and ``_dist_ranks_torch.py`` (the port
on 8 gloo ranks): ``tests/test_dist.py``'s MoE shapes on its (2, 4)
("data", "model") mesh, the reduced MoE LMs, and the partitioned step's
configs and operands."""

import dataclasses

import numpy as np

E, D, F, K = 8, 16, 32, 2
B, S = 4, 8
TP = 4
LM_ARCHS = ("kimi-k2-1t-a32b", "arctic-480b")
LM_B, LM_S, LM_DECODE = 2, 8, 3
# BatchedEngine through the mesh: 2 slots (the rows of "data"), two
# prompts of these lengths, 4 new tokens each
ENGINE_PROMPTS, ENGINE_NEW, ENGINE_S_MAX = (3, 5), 4, 16

# (name, path, capacity factor, sequence length, keyword arguments): the
# sequence-sharded a2a and its fallback where 6 does not divide over 4,
# and moe_2d with the sequence left unsharded for the same reason
CASES = [
    ("a2a_cf8", "a2a", 8.0, S, {}),
    ("a2a_cf125", "a2a", 1.25, S, {}),
    ("a2a_seq_cf125", "a2a", 1.25, S, {"seq_sharded": True}),
    ("a2a_seq_fallback_cf125", "a2a", 1.25, 6, {"seq_sharded": True}),
    ("2d_cf8", "2d", 8.0, S, {}),
    ("2d_cf125", "2d", 1.25, S, {}),
    ("2d_noseq_cf125", "2d", 1.25, 6, {}),
    ("2d_int8_cf8", "2d", 8.0, S, {"wire_dtype": "int8"}),
    ("dense_ep", "dense_ep", None, S, {}),
    ("dense_ep_2d", "dense_ep_2d", None, S, {}),
]

# the paths on MoE parameters held as a rank's blocks: (the case on whole
# leaves it equals, the rules of the layout): the 2D paths under
# kimi-k2's and arctic's overrides, the others under the default rules
_RULES_2D = {"experts": ("pod", "data"), "expert_ffn": "model",
             "embed": ("pod", "data")}
HELD = {"a2a": ("a2a_cf125", None), "2d": ("2d_cf125", _RULES_2D),
        "dense_ep": ("dense_ep", None), "dense_ep_2d": ("dense_ep_2d",
                                                        _RULES_2D)}

# The dry run against real ranks: reduced kimi-k2 (2D EP) and a reduced
# dense config, remat on, one train step of a (DRY_B, DRY_S) batch and
# one decode step against DRY_S_MAX slots, on the (2, 4) mesh; the remat
# policies on the same loss
DRY_ARCHS = ("kimi-k2-1t-a32b", "qwen2.5-32b")
DRY_B, DRY_S, DRY_S_MAX = 4, 8, 16
POLICIES = ("nothing", "dots", "save_moe_recv")

# The partitioned step (test_torch_partition.py): reduced configs on the
# (2, 4) mesh, the rows of a PART_B batch over "data", the heads, FFN,
# vocabulary and cache slots over "model", and the sequence over "model"
# where the overrides put it there (sequence parallelism: qwen2.5, kimi-k2,
# arctic, internvl2): qwen2.5 (GQA, FSDP, a kv head cut over "model"),
# smollm (heads whole, tied embeddings), gemma2 (local layers, softcaps,
# the ring decode), kimi-k2 (2D EP), recurrentgemma (RG-LRU, MQA), arctic
# (2D EP beside a dense residual FFN), internvl2 (4 patches before 8
# tokens: 12 positions over 4) and xlstm (mLSTM and sLSTM, one head of 4
# a rank).  recurrentgemma's RG-LRU runs on 16 of its 64 channels a rank.  A config with a window takes PART_S_LONG
# positions (a prompt longer than its window, as the ring decode needs);
# the prefill's cache is padded by PART_PAD slots (so that the slots
# split over "model") for PART_DECODE decode steps; the engine has
# PART_SLOTS slots over "data" and the prompts PART_PROMPTS.
PART_ARCHS = ("qwen2.5-32b", "smollm-135m", "gemma2-2b", "kimi-k2-1t-a32b",
              "recurrentgemma-9b", "qwen2.5-32b+6heads", "qwen2.5-32b+int8",
              "arctic-480b", "internvl2-26b", "qwen2.5-32b+seq6",
              "xlstm-350m", "xlstm-350m+3heads")
# a variant of a config: its tag -> (the registry's name, the fields it
# changes on the reduced config): qwen2.5 with 6 heads of 16 and 2 kv
# heads, whose q and kv blocks over the 4 ranks of "model" cut a head,
# as the full qwen2.5's 40 heads over 16 do; its int8 KV cache, the
# payload and scales split over the slots; and qwen2.5 on 6 positions
# (PART_SEQ), which do not divide over "model": the sequence stays whole;
# xlstm with 3 heads of 16 (d_model 48), which do not divide over the 4
# ranks of "model": its cells run whole on every rank, as xlstm's 4 heads
# over 16 do
PART_VARIANTS = {"qwen2.5-32b+6heads": ("qwen2.5-32b", {
    "n_heads": 6, "n_kv": 2, "head_dim": 16}),
    "qwen2.5-32b+int8": ("qwen2.5-32b", {"kv_quant": "int8"}),
    "qwen2.5-32b+seq6": ("qwen2.5-32b", {}),
    "xlstm-350m+3heads": ("xlstm-350m", {
        "n_heads": 3, "n_kv": 3, "d_model": 48})}
PART_SEQ = {"qwen2.5-32b+seq6": 6}
PART_B, PART_S, PART_S_LONG, PART_PAD, PART_DECODE = 4, 8, 64, 8, 3
PART_SLOTS, PART_PROMPTS, PART_NEW, PART_S_MAX = 4, (3, 5, 4), 3, 16
PART_SEED = 11


def part_seq(tag: str, window) -> int:
    """The tokens of a case's batch."""
    return PART_SEQ.get(tag, PART_S_LONG if window else PART_S)


def part_patches(cfg):
    """The shape of a VLM case's patches, or None."""
    if cfg.frontend != "vision_patches":
        return None
    return (PART_B, cfg.n_patches, cfg.frontend_dim)


def part_config(tag: str, archs: dict, reduced):
    """The reduced config of a case (``reduced`` and ``archs`` the side's
    own ``configs.base.reduced`` and registry)."""
    name, fields = PART_VARIANTS.get(tag, (tag, {}))
    return dataclasses.replace(reduced(archs[name]), **fields)


def part_inputs(paths_shapes, vocab: int, s: int, seed: int,
                patches=None) -> dict:
    """The operands of one config's partitioned step, the same on both
    sides, from ``numpy.random.RandomState(seed)``: each parameter leaf
    (``paths_shapes``: (path, shape) in sorted-key order) normal with
    the fan-in scale, ``s`` tokens a row, the decode tokens, the prompts,
    and a VLM's ``patches`` (their shape) standard normal."""
    rs = np.random.RandomState(seed)
    out = {}
    for path, shape in paths_shapes:
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        out[f"params/{path}"] = (rs.standard_normal(shape)
                                 / np.sqrt(max(fan, 1))).astype(np.float32)
    out["tokens"] = rs.randint(0, vocab, (PART_B, s)).astype(np.int32)
    out["decode_tokens"] = rs.randint(0, vocab, (PART_B, PART_DECODE)
                                      ).astype(np.int32)
    for uid, n in enumerate(PART_PROMPTS):
        out[f"prompt{uid}"] = rs.randint(0, vocab, n).astype(np.int32)
    if patches is not None:
        out["patches"] = rs.standard_normal(patches).astype(np.float32)
    return out
