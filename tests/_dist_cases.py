"""The shapes and cases shared by ``_dist_reference_jax.py`` (the JAX
package on 8 simulated devices) and ``_dist_ranks_torch.py`` (the port
on 8 gloo ranks): ``tests/test_dist.py``'s MoE shapes on its (2, 4)
("data", "model") mesh, and the reduced MoE LMs."""

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
