"""The dry run (``launch.dryrun``), the remat policies and #9's custom op
on the CPU.

* One rank of a fake 8-rank world (2 x 4 ("data", "model")) counts the
  train step and the decode step of reduced kimi-k2 (2D EP) and qwen2.5
  (dense, FSDP) on ``meta`` tensors: its FLOPs and its wire tally, kind
  by kind, equal those of rank 0 of 8 gloo ranks running the same steps
  on real tensors (``tests/_dist_ranks_torch.py dryrun``).
* The remat policies: loss and every gradient bit-equal under "nothing",
  "dots" and "save_moe_recv", on one device and through the mesh on gloo
  ranks; "dots" counts fewer FLOPs, within 0.65-1.5 of the model's
  4.0 / 3.05; "save_moe_recv" leaves the x-side all-to-all and
  all-gather out of the recompute.
* ``lower_cell`` at full width on the 256- and 512-rank production
  meshes (smollm-135m x decode_32k): the reference's keys, with the
  counted ones in place of the HLO ones; a reduced prefill cell counts
  #9 through its FLOP formula with no launch and no plain version.
* World 1: counts on ``meta`` equal counts on real CPU tensors.

On a torch without CUDA the dry run's tensors lie on ``meta``
(``dryrun.fake_device``); fake CUDA tensors are held to real ones on the
card by ``chip_smoke.py``'s phase 12.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import base
from repro_torch.kernels import flash_attention, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.nn import module
from repro_torch.roofline import flops_model

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _dist_cases as C  # noqa: E402
from _dist_ranks_torch import dry_config  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry") / "ranks.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_dist_ranks_torch.py"),
                        "dryrun", "-", str(out)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as z:
        yield dict(z)


@pytest.fixture(scope="module")
def fake_counts():
    """Rank 0's counts of each reduced config's train and decode steps
    on the fake 8-rank world."""
    out = {}
    with dryrun.fake_world(8):
        mesh = Mesh((2, C.TP), ("data", "model"))
        for arch in C.DRY_ARCHS:
            cfg = dry_config(arch)
            step, args, _, _ = dryrun.build(cfg, "train_4k", mesh, "meta",
                                            n_micro=1, batch=C.DRY_B,
                                            seq=C.DRY_S)
            out["train", arch], _ = dryrun.count(step, *args)
            step, args, _, _ = dryrun.build(cfg, "decode_32k", mesh, "meta",
                                            batch=C.DRY_B, seq=C.DRY_S_MAX)
            out["decode", arch], _ = dryrun.count(step, *args)
    return out


@pytest.mark.parametrize("what", ["train", "decode"])
@pytest.mark.parametrize("arch", C.DRY_ARCHS)
def test_fake_rank_counts_equal_real_rank(ranks, fake_counts, arch, what):
    """The fake rank's share (its rows of the batch, its block of the
    cache) counts what the real rank 0 counts on its share: FLOPs, the
    wire kind by kind, and the bytes of its state."""
    fake = fake_counts[what, arch]
    assert fake["flops"] == int(ranks[f"{what}/{arch}/flops"]) > 0
    assert fake["argument_size_in_bytes"] == \
        int(ranks[f"{what}/{arch}/argument_bytes"])
    for kind in KINDS:
        assert fake["tally"].bytes[kind] == \
            int(ranks[f"{what}/{arch}/{kind}_bytes"]), kind
        assert fake["tally"].count[kind] == \
            int(ranks[f"{what}/{arch}/{kind}_count"]), kind
    assert sum(fake["tally"].count.values()) > 0
    if arch.startswith("kimi") and what == "train":
        assert fake["tally"].count["all-to-all"] > 0


@pytest.mark.parametrize("arch", C.DRY_ARCHS)
def test_remat_policies_bit_equal_through_the_mesh(ranks, arch):
    for policy in C.POLICIES:
        assert bool(ranks[f"remat/{arch}/{policy}/equal"]), policy


def test_save_moe_recv_leaves_the_x_side_exchange_out_of_the_recompute(
        ranks):
    """Reduced kimi-k2 (2 groups, ``moe_2d``): one all-to-all and one
    all-gather fewer a group, of x_send's and x_full's bytes; "dots"
    keeps every collective in the recompute, as "nothing" does."""
    arch = "kimi-k2-1t-a32b"
    cfg = dry_config(arch)

    def get(policy, kind, what):
        return int(ranks[f"remat/{arch}/{policy}/{kind}_{what}"])

    for kind in KINDS:
        for what in ("bytes", "count"):
            assert get("dots", kind, what) == get("nothing", kind, what)
    groups = cfg.n_groups
    # x_send (E, C, D) and x_full (E_loc, R * C * tp, D), f32: the rows
    # of each rank's (B / 2, S / 4) tokens, k winners at capacity 1.25
    t = C.DRY_B // 2 * C.DRY_S // C.TP
    cap = int(np.ceil(t * cfg.moe_top_k / cfg.n_experts
                      * cfg.moe_capacity_factor))
    send = cfg.n_experts * cap * cfg.d_model * 4
    assert get("nothing", "all-to-all", "count") - \
        get("save_moe_recv", "all-to-all", "count") == groups
    assert get("nothing", "all-to-all", "bytes") - \
        get("save_moe_recv", "all-to-all", "bytes") == groups * send
    assert get("nothing", "all-gather", "count") - \
        get("save_moe_recv", "all-gather", "count") == groups
    assert get("nothing", "all-gather", "bytes") - \
        get("save_moe_recv", "all-gather", "bytes") == groups * send * C.TP
    for kind in ("all-reduce", "reduce-scatter", "broadcast"):
        assert get("save_moe_recv", kind, "bytes") == \
            get("nothing", kind, "bytes")


def test_pipeline_ring_counts_as_a_collective_permute(ranks):
    assert int(ranks["ring/collective-permute_count"]) == 1
    assert int(ranks["ring/collective-permute_bytes"]) == 3 * 4 * 4
    assert sum(int(ranks[f"ring/{k}_count"]) for k in KINDS) == 1


def _loss_grads_flops(cfg, params, batch):
    live = module.tree_map(lambda t: t.clone().requires_grad_(), params)
    flat = module.leaves(live)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        loss, _ = lm.loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, flat)
    return [loss.detach(), *grads], fc.get_total_flops()


@pytest.mark.parametrize("arch", ["smollm-135m", "kimi-k2-1t-a32b"])
def test_remat_policies_bit_equal_and_dots_counts_fewer_flops(arch):
    cfg = dry_config(arch)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.RandomState(2)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (4, 64)))}
    out = {p: _loss_grads_flops(dataclasses.replace(cfg, remat_policy=p),
                                params, batch) for p in C.POLICIES}
    for p in C.POLICIES:
        for a, b in zip(out[p][0], out["nothing"][0]):
            assert torch.equal(a, b), p
    f_nothing, f_dots = out["nothing"][1], out["dots"][1]
    assert out["save_moe_recv"][1] == f_nothing        # no mesh: no exchange
    assert f_dots < f_nothing
    ratio = (f_nothing / f_dots) / (4.0 / 3.05)
    assert 0.65 <= ratio <= 1.5, ratio


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(dry_config("smollm-135m"), remat_policy="all")
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        lm.loss_fn(params, {"tokens": torch.zeros(2, 8, dtype=torch.int64)},
                   cfg)


# --- lower_cell ------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "params_total",
            "params_active", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "bytes_per_device", "roofline"}
COUNTED = {"flops", "flops_by_op", "bytes_accessed", "count_s",
           "collectives_counted", "roofline_counted"}


@pytest.mark.parametrize("multi", [False, True])
def test_lower_cell_full_width_decode(multi):
    before = flash_attention.flash_attention_fwd.launches
    res = dryrun.lower_cell("smollm-135m", "decode_32k", multi)
    assert REF_KEYS | COUNTED | {"cache_seq_len"} <= set(res)
    assert not {"collectives_hlo", "roofline_hlo"} & set(res)
    assert res["mesh"] == ("2x16x16" if multi else "16x16")
    assert res["n_devices"] == (512 if multi else 256)
    assert res["device"] == dryrun.fake_device() or \
        res["device"] == "cuda (fake)"
    cfg = configs.get_config("smollm-135m")
    # each rank holds its block of the cache of 128 x 32768 slots: its
    # rows over the "batch" axes (16 or 32 ranks), its 2048 slots over
    # "model"
    rows = 128 // (32 if multi else 16)
    assert res["batch_block"] == {
        "rows": rows, "axes": ["pod", "data"] if multi else ["data"]}
    assert res["cache_slots"] == 32768 // 16
    block = cfg.n_layers * rows * 2048 * cfg.n_kv * cfg.hd * 2 * 2
    whole = cfg.n_layers * 128 * 32768 * cfg.n_kv * cfg.hd * 2 * 2
    assert block < res["argument_size_in_bytes"] < whole // 100
    assert res["bytes_per_device"] == res["argument_size_in_bytes"] + \
        res["temp_size_in_bytes"]
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    assert res["roofline"] == flops_model.analyze(
        cfg, "decode_32k", flops_model.mesh_for(multi))
    assert res["roofline_counted"]["flops_per_device"] == res["flops"]
    assert res["collectives_counted"]["all-gather_count"] > 0
    assert flash_attention.flash_attention_fwd.launches == before
    json.dumps(res)


def test_reduced_prefill_counts_flash_with_no_launch_and_no_plain_version(
        monkeypatch):
    cfg = base.reduced(configs.ARCHS["smollm-135m"])
    monkeypatch.setitem(configs.ARCHS, "smollm-135m", cfg)

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a tensor without "
                             "data")
    monkeypatch.setattr(ref, "flash_attention_ref", plain)
    before = flash_attention.flash_attention_fwd.launches
    res = dryrun.lower_cell("smollm-135m", "prefill_32k", False)
    assert flash_attention.flash_attention_fwd.launches == before
    flash = res["flops_by_op"]["repro_torch.flash_attention"]
    # the rank's 32 / 16 rows, every head (smollm's heads stay whole)
    assert res["batch_block"]["rows"] == 2
    assert flash == cfg.n_layers * flash_attention.kernel_flops(
        2 * cfg.n_heads, 32768, cfg.hd, True, cfg.compute_dtype)


def test_peak_bytes_count_a_storage_at_a_freed_address():
    """A storage that takes the address of one freed before it is a new
    storage (the allocator hands addresses out again): ``n`` results
    kept alive at once peak at ``n`` times their bytes, each allocated
    after a temporary was freed."""
    n = 64

    def step(x):
        keep = []
        for i in range(n):
            tmp = x * 2.0
            del tmp
            keep.append(x + float(i))
        return keep

    x = torch.ones(256)
    counts, out = dryrun.count(step, x)
    assert len(out) == n
    assert counts["argument_size_in_bytes"] == x.nbytes
    assert counts["temp_size_in_bytes"] == n * x.nbytes
    assert counts["bytes_per_device"] == (n + 1) * x.nbytes


def test_kernel_flops_counts_the_causal_tiles_visited():
    # bf16, D 64: CTAs of 128 rows over kv tiles of 64; CTA i sees 2i + 2
    s = 2048
    want = sum(128 * 128 * (i + 1) for i in range(s // 128))
    assert flash_attention.kernel_flops(1, s, 64, True) == 4 * 64 * want
    assert flash_attention.kernel_flops(2, s, 64, False) == \
        2 * 4 * 64 * s * s
    # f32: 64 rows over tiles of 64, ragged
    assert flash_attention.kernel_flops(1, 100, 8, True, torch.float32) == \
        4 * 8 * (64 * 64 + 36 * 100)
    # above D = 128: kv tiles of 32
    assert flash_attention.kernel_flops(1, 96, 192, True) == \
        4 * 192 * 96 * 96


def test_lower_cell_needs_a_world_of_its_own():
    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="exists already"):
            dryrun.lower_cell("smollm-135m", "decode_32k", False)
    res = dryrun.lower_cell("smollm-135m", "train_4k", False,
                            do_compile=False)
    assert res["lowered_only"] and res["n_micro"] == 8
    assert "flops" not in res


def test_main_writes_cached_cells_and_honours_skips(tmp_path, capsys):
    out = str(tmp_path)
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--out", out, "--no-compile"])
    path = tmp_path / "smollm-135m__decode_32k__single.json"
    assert json.loads(path.read_text())["lowered_only"]
    dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                 "--out", out, "--no-compile"])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", out])
    text = capsys.readouterr().out
    assert "[cached] smollm-135m__decode_32k__single" in text
    assert "SKIP hubert-xlarge x decode_32k" in text


def test_run_cell_counts_each_variant(tmp_path, monkeypatch):
    """``run_cell("qwen")`` with ``compile_variants``: each variant's dry
    run (decode at full width on the 16 x 16 fake mesh) recorded beside
    the model's terms; the int8 / int4 caches shrink the counted memory,
    so the verdicts stand."""
    from repro_torch.launch import hillclimb
    monkeypatch.setattr(hillclimb, "OUT_DIR", str(tmp_path))
    res = hillclimb.run_cell("qwen", compile_variants=True)
    mem = [e["compiled"]["mem_gib"] for e in res]
    assert mem[0] > mem[1] > mem[2] > 0
    assert [e["verdict"] for e in res] == ["baseline", "confirmed",
                                           "confirmed"]
    for e in res:
        assert e["compiled"]["collectives_counted"]["all-gather_count"] > 0
    assert configs.ARCHS["qwen2.5-32b"].kv_quant is None
    saved = json.loads((tmp_path / "qwen.json").read_text())
    assert [e["name"] for e in saved] == ["baseline", "kv_int8", "kv_int4"]


def test_opt_profile_and_n_micro_equal_the_reference_rule():
    ocfg, gd = dryrun.opt_profile(configs.get_config("kimi-k2-1t-a32b"))
    assert (ocfg.moment_dtype, gd) == ("bfloat16", torch.bfloat16)
    ocfg, gd = dryrun.opt_profile(configs.get_config("nemotron-4-340b"))
    assert (ocfg.moment_dtype, gd) == ("bfloat16", torch.float32)
    ocfg, gd = dryrun.opt_profile(configs.get_config("smollm-135m"))
    assert (ocfg.moment_dtype, gd) == ("float32", torch.float32)

    class M:
        shape = {"pod": 2, "data": 16, "model": 16}
    cfg = configs.get_config("smollm-135m")
    assert dryrun.n_micro_for(cfg, "train_4k", M) == 8
    assert dryrun.n_micro_for(cfg, "decode_32k", M) == 1


# --- world 1: no data against real data ----------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_meta_counts_equal_real_counts_at_world_1(shape):
    """(A prefill's attention on a CPU tensor is #9's plain version, on a
    tensor without data its custom op: the card holds those two to each
    other, ``chip_smoke.py`` phase 12.)"""
    cfg = dry_config("smollm-135m")
    b, s = 2, 16
    meta_step, meta_args, _, _ = dryrun.build(cfg, shape, None, "meta",
                                              n_micro=1, batch=b, seq=s)
    fake, _ = dryrun.count(meta_step, *meta_args)
    params = module.materialize(lm.param_specs(cfg),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    step, args, _, _ = dryrun.build(cfg, shape, None, "cpu", n_micro=1,
                                    batch=b, seq=s, params=params)
    rng = np.random.RandomState(3)
    if shape == "train_4k":
        args = (params, args[1], {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (1, b, s)))})
    else:
        args = (params, args[1],
                torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, 1))),
                torch.full((b,), 3, dtype=torch.int64))
    real, _ = dryrun.count(step, *args)
    for key in ("flops", "flops_by_op", "argument_size_in_bytes"):
        assert fake[key] == real[key], key
    assert fake["flops"] > 0
    # the host constants of f32 arithmetic (``torch.as_tensor`` of a
    # number) reach ``meta`` through a copy, which a CPU tensor skips: a
    # few bytes a step
    assert abs(fake["bytes_accessed"] - real["bytes_accessed"]) <= \
        1e-4 * real["bytes_accessed"]


def test_batch_specs_match_the_reference_shapes():
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape in lm.SHAPES:
            specs = lm.batch_specs(cfg, shape)
            axes = lm.batch_axes(cfg, shape)
            assert set(specs) == set(axes)
            for k, t in specs.items():
                assert t.is_meta and len(axes[k]) == t.ndim
                if k in ("tokens", "targets", "pos"):
                    assert t.dtype == torch.int64
    cfg = configs.get_config("internvl2-26b")
    sp = lm.batch_specs(cfg, "train_4k", device="cpu")
    assert tuple(sp["tokens"].shape) == (256, 4096 - cfg.n_patches)
    assert tuple(sp["patches"].shape) == (256, cfg.n_patches,
                                          cfg.frontend_dim)
    assert not sp["tokens"].is_meta


def test_new_modules_import_no_jax_or_repro():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b",
                         re.MULTILINE)
    src = ROOT / "src" / "repro_torch"
    for rel in ("roofline/__init__.py", "roofline/analysis.py",
                "roofline/flops_model.py", "launch/dryrun.py",
                "launch/hillclimb.py", "kernels/flash_attention.py",
                "dist/collectives.py", "dist/pipeline.py", "nn/moe.py",
                "models/lm.py", "core/f32math.py"):
        hits = pattern.findall((src / rel).read_text())
        assert not hits, f"{rel} imports {hits}"
    for rel in ("experiments_torch/roofline_report.py",
                "experiments_torch/make_experiments.py",
                "tests/_dist_ranks_torch.py"):
        assert not pattern.findall((ROOT / rel).read_text()), rel
