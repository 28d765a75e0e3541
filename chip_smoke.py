"""Drive the PyTorch / CUDA port on one GPU and hold it to its plain version.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. device: a CUDA device must be present; print its name and power limit;
2. build: compile every CUDA source of the port with nvcc (sm_90a), one
   nvcc per source, all started together;
3. kernels vs plain versions, on the same inputs on the card:
   - KWN: the public wrapper ``ops.fused_macro_seq`` (padding,
     ``n_valid``, activity gating, ``row_ctl`` or a scalar seed) against
     ``kernels/ref.py`` on the same unpadded inputs, at the engine's round
     shape, at T=32 and at a ragged shape, clean and with counter noise;
   - NLD: ``ops.fused_macro_seq(mode="nld")`` the same way, at the
     DVS-Gesture round shape and sequence (J=2 branches of 128 neurons)
     and at a ragged shape with per-branch column padding (J=3);
   - the KWN stack: the stacked kernel's wrapper against its plain
     version on the same padded operands, at the DVS-Gesture stack
     (two 128-column layers, T=30) and at a ragged three-layer shape;
   all exact: 0 mismatches, MAC and ADC steps equal, membranes 0 ULP;
4. main paths, each with every launch counter set to 0 just before it and
   read just after:
   - KWN: ``SNNEventEngine`` serves 96 event-stream requests of the
     DVS-Gesture configuration at full width (n_in=512, n_hidden=128,
     11 classes, k=12), clean and noisy with one forced preemption at a
     step that is not a round boundary; every request must equal a
     one-shot batch-1 ``forward_silicon`` bit for bit, and the kernel's
     launch counter must equal the rounds run;
   - NLD: the same with the DVS-Gesture NLD configuration (J=2, relu,
     dend_range 4); the NLD kernel's counter must equal the rounds;
   - the stack: ``forward_silicon`` on the DVS-Gesture stack (64 streams
     of 30 steps) on the card, clean and noisy, must equal the same call
     on the CPU (the plain version);
5. timings: each kernel against its plain version on the card at its
   main path's shape (ms per round for KWN and NLD, ms per launch for the
   stack) beside its roofline bound; the KWN engine's requests/s and round
   ms p50/p95 over an 8192-request clean burst, and a breakdown of a
   1024-request burst under the engine tracer and ``torch.profiler``; the
   NLD engine's requests/s and whole-tick time over a 2048-request clean
   burst.

The second-to-last line of standard output is the ``kernels`` JSON record;
the last line is ``{"ok": true, "device": {...}}``.  A longer record goes
to ``chiprun_out/chip_smoke.json``, the profiler's op table to
``chiprun_out/chip_smoke_profile.txt``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import dendrite as dendrite_lib  # noqa: E402
from repro_torch.core import ima as ima_lib  # noqa: E402
from repro_torch.core import macro as macro_lib  # noqa: E402
from repro_torch.core import prbs as prbs_lib  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import fused_macro, ref  # noqa: E402
from repro_torch.models import snn  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serve import engine as engine_lib  # noqa: E402
from repro_torch.serve import lifecycle  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SEED = 0
CFG = snn.SNNConfig(n_in=512, n_hidden=128, n_classes=11, n_steps=30,
                    mode="kwn", k=12)
NLD_CFG = snn.SNNConfig(n_in=512, n_hidden=128, n_classes=11, n_steps=30,
                        mode="nld", n_branches=2, activation="relu",
                        code_bits=5, dend_range=4.0)
STACK_CFG = snn.SNNConfig(n_in=512, n_classes=11, n_steps=30,
                          hidden_layers=(128, 128), k_layers=(12, 12))
SLOTS, ROUND = 64, 8
BURST, PROFILED = 8192, 1024    # requests of the timed and profiled bursts
NLD_BURST = 2048                # requests of the timed NLD burst
STACK_BATCH = 64                # event streams in one stacked launch
KERNELS = {"fused_macro_seq_kwn": fused_macro.fused_macro_seq,
           "fused_macro_seq_nld": fused_macro.fused_macro_seq_nld,
           "fused_macro_multi_seq_kwn": fused_macro.fused_macro_multi_seq}
PATH_KERNEL = {"kwn": "fused_macro_seq_kwn", "nld": "fused_macro_seq_nld"}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def device_phase() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    return torch.cuda.get_device_name(0), smi


def build_phase() -> float:
    secs = build.build_all()
    for name, text in build.BUILD_LOG.items():
        log(f"[nvcc {name}]\n{text.strip()}")
    log(f"build: {secs:.1f} s for {build.sources()}")
    return secs


# --- phase 3: kernel against its plain version ---------------------------

def _operands(rs, t, m, kdim, n, noisy, dev):
    """Unpadded operands of one ``ops.fused_macro_seq`` call on the card:
    (x, msb, lsb, boundaries, levels, scale, v0), the SNL noise tensor
    (None on the counter-noise path) and the noise keywords."""
    w = rs.randint(-3, 4, size=(kdim, n)).astype(np.float32)
    msb = np.clip(np.round(w / 2.0), -1, 1)
    lsb = w - 2.0 * msb
    x = rs.choice([-1.0, 0.0, 1.0], p=[0.025, 0.95, 0.025],
                  size=(t, m, kdim)).astype(np.float32)
    x[::2, :, :256] = 0.0      # a quiet K tile on even steps: gated blocks
    cb = ima_lib.nlq_codebook(5, -24.0, 24.0)

    def on(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    args = (on(x), on(msb, torch.int8), on(lsb, torch.int8),
            cb.boundaries.to(dev), cb.levels.to(dev),
            on(rs.uniform(0.01, 0.1, n).astype(np.float32)),
            on(rs.uniform(-1, 1, (m, n)).astype(np.float32)))
    if noisy:
        kn = ima_lib.kernel_noise_params(ima_lib.IMANoiseModel(), cb)
        return args, None, dict(ima_noise=kn, snl_amp=0.05)
    _, bits = prbs_lib.draw(torch.tensor([1]), t * m * n)
    nz = prbs_lib.bits_to_noise(bits[0], 0.05).reshape(t, m, n)
    return args, nz.to(dev), {}


def _streams(rs, m, how, dev):
    """Counter-stream control: the ``ops.fused_macro_seq`` keywords and the
    (M, 3) ``row_ctl`` the plain version is given for the same streams."""
    if how == "row_ctl":
        rc = torch.from_numpy(np.stack(
            [rs.randint(0, 2 ** 31 - 1, m), rs.randint(0, 50, m),
             rs.randint(0, 4, m)], -1).astype(np.int32)).to(dev)
        return dict(row_ctl=rc), rc
    seed, off = int(rs.randint(0, 2 ** 31 - 1)), int(rs.randint(0, 50))
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    rc = torch.stack([torch.full_like(rows, seed),
                      torch.full_like(rows, off), rows], -1)
    return dict(seed=seed, step_offset=off), rc


def compare_phase(dev) -> dict:
    """The public wrapper ``ops.fused_macro_seq`` on the card (padding,
    ``n_valid``, the activity map, ``row_ctl`` or the scalar seed it turns
    into one, slicing back) against the plain version on the same unpadded
    card tensors."""
    rs = np.random.RandomState(SEED)
    worst, total_mismatch = 0.0, 0
    cases = [(shape, noisy, how)
             for shape in ((ROUND, SLOTS, CFG.n_in, CFG.n_hidden),
                           (32, 64, 512, 128), (32, 37, 300, 200))
             for noisy, how in ((False, "row_ctl"), (True, "row_ctl"),
                                (True, "scalar"))]
    for (t, m, kdim, n), noisy, how in cases:
        args, nz, noise_kw = _operands(rs, t, m, kdim, n, noisy, dev)
        stream_kw, rc = _streams(rs, m, how, dev)
        kw = dict(k=12, drive_gain=0.25, **noise_kw)
        before = fused_macro.fused_macro_seq.launches
        got = ops.fused_macro_seq(*args, nz, device=dev, **stream_kw, **kw)
        torch.cuda.synchronize()
        if fused_macro.fused_macro_seq.launches != before + 1:
            raise AssertionError("ops.fused_macro_seq did not launch the "
                                 "kernel once")
        mac_w, v_w, spk_w, mask_w, st_w = ref.fused_macro_seq_ref(
            *args, nz, row_ctl=rc, **kw)
        st_w = st_w[..., 0]
        mac_g, v_g, spk_g, mask_g, st_g = got
        ulps = (v_g.view(torch.int32).long()
                - v_w.view(torch.int32).long()).abs().max().item()
        err = (v_g - v_w).abs().max().item()
        worst = max(worst, err)
        mism = int((mask_g != mask_w).sum() + (spk_g != spk_w).sum())
        total_mismatch += mism
        n_el = mask_w.numel()
        tag = (f"T={t} M={m} K={kdim} N={n} "
               f"{'noisy' if noisy else 'clean'} {how}")
        log(f"compare {tag}: mask/spike mismatches {mism} of {2 * n_el}, "
            f"steps equal {bool(torch.equal(st_g, st_w))}, mac equal "
            f"{bool(torch.equal(mac_g, mac_w))}, membrane max |err| "
            f"{err:.3g} ({ulps} ulp)")
        if not torch.equal(mac_g, mac_w):
            raise AssertionError(f"{tag}: MAC differs")
        if not noisy:
            if mism or not torch.equal(st_g, st_w) or ulps > 1:
                raise AssertionError(f"{tag}: kernel != plain version")
        else:
            if mism > 1e-3 * 2 * n_el:
                raise AssertionError(f"{tag}: {mism} noisy mismatches")
            if torch.equal(mask_g, mask_w) and (
                    not torch.equal(spk_g, spk_w) or ulps > 1):
                raise AssertionError(f"{tag}: same winners, other LIF")
    return {"max_abs_err": worst, "mismatches": total_mismatch,
            "cases": len(cases)}


# --- phase 4: the main path ------------------------------------------------

def _traffic(n_req: int, seed: int) -> list[np.ndarray]:
    """``n_req`` ternary event streams of 8-32 steps, at event densities
    0.02, 0.05 and 0.2 in turn."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n_req):
        t = int(rs.randint(8, 33))
        d = (0.02, 0.05, 0.2)[i % 3]
        u = rs.random_sample((t, CFG.n_in))
        out.append((u > 1 - d / 2).astype(np.float32) - (u < d / 2))
    return out


def _serve(params, traffic, noise, preempt: bool, dev, tracer=None,
           cfg=CFG):
    """Serve ``traffic`` through the engine, every launch counter set to 0
    just before and read just after; the path's kernel must have launched
    once per round and no other kernel at all."""
    eng = engine_lib.SNNEventEngine(cfg, params, batch_slots=SLOTS,
                                    seed=SEED, noise=noise,
                                    round_steps=ROUND, device=dev,
                                    tracer=tracer)
    reqs = [eng.submit(engine_lib.EventRequest(uid=i, events=ev))
            for i, ev in enumerate(traffic)]
    done = {"preempted": None}

    def hook(e):
        if done["preempted"] is not None:
            return
        for slot, r in enumerate(e._slot_req):
            at = int(e._slot_done[slot]) + 3
            if r is not None and at % ROUND and at < int(e._slot_len[slot]):
                e.preempt_request(r.uid, at_step=at)
                done["preempted"] = (r.uid, at)
                return

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.run(round_hook=hook if preempt else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts.pop(PATH_KERNEL[cfg.mode])
    rounds = eng.metrics.value("rounds_total")
    if launches != rounds or launches == 0:
        raise AssertionError(f"kernel launches {launches} != rounds {rounds}")
    if any(counts.values()):
        raise AssertionError(f"other kernels launched: {counts}")
    if len(out) != len(reqs) or any(r.state != lifecycle.COMPLETED
                                    for r in reqs):
        raise AssertionError("not every request completed")
    for state, ledger in (("completed", eng.completed),
                          ("rejected", eng.rejected),
                          ("expired", eng.expired)):
        if eng.metrics.value("terminal_total", state=state) != len(ledger):
            raise AssertionError(f"terminal_total{{{state}}} != ledger")
    if preempt and done["preempted"] is None:
        raise AssertionError("no preemption was forced")
    return eng, reqs, wall, launches, done["preempted"]


def _check_one_shot(params, reqs, noise, dev, cfg=CFG) -> None:
    for r in reqs:
        logits, tele = snn.forward_silicon(params, r.events[None], cfg,
                                           seed=r.seed if noise else 0,
                                           noise=noise, device=dev)
        if not torch.equal(logits[0].cpu(), r.logits):
            raise AssertionError(f"request {r.uid}: logits differ")
        for key, got in (("adc_steps", r.adc_steps), ("sops", r.sops)):
            if float(tele[key][0]) != got:
                raise AssertionError(f"request {r.uid}: {key} differs")
        if not 0.0 <= r.skipped_block_ratio <= 1.0:
            raise AssertionError(f"request {r.uid}: skip ratio out of range")
        if not np.isfinite(r.logits.numpy()).all():
            raise AssertionError(f"request {r.uid}: non-finite logits")


def main_path_phase(dev) -> tuple[dict, dict]:
    gen = torch.Generator().manual_seed(SEED)
    params = snn.init_params(CFG, gen, device=dev)
    traffic = _traffic(96, SEED + 1)
    _serve(params, traffic[:8], None, False, dev)   # warm-up: library init
    res = {}
    for label, noise, preempt in (("clean", None, False),
                                  ("noisy", ima_lib.IMANoiseModel(), True)):
        eng, reqs, wall, launches, pre = _serve(params, traffic, noise,
                                                preempt, dev)
        _check_one_shot(params, reqs, noise, dev)
        rep = eng.energy_report("dvs_gesture")
        res[label] = {"requests": len(reqs), "wall_s": wall,
                      "requests_per_s": len(reqs) / wall,
                      "launches": launches,
                      "round_ms_p50": rep["round_ms_p50"],
                      "round_ms_p95": rep["round_ms_p95"],
                      "preempted": pre,
                      "mean_adc_steps": rep["mean_adc_steps"]}
        log(f"main path {label}: {len(reqs)} requests equal one-shot "
            f"batch-1 bit for bit; {launches} kernel launches == rounds; "
            f"{len(reqs) / wall:.1f} req/s; round ms p50 "
            f"{rep['round_ms_p50']:.3f} p95 {rep['round_ms_p95']:.3f}; "
            f"preempted {pre}")
    return params, res


# --- phase 3 (NLD and the stack): kernels against their plain versions -----

def _nld_weights(n_in, n, n_branches, activation, seed, dev):
    dp = dendrite_lib.dendrite_init(torch.Generator().manual_seed(seed),
                                    n_in, n, n_branches, device=dev)
    mcfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=4.0,
                                    ima_noise=ima_lib.IMANoiseModel())
    return macro_lib.pack_nld_weights(dp, mcfg, activation), mcfg


def _events(rs, t, m, kdim, dev, density=0.05):
    x = rs.choice([-1.0, 0.0, 1.0], p=[density / 2, 1 - density,
                                       density / 2],
                  size=(t, m, kdim)).astype(np.float32)
    x[::2, :, :256] = 0.0      # a quiet K tile on even steps: gated blocks
    return torch.from_numpy(x).to(dev)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max().item())


def compare_nld_phase(dev) -> dict:
    """``ops.fused_macro_seq(mode="nld")`` on the card (padding per branch,
    the activity map, ``row_ctl`` or the scalar seed) against the plain
    version ``ref.fused_macro_seq_nld_ref`` on the same unpadded card
    tensors.  Exact: outputs equal, membrane 0 ULP."""
    rs = np.random.RandomState(SEED + 4)
    worst, total_mismatch, n_cases = 0.0, 0, 0
    for t, m, kdim, n, n_branches, activation in (
            (ROUND, SLOTS, NLD_CFG.n_in, NLD_CFG.n_hidden, 2, "relu"),
            (NLD_CFG.n_steps, SLOTS, NLD_CFG.n_in, NLD_CFG.n_hidden, 2,
             "relu"),
            (32, 37, 300, 50, 3, "sigmoid4")):
        fw, mcfg = _nld_weights(kdim, n, n_branches, activation,
                                SEED + n_cases, dev)
        x = _events(rs, t, m, kdim, dev, density=0.1)
        v0 = torch.from_numpy(rs.uniform(-1, 1, (m, n))
                              .astype(np.float32)).to(dev)
        for noisy, how in ((False, "row_ctl"), (True, "row_ctl"),
                           (True, "scalar")):
            stream_kw, rc = _streams(rs, m, how, dev)
            kw = dict(drive_gain=NLD_CFG.drive_gain, beta=NLD_CFG.beta,
                      v_th1=NLD_CFG.v_th1, v_lim=8.0,
                      ima_noise=macro_lib.fused_kernel_noise(fw, mcfg)
                      if noisy else None)
            before = fused_macro.fused_macro_seq_nld.launches
            got = ops.fused_macro_seq(x, fw.msb, fw.lsb, fw.boundaries,
                                      fw.levels, fw.scale, v0, None,
                                      fw.w_dend, mode="nld", device=dev,
                                      **stream_kw, **kw)
            torch.cuda.synchronize()
            if fused_macro.fused_macro_seq_nld.launches != before + 1:
                raise AssertionError("the NLD wrapper did not launch the "
                                     "kernel once")
            want = ref.fused_macro_seq_nld_ref(
                x, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale,
                fw.w_dend, v0, row_ctl=rc, **kw)
            mac_g, v_g, spk_g, mask_g, st_g = got
            mac_w, v_w, spk_w, mask_w, st_w = want
            mism = int((spk_g != spk_w).sum() + (mask_g != mask_w).sum())
            ulps = _ulps(v_g, v_w)
            worst = max(worst, (v_g - v_w).abs().max().item())
            total_mismatch += mism
            n_cases += 1
            tag = (f"NLD T={t} M={m} K={kdim} J={n_branches} N={n} "
                   f"{activation} {'noisy' if noisy else 'clean'} {how}")
            log(f"compare {tag}: spike/mask mismatches {mism} of "
                f"{2 * spk_w.numel()}, steps equal "
                f"{bool(torch.equal(st_g, st_w[..., 0]))}, mac equal "
                f"{bool(torch.equal(mac_g, mac_w))}, membrane {ulps} ulp, "
                f"{int(spk_w.sum())} spikes")
            if mism or ulps or not torch.equal(mac_g, mac_w) \
                    or not torch.equal(st_g, st_w[..., 0]) \
                    or not spk_w.sum():
                raise AssertionError(f"{tag}: kernel != plain version")
    return {"max_abs_err": worst, "mismatches": total_mismatch,
            "cases": n_cases}


def _stack_weights(rs, kdim, widths, dev):
    mcfg = macro_lib.CIMMacroConfig(code_bits=5, mac_range=24.0,
                                    ima_noise=ima_lib.IMANoiseModel())
    fan_ins = (kdim,) + tuple(widths[:-1])
    stack = macro_lib.pack_kwn_stack(
        [torch.from_numpy(rs.randint(-3, 4, (a, b))).float().to(dev)
         for a, b in zip(fan_ins, widths)],
        [torch.from_numpy(rs.uniform(0.01, 0.1, b).astype(np.float32))
         .to(dev) for b in widths], mcfg)
    return stack, mcfg


def _stack_call(rs, t, m, kdim, widths, ks, noisy, dev):
    """The padded operands and keywords of one stacked launch (PRBS SNL
    noise clean, per-layer counter seeds noisy)."""
    stack, mcfg = _stack_weights(rs, kdim, widths, dev)
    x = _events(rs, t, m, kdim, dev)
    vs = [torch.from_numpy(rs.uniform(-1, 1, (m, w)).astype(np.float32))
          .to(dev) for w in widths]
    nz = None
    if not noisy:
        nz = [snn._prbs_noise(m, t, w, 0.05, dev) for w in widths]
    seeds = [int(s) for s in rs.randint(0, 2 ** 31 - 1, len(widths))]
    xm, planes, vs_p, nz_p, act, ctl, specs, plan0 = ops.stack_operands(
        x, [(fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale)
            for fw in stack], vs, nz, ks=ks, seeds=seeds,
        step_offset=int(rs.randint(0, 50)), device=dev)
    kw = dict(specs=specs, drive_gain=STACK_CFG.drive_gain,
              beta=STACK_CFG.beta, v_th1=STACK_CFG.v_th1,
              v_th2=STACK_CFG.v_th2, v_lim=8.0, bm=plan0.bm,
              ima_noise=macro_lib.fused_kernel_noise(stack[0], mcfg)
              if noisy else None, snl_amp=0.05 if noisy else 0.0)
    return (xm, planes, vs_p, nz_p, act, ctl), kw


def compare_stack_phase(dev) -> dict:
    """The stacked kernel's wrapper against the plain version
    ``ref.fused_macro_multi_seq_ref`` on the same padded card operands.
    Exact: every output equal, membranes 0 ULP."""
    rs = np.random.RandomState(SEED + 5)
    worst, total_mismatch, n_cases = 0.0, 0, 0
    for t, m, kdim, widths, ks in (
            (STACK_CFG.n_steps, STACK_BATCH, STACK_CFG.n_in,
             STACK_CFG.hidden_layers, STACK_CFG.k_layers),
            (32, 37, 300, (40, 200, 20), (4, 12, 3))):
        for noisy in (False, True):
            args, kw = _stack_call(rs, t, m, kdim, widths, ks, noisy, dev)
            before = fused_macro.fused_macro_multi_seq.launches
            got = fused_macro.fused_macro_multi_seq(*args, **kw)
            torch.cuda.synchronize()
            if fused_macro.fused_macro_multi_seq.launches != before + 1:
                raise AssertionError("the stacked wrapper did not launch "
                                     "the kernel once")
            want = ref.fused_macro_multi_seq_ref(*args, **kw)
            v_g, spk_g, mask_g, st_g, cnt_g, occ_g = got
            v_w, spk_w, mask_w, st_w, cnt_w, occ_w = want
            mism = int((spk_g != spk_w).sum() + (mask_g != mask_w).sum())
            ulps = max(_ulps(a, b) for a, b in zip(v_g, v_w))
            worst = max([worst] + [(a - b).abs().max().item()
                                   for a, b in zip(v_g, v_w)])
            total_mismatch += mism
            n_cases += 1
            same = {name: bool(torch.equal(a, b)) for name, a, b in (
                ("steps", st_g, st_w), ("counts", cnt_g, cnt_w),
                ("occupancy", occ_g, occ_w))}
            tag = (f"stack T={t} M={m} K={kdim} widths={widths} "
                   f"{'noisy' if noisy else 'clean'}")
            log(f"compare {tag}: spike/mask mismatches {mism} of "
                f"{2 * spk_w.numel()}, {same}, membranes {ulps} ulp, "
                f"hidden spikes {int(cnt_w[:-1].sum())}, occupied K tiles "
                f"{int(occ_w.sum())}")
            if mism or ulps or not all(same.values()) \
                    or not cnt_w[:-1].sum():
                raise AssertionError(f"{tag}: kernel != plain version")
    return {"max_abs_err": worst, "mismatches": total_mismatch,
            "cases": n_cases}


# --- phase 4 (NLD and the stack): the main paths ----------------------------

def _round_quantiles(eng) -> tuple[float, float]:
    rs = sorted(eng._round_samples)
    return rs[len(rs) // 2], rs[min(len(rs) - 1, int(len(rs) * 0.95))]


def nld_path_phase(dev) -> tuple[dict, dict]:
    """96 NLD requests served clean and noisy (one forced preemption off a
    round boundary), each equal to its one-shot batch-1 run."""
    params = snn.init_params(NLD_CFG, torch.Generator().manual_seed(SEED),
                             device=dev)
    traffic = _traffic(96, SEED + 6)
    _serve(params, traffic[:8], None, False, dev, cfg=NLD_CFG)   # warm-up
    res = {}
    for label, noise, preempt in (("clean", None, True),
                                  ("noisy", ima_lib.IMANoiseModel(), True)):
        eng, reqs, wall, launches, pre = _serve(params, traffic, noise,
                                                preempt, dev, cfg=NLD_CFG)
        _check_one_shot(params, reqs, noise, dev, cfg=NLD_CFG)
        if eng.energy_report("dvs_gesture") != {}:
            raise AssertionError("NLD energy_report must be empty")
        if any(r.adc_steps != 2 ** NLD_CFG.code_bits - 1 for r in reqs):
            raise AssertionError("NLD requests must run the full ramp")
        p50, p95 = _round_quantiles(eng)
        res[label] = {"requests": len(reqs), "wall_s": wall,
                      "requests_per_s": len(reqs) / wall,
                      "launches": launches, "round_ms_p50": p50,
                      "round_ms_p95": p95, "preempted": pre}
        log(f"NLD path {label}: {len(reqs)} requests equal one-shot "
            f"batch-1 bit for bit; {launches} NLD kernel launches == "
            f"rounds; {len(reqs) / wall:.1f} req/s; preempted {pre}")
    return params, res


def stack_path_phase(dev) -> tuple[dict, dict]:
    """``forward_silicon`` on the DVS-Gesture stack on the card, clean and
    noisy, against the same call on the CPU (the plain version)."""
    params = snn.init_params(STACK_CFG, torch.Generator().manual_seed(SEED),
                             device=dev)
    rs = np.random.RandomState(SEED + 7)
    u = rs.random_sample((STACK_BATCH, STACK_CFG.n_steps, STACK_CFG.n_in))
    ev = (u > 0.975).astype(np.float32) - (u < 0.025)
    res = {}
    for label, noise in (("clean", None), ("noisy", ima_lib.IMANoiseModel())):
        torch.cuda.synchronize()
        reset_counts()
        logits, tele = snn.forward_silicon(params, ev, STACK_CFG, seed=SEED,
                                           noise=noise, device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = counts.pop("fused_macro_multi_seq_kwn")
        if launches != 1 or any(counts.values()):
            raise AssertionError(f"stack path launches: {launches}, "
                                 f"others {counts}")
        cpu_params = snn.params_to(params, "cpu")
        lc, tc = snn.forward_silicon(cpu_params, ev, STACK_CFG, seed=SEED,
                                     noise=noise, device="cpu")
        for key in ("adc_steps", "lif_updates", "sops",
                    "skipped_block_ratio"):
            if not torch.equal(tele[key].cpu(), tc[key]):
                raise AssertionError(f"stack {label}: {key} differs")
        err = (logits.cpu() - lc).abs().max().item()
        if err > 1e-5 * max(1.0, lc.abs().max().item()) \
                or not torch.isfinite(logits).all() \
                or tuple(logits.shape) != (STACK_BATCH, STACK_CFG.n_classes):
            raise AssertionError(f"stack {label}: logits differ by {err}")
        res[label] = {"launches": launches, "logits_max_abs_err": err,
                      "skipped_block_ratio":
                      float(tele["skipped_block_ratio"][0]),
                      "mean_adc_steps": float(tele["adc_steps"].mean())}
        log(f"stack path {label}: {STACK_BATCH} streams x "
            f"{STACK_CFG.n_steps} steps, one launch; telemetry equal to "
            f"the CPU, logits within {err:.3g}; skipped block ratio "
            f"{res[label]['skipped_block_ratio']:.4f}")
    return params, res


# --- phase 5: kernel timing at the serving shape ---------------------------

def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timing_phase(dev) -> dict:
    """The kernel's wrapper against the plain version at the serving round
    shape, which needs no padding."""
    rs = np.random.RandomState(SEED + 2)
    t, m, kdim, n = ROUND, SLOTS, CFG.n_in, CFG.n_hidden
    args, nz, _ = _operands(rs, t, m, kdim, n, False, dev)
    _, rc = _streams(rs, m, "row_ctl", dev)
    x = args[0].to(torch.int8)
    plan = fused_macro.plan_tiles(m, kdim, n, n, t)
    if (plan.m_pad, plan.k_pad, plan.n_pad) != (m, kdim, n):
        raise AssertionError(f"serving shape is padded: {plan}")
    act = ops.fused_activity_map(x, plan)
    kw = dict(k=12, drive_gain=0.25, mac_telemetry=False)
    launch = lambda: fused_macro.fused_macro_seq(
        x, *args[1:], nz, act, rc, bm=plan.bm, bk=plan.bk, **kw)
    plain = lambda: ref.fused_macro_seq_ref(x, *args[1:], nz, row_ctl=rc,
                                            **kw)
    kernel_ms = [_time_ms(launch, 200) for _ in range(2)]
    plain_ms = [_time_ms(plain, 5) for _ in range(2)]
    kernel_ms += [_time_ms(launch, 200)]
    # the least the card could take: each operand read once, each output
    # written once; the MAC the data needs (2 ops per active input and
    # column) plus the ramp compares
    n_codes = args[4].shape[0]
    in_bytes = (x.numel() + 2 * kdim * n + 4 * (2 * n_codes - 1 + n)
                + 4 * m * n + 4 * t * m * n + 4 * act.numel() + 4 * rc.numel())
    out_bytes = 4 * m * n + 2 * 4 * t * m * n + 4 * t * m
    ops_count = 2 * int((x != 0).sum()) * n + t * m * n * (n_codes - 1)
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = ops_count / F32_FLOPS
    bound_ms = 1e3 * max(bytes_s, ops_s)
    res = {"kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_s >= ops_s else "operations",
           "bytes": in_bytes + out_bytes, "ops": ops_count,
           "shape": {"R": t, "S": m, "K": kdim, "N": n}}
    log(f"timing R={t} S={m} K={kdim} N={n}: kernel {res['kernel_ms']:.4f} "
        f"ms/round, plain {res['plain_ms']:.3f} ms/round, bound "
        f"{bound_ms * 1e3:.3f} us ({res['bound_by']})")
    return res


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least ms the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    bytes_s, ops_s = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                        else "operations")


def nld_timing_phase(dev) -> dict:
    """The NLD kernel's wrapper against its plain version at the serving
    round shape (R=8, S=64, K=512, J=2 x 128 columns: no padding)."""
    rs = np.random.RandomState(SEED + 9)
    t, m, kdim, n, nb = ROUND, SLOTS, NLD_CFG.n_in, NLD_CFG.n_hidden, 2
    fw, _ = _nld_weights(kdim, n, nb, NLD_CFG.activation, SEED, dev)
    x = _events(rs, t, m, kdim, dev).to(torch.int8)
    v0 = torch.from_numpy(rs.uniform(-1, 1, (m, n)).astype(np.float32)) \
        .to(dev)
    _, rc = _streams(rs, m, "row_ctl", dev)
    plan = fused_macro.plan_tiles(m, kdim, nb * n, n, t, mode="nld",
                                  n_branches=nb)
    if (plan.m_pad, plan.k_pad, plan.n_pad) != (m, kdim, n):
        raise AssertionError(f"serving shape is padded: {plan}")
    act = ops.fused_activity_map(x, plan)
    kw = dict(drive_gain=NLD_CFG.drive_gain, beta=NLD_CFG.beta,
              v_th1=NLD_CFG.v_th1, v_lim=8.0, mac_telemetry=False)
    operands = (x, fw.msb, fw.lsb, fw.boundaries, fw.levels, fw.scale,
                fw.w_dend, v0)
    launch = lambda: fused_macro.fused_macro_seq_nld(
        *operands, act, rc, bm=plan.bm, bk=plan.bk, **kw)
    plain = lambda: ref.fused_macro_seq_nld_ref(*operands, row_ctl=rc, **kw)
    kernel_ms = [_time_ms(launch, 200) for _ in range(3)]
    plain_ms = [_time_ms(plain, 5) for _ in range(2)]
    nc, n_codes = nb * n, fw.levels.shape[0]
    in_bytes = (x.numel() + 2 * kdim * nc
                + 4 * (2 * n_codes - 1 + nc + nb * n) + 4 * m * n
                + 4 * act.numel() + 4 * rc.numel())
    out_bytes = 4 * m * n + 2 * 4 * t * m * n + 4 * t * m
    # the MAC the events need, the ramp compares, the scale and soma
    n_ops = (2 * int((x != 0).sum()) * nc + t * m * nc * (n_codes - 1)
             + 2 * t * m * nc)
    bound_ms, bound_by = _bound(in_bytes + out_bytes, n_ops)
    res = {"kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": in_bytes + out_bytes, "ops": n_ops,
           "shape": {"R": t, "S": m, "K": kdim, "J": nb, "N": n}}
    log(f"NLD timing R={t} S={m} K={kdim} J={nb} N={n}: kernel "
        f"{res['kernel_ms']:.4f} ms/round, plain {res['plain_ms']:.3f} "
        f"ms/round, bound {bound_ms * 1e3:.3f} us ({bound_by})")
    return res


def stack_timing_phase(dev) -> dict:
    """The stacked kernel's wrapper (the launch and the occupancy
    reduction) against its plain version at the stack path's shape: 64
    streams of 30 steps through two 128-column layers, clean."""
    rs = np.random.RandomState(SEED + 10)
    t, m, kdim = STACK_CFG.n_steps, STACK_BATCH, STACK_CFG.n_in
    widths = STACK_CFG.hidden_layers
    args, kw = _stack_call(rs, t, m, kdim, widths, STACK_CFG.k_layers,
                           False, dev)
    launch = lambda: fused_macro.fused_macro_multi_seq(*args, **kw)
    plain = lambda: ref.fused_macro_multi_seq_ref(*args, **kw)
    kernel_ms = [_time_ms(launch, 50) for _ in range(3)]
    plain_ms = [_time_ms(plain, 2) for _ in range(2)]
    x, planes, vs, noises, act, ctl = args
    counts = launch()[4]
    n_codes, n_i = planes[0][3].shape[0], m // kw["bm"]
    cols, n_layers = sum(widths), len(widths)
    in_bytes = (x.numel() + sum(2 * p[0].numel() for p in planes)
                + 4 * (2 * n_codes - 1 + cols) + 4 * m * cols
                + 4 * t * m * cols + 4 * act.numel() + 4 * ctl.numel())
    out_bytes = (4 * m * cols + 2 * 4 * t * m * widths[-1]
                 + 2 * 4 * n_layers * t * m + 4 * n_layers * t * n_i)
    n_ops = 2 * int((x != 0).sum()) * widths[0] \
        + t * m * cols * (n_codes - 1)
    for li in range(1, n_layers):
        n_ops += 2 * int(counts[li - 1].sum().item()) * widths[li]
    bound_ms, bound_by = _bound(in_bytes + out_bytes, n_ops)
    res = {"kernel_ms": min(kernel_ms), "kernel_ms_all": kernel_ms,
           "plain_ms": min(plain_ms), "plain_ms_all": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": in_bytes + out_bytes, "ops": n_ops,
           "shape": {"T": t, "M": m, "K": kdim, "widths": list(widths)}}
    log(f"stack timing T={t} M={m} K={kdim} widths={widths}: kernel "
        f"{res['kernel_ms']:.4f} ms/launch, plain {res['plain_ms']:.3f} "
        f"ms/launch, bound {bound_ms * 1e3:.3f} us ({bound_by})")
    return res


def nld_serving_phase(params, dev) -> dict:
    """NLD serving speed over a 2048-request clean burst: requests/s and
    the whole scheduling tick (admission included), beside round ms."""
    traffic = _traffic(NLD_BURST, SEED + 8)
    eng, reqs, wall, launches, _ = _serve(params, traffic, None, False, dev,
                                          cfg=NLD_CFG)
    if launches > engine_lib.ROUND_MS_SAMPLE_WINDOW:
        raise AssertionError(f"{launches} rounds overflow the engine's "
                             f"round-time window")
    p50, p95 = _round_quantiles(eng)
    res = {"requests": len(reqs), "rounds": launches, "wall_s": wall,
           "requests_per_s": len(reqs) / wall,
           "tick_ms_mean": 1e3 * wall / launches,
           "round_ms_p50": p50, "round_ms_p95": p95}
    log(f"NLD serving burst: {len(reqs)} requests in {launches} rounds, "
        f"{res['requests_per_s']:.1f} req/s, whole tick "
        f"{res['tick_ms_mean']:.3f} ms, round ms p50 {p50:.3f} p95 "
        f"{p95:.3f}")
    return res


def _device_us(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def serving_phase(params, dev) -> dict:
    """Serving speed over one long clean burst (several hundred rounds, so
    that p95 is a tail), then a breakdown of a shorter burst under the
    engine's tracer and ``torch.profiler``: host ms per scheduler span,
    the host ops that take most self time, and device busy time."""
    from torch.profiler import ProfilerActivity, profile

    traffic = _traffic(BURST, SEED + 3)
    eng, reqs, wall, launches, _ = _serve(params, traffic, None, False, dev)
    if launches > engine_lib.ROUND_MS_SAMPLE_WINDOW:
        raise AssertionError(f"{launches} rounds overflow the engine's "
                             f"round-time window")
    rep = eng.energy_report("dvs_gesture")
    burst = {"requests": len(reqs), "rounds": launches, "wall_s": wall,
             "requests_per_s": len(reqs) / wall,
             "round_ms_mean": 1e3 * wall / launches,
             "round_ms_p50": rep["round_ms_p50"],
             "round_ms_p95": rep["round_ms_p95"]}
    log(f"serving burst: {len(reqs)} requests in {launches} rounds, "
        f"{burst['requests_per_s']:.1f} req/s, round ms p50 "
        f"{burst['round_ms_p50']:.3f} p95 {burst['round_ms_p95']:.3f}")

    # spans without the profiler (its overhead would swell them), then the
    # same burst under the profiler for the op table and device busy time
    tracer = obs_trace.Tracer()
    _, reqs, wall, launches, _ = _serve(params, traffic[:PROFILED], None,
                                        False, dev, tracer=tracer)
    spans: dict[str, float] = {}
    for name, track, _, dur_ns, _ in tracer.spans():
        if track == "scheduler":
            spans[name] = spans.get(name, 0.0) + dur_ns / 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall_prof, _, _ = _serve(params, traffic[:PROFILED], None,
                                       False, dev)
    table = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in table if e.device_type == cuda]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    host = sorted((e for e in table if e.device_type != cuda),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    breakdown = {
        "requests": len(reqs), "rounds": launches, "wall_ms": 1e3 * wall,
        "wall_ms_profiled": 1e3 * wall_prof,
        "span_ms_per_round": {k: v / launches for k, v in spans.items()},
        "device_busy_ms": busy_ms,
        # busy time under the profiler over the wall time without it
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
        "top_device": [(e.key, e.count, _device_us(e) / 1e3) for e in sorted(
            kernels, key=_device_us, reverse=True)[:8]],
        "top_host_self_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                             for e in host[:12]]}
    (ROOT / "chiprun_out" / "chip_smoke_profile.txt").write_text(
        table.table(sort_by="self_cpu_time_total", row_limit=40))
    log(f"breakdown burst: {len(reqs)} requests, {launches} rounds, "
        f"{1e3 * wall:.1f} ms wall ({1e3 * wall_prof:.1f} ms under the "
        f"profiler), device busy {busy_ms:.2f} ms (idle share "
        f"{breakdown['device_idle_share']:.3f})")
    log("  host ms per round by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in breakdown["span_ms_per_round"].items()))
    for key, count, ms in breakdown["top_host_self_ms"][:6]:
        log(f"  host self {ms:.2f} ms in {count} calls: {key}")
    for key, count, ms in breakdown["top_device"][:4]:
        log(f"  device {ms:.3f} ms in {count} launches: {key[:80]}")
    return {"burst": burst, "breakdown": breakdown}


def _record(name, replaces, launches, cmp, timing) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": cmp["max_abs_err"], "ms": timing["kernel_ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": None,
            "mismatches": cmp["mismatches"]}


def main() -> None:
    t0 = time.perf_counter()
    kind, smi = device_phase()
    dev = torch.device("cuda")
    build_s = build_phase()
    cmp = {"kwn": compare_phase(dev), "nld": compare_nld_phase(dev),
           "stack": compare_stack_phase(dev)}
    log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
    params, main_res = main_path_phase(dev)
    nld_params, nld_res = nld_path_phase(dev)
    _, stack_res = stack_path_phase(dev)
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    timing = {"kwn": timing_phase(dev), "nld": nld_timing_phase(dev),
              "stack": stack_timing_phase(dev)}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    serving = serving_phase(params, dev)
    nld_serving = nld_serving_phase(nld_params, dev)
    log(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    b = serving["burst"]
    log(f"[{smi}] engine, {b['requests']}-request clean burst: "
        f"{b['requests_per_s']:.1f} req/s, round ms p50 "
        f"{b['round_ms_p50']:.3f} p95 {b['round_ms_p95']:.3f} over "
        f"{b['rounds']} rounds")
    log(f"[{smi}] NLD engine, {nld_serving['requests']}-request clean "
        f"burst: {nld_serving['requests_per_s']:.1f} req/s, whole tick "
        f"{nld_serving['tick_ms_mean']:.3f} ms over "
        f"{nld_serving['rounds']} rounds")
    for name, key, unit in (("fused_macro_seq_kwn", "kwn", "round"),
                            ("fused_macro_seq_nld", "nld", "round"),
                            ("fused_macro_multi_seq_kwn", "stack",
                             "launch")):
        tm = timing[key]
        log(f"[{smi}] {name}: {tm['kernel_ms']:.4f} ms/{unit}, plain "
            f"{tm['plain_ms']:.3f} ms/{unit}, bound "
            f"{tm['bound_ms'] * 1e3:.3f} us ({tm['bound_by']})")
    path = "src/repro/kernels/fused_macro.py"
    record = {"kernels": [
        _record("fused_macro_seq_kwn", f"{path}:524",
                main_res["clean"]["launches"] + main_res["noisy"]["launches"],
                cmp["kwn"], timing["kwn"]),
        _record("fused_macro_seq_nld", f"{path}:583",
                nld_res["clean"]["launches"] + nld_res["noisy"]["launches"],
                cmp["nld"], timing["nld"]),
        _record("fused_macro_multi_seq_kwn", f"{path}:896",
                stack_res["clean"]["launches"]
                + stack_res["noisy"]["launches"],
                cmp["stack"], timing["stack"])]}
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(
        {"device": smi, "build_s": build_s, "compare": cmp,
         "main_path": {"kwn": main_res, "nld": nld_res, "stack": stack_res},
         "timing": timing, "serving": serving, "nld_serving": nld_serving,
         "seconds": time.perf_counter() - t0}, indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
